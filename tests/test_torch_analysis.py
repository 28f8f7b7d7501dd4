"""The port's static analysis: the kernel contract checker over the work
lists, the semiring-law verifier and the cross-check of the CUDA semiring
table (from the source of ``semiring.cuh``), and the AST lint pass; the
counterparts of the JAX package's ``tests/test_analysis.py``.

The contracts hold every registered case, real layouts of four generator
families at five (C, L) and their (2, 2) shards; each mutated work list is
reported. The laws hold every registered semiring; a broken
pseudo-semiring, an unhandled code and a drifted table, each given as
edited text of ``semiring.cuh``, are caught. The lint's bad examples are
strings written to ``tmp_path``."""
import pathlib

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro_torch.analysis import contracts, laws, lint
from repro_torch.analysis.registry import REGISTRY, demo_layouts
from repro_torch.core import engine as eng
from repro_torch.core import options
from repro_torch.core import semiring as sm
from repro_torch.core.bfs import bfs, bfs_spec
from repro_torch.core.cc import CC_SEMIRINGS, cc
from repro_torch.core.dist_bfs import partition_slimsell, shard
from repro_torch.core.formats import build_slimsell
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

REPO = pathlib.Path(__file__).resolve().parents[1]

FAMILIES = {"kron": lambda: pg.kronecker(7, 6, seed=1),
            "er": lambda: pg.erdos_renyi(150, 3.0, seed=2),
            "star": lambda: pg.star(40),
            "two": lambda: pg.two_components(6, 6, seed=4)}
SHAPES = [(8, 32), (4, 8), (3, 5), (1, 1), (16, 128)]


# ------------------------------------------------------- contract checker


def test_all_registered_contracts_pass():
    assert sorted(REGISTRY) == ["embedding_bag", "embedding_bag_grouped",
                                "pull", "pull_mm", "spmm", "spmm_packed",
                                "spmv", "spmv_packed"]
    assert contracts.check_all() == []
    assert contracts.main(["-q"]) == 0


def test_demo_layouts_hold_the_structures_the_contracts_need():
    lay = demo_layouts()
    whole, sh, empty = lay["whole"], lay["shard"], lay["empty block"]
    pieces, folds, slots = ops.spmm_work(whole.tile_ptr, whole.cl, whole.L, 2)
    n_pieces = np.bincount(pieces[:, 0].numpy(), minlength=whole.n_chunks)
    assert (n_pieces > 1).sum() == 2 and folds.shape[0] == 2
    assert (whole.cl == 0).any() and (whole.cl % whole.L != 0).any()
    tiles = (whole.tile_ptr[1:] - whole.tile_ptr[:-1]) * whole.L
    assert (tiles - whole.cl >= whole.L).any()          # padding past cl
    assert int(sh.tile_ptr[-1]) * sh.L > int(sh.cl[-1]) + sh.L
    assert not sh.owns_all_rows and (empty.cl == 0).all()


def _whole_case(per_piece=2):
    lay = demo_layouts()["whole"]
    return lay, [t.clone() for t in ops.spmm_work(lay.tile_ptr, lay.cl,
                                                  lay.L, per_piece)[:2]]


def _errs(lay, pieces, folds, slots=5, per_piece=2):
    return contracts.check_pieces("bad", lay, (pieces, folds, slots),
                                  per_piece)


def test_contract_rejects_a_dropped_tile():
    lay, (pieces, folds) = _whole_case()
    pieces[1, 2] -= 1          # chunk 0's second piece stops a tile early
    errs = _errs(lay, pieces, folds)
    assert any("dropped" in e for e in errs), errs


def test_contract_rejects_overlapping_pieces():
    lay, (pieces, folds) = _whole_case()
    pieces[1, 1] -= 1          # chunk 0's second piece starts in the first
    errs = _errs(lay, pieces, folds)
    assert any("overlapping" in e for e in errs), errs


def test_contract_rejects_a_tile_id_out_of_range():
    lay, (pieces, folds) = _whole_case()
    pieces[-1, 1:3] = torch.tensor([lay.n_tiles + 3, lay.n_tiles + 4])
    errs = _errs(lay, pieces, folds)
    assert any("tile id out of range" in e for e in errs), errs


def test_contract_rejects_a_shared_partial_slot():
    lay, (pieces, folds) = _whole_case()
    pieces[1, 3] = pieces[0, 3]     # two pieces of chunk 0 write one slot
    errs = _errs(lay, pieces, folds)
    assert any("written by 2 pieces" in e for e in errs), errs


def test_contract_rejects_a_fold_in_the_wrong_order():
    lay, (pieces, folds) = _whole_case()
    s0, s1 = int(pieces[0, 3]), int(pieces[1, 3])
    pieces[0, 3], pieces[1, 3] = s1, s0      # slots swapped between pieces
    errs = _errs(lay, pieces, folds)
    assert any("out of its pieces' order" in e for e in errs), errs


def test_contract_rejects_a_duplicate_row_vertex():
    lay = demo_layouts()["whole"]
    lay.row_vertex = lay.row_vertex.clone()
    lay.row_vertex[1, 0] = lay.row_vertex[0, 0]
    errs = contracts.check_pieces("bad", lay, ops.spmm_work(
        lay.tile_ptr, lay.cl, lay.L, 2), 2)
    assert any("live rows" in e and "race" in e for e in errs), errs
    assert any("no row" in e for e in errs), errs    # the vertex it lost


def test_contract_rejects_mislabelled_spmv_items():
    lay = demo_layouts()["whole"]
    items, classes, folds, slots = ops.spmv_work(lay.tile_ptr, lay.cl,
                                                 lay.L, 2)
    bad = items.clone()
    bad[-1, 2] -= 1            # one row slot short of the chunk's length
    errs = contracts.check_items("bad", lay, (bad, classes, folds, slots), 2)
    assert any("row slots" in e for e in errs), errs
    wrong = list(classes)
    wrong[0], wrong[1] = wrong[0] - 1, wrong[1] + 1
    errs = contracts.check_items("bad", lay, (items, wrong, folds, slots), 2)
    assert any("class counts" in e for e in errs), errs


def test_contract_rejects_weights_beside_the_wrong_slots():
    lay = demo_layouts()["whole"]
    lay.wts = lay.wts[:-1]
    errs = contracts.check_pieces("bad", lay, ops.spmm_work(
        lay.tile_ptr, lay.cl, lay.L, 2), 2)
    assert any("wts shape" in e for e in errs), errs


def test_contract_rejects_a_table_pointer_past_its_table():
    tables = [torch.zeros(4, 8), torch.zeros(6, 8)]
    ptrs, rows = ops._table_args(tables, tables[0].device)
    assert contracts.check_tables("ok", tables, (ptrs, rows)) == []
    errs = contracts.check_tables("bad", tables, (ptrs, [4, 7]))
    assert any("table 1" in e for e in errs), errs


@pytest.mark.parametrize("C,L", SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_contracts_hold_on_real_layouts_and_shards(family, C, L):
    csr = FAMILIES[family]()
    tiled = build_slimsell(csr, C=C, L=L).to_torch("cpu")
    part = partition_slimsell(csr, 2, 2, C=C, L=L, device="cpu")
    layouts = [("whole", tiled)] + [
        (f"shard {i}{j}", shard(part, i, j).to_torch("cpu"))
        for i in range(2) for j in range(2)]
    for name, lay in layouts:
        for per_piece in (1, 3, ops.piece_tiles(L)):
            assert contracts.check_pieces(name, lay, ops.spmm_work(
                lay.tile_ptr, lay.cl, L, per_piece), per_piece) == []
        for per_piece in (2, ops.spmv_piece_tiles(L)):
            assert contracts.check_items(name, lay, ops.spmv_work(
                lay.tile_ptr, lay.cl, L, per_piece), per_piece) == []


def test_contracts_check_the_lists_a_layout_keeps():
    tiled = build_slimsell(pg.kronecker(7, 6, seed=1), C=8, L=8).to_torch(
        "cpu")
    assert contracts.check_layout_work("fresh", tiled) == \
        ["fresh: no work list kept (no kernel launched on it)"]
    tiled.spmm_work = (tiled.tile_ptr, tiled.cl, ops.spmm_work(
        tiled.tile_ptr, tiled.cl, 8, ops.piece_tiles(8)))
    tiled.spmv_work = (tiled.tile_ptr, tiled.cl, ops.spmv_work(
        tiled.tile_ptr, tiled.cl, 8, ops.spmv_piece_tiles(8)))
    assert contracts.check_layout_work("kept", tiled) == []
    tiled.spmv_work = (tiled.tile_ptr.clone(),) + tiled.spmv_work[1:]
    assert any("another tile_ptr" in e
               for e in contracts.check_layout_work("stale", tiled))


# ------------------------------------------------------ semiring-law verifier


def test_all_registered_semirings_satisfy_laws():
    results = laws.verify_all()
    assert set(results) == set(options.SEMIRINGS)
    for name, errs in results.items():
        assert errs == [], (name, errs)
    assert laws.verify_packed_words() == []
    assert laws.main(["-q"]) == 0


def test_kernel_table_cross_check_passes():
    assert laws.cross_check_kernel_tables() == []
    table = laws.parse_kernel_table(laws.CUH.read_text())
    assert table.enum == {name.upper(): sr.code
                          for name, sr in sm.SEMIRINGS.items()}
    assert sorted(table.dispatch) == ["BOOLEAN", "REAL", "SELMAX",
                                      "TROPICAL"]


def _edited(old, new):
    text = laws.CUH.read_text()
    assert text.count(old) == 1, old
    return text.replace(old, new)


def test_broken_pseudo_semiring_rejected():
    # subtraction is neither associative nor commutative, and 0 does not
    # annihilate a mul of +: the verifier must say so
    broken = sm.Semiring(name="broken", dtype=torch.float32, zero=0.0,
                         one=0.0, mul=torch.add, reduction="sum", code=9)
    errs = laws.verify_semiring(broken, add=lambda a, b: a - b)
    assert any("associativity" in e for e in errs)
    assert any("commutativity" in e for e in errs)
    assert any("annihilation" in e for e in errs)
    # the same add, written into the kernel table's real struct
    errs = laws.cross_check_kernel_tables(_edited(
        "static T add(T a, T b) { return a + b; }",
        "static T add(T a, T b) { return a - b; }"))
    assert any("kernel real: add associativity" in e for e in errs), errs
    assert any("kernel real: add commutativity" in e for e in errs), errs


def test_unhandled_semiring_is_hard_failure():
    errs = laws.cross_check_kernel_tables(_edited(
        "    case REAL: f.template operator()<REAL>(); break;\n", ""))
    assert any("no dispatch" in e and "'real'" in e for e in errs), errs
    errs = laws.cross_check_kernel_tables(_edited(
        "    default: return cudaErrorInvalidValue;",
        "    case MINPLUS: f.template operator()<MINPLUS>(); break;\n"
        "    default: return cudaErrorInvalidValue;"))
    assert any("dispatches 'minplus'" in e for e in errs), errs


def test_drifted_kernel_table_is_caught():
    errs = laws.cross_check_kernel_tables(_edited(
        "  __device__ static T zero() { return 0.0f; }\n"
        "  __device__ static T edge(T x) { return x; }\n"
        "  __device__ static T add(T a, T b) { return a + b; }",
        "  __device__ static T zero() { return -1.0f; }\n"
        "  __device__ static T edge(T x) { return x; }\n"
        "  __device__ static T add(T a, T b) { return a + b; }"))
    assert any("real" in e and "zero" in e for e in errs), errs
    errs = laws.cross_check_kernel_tables(_edited("REAL = 1", "REAL = 6"))
    assert any("real: kernel enum SemiringCode gives 6" in e
               for e in errs), errs
    errs = laws.cross_check_kernel_tables(_edited(
        "return x + 1.0f;", "return x + 2.0f;"))
    assert any("tropical: kernel edge" in e for e in errs), errs


# ---------------------------------------------------------------- lint pass


BAD = {
    "bad_string_option.py": '''
def sweep(x, direction="push"):
    if direction == "pull":
        return -x
    return x
''',
    "bad_f32_ids.py": '''
import torch

def relabel(labels, parent_ids):
    a = labels.float()
    b = parent_ids.to(torch.float32)
    return a, b

def mask(labels):
    return (labels > 0).float()      # a mask, not ids: fine
''',
    "bad_packed_constants.py": '''
def word(v, bits):
    w = v >> 5
    b = v & 31
    return w, b, bits ^ 0xFFFFFFFF
''',
    "kernels/bad_unregistered_launch.py": '''
from repro_torch.analysis.registry import kernel_contract

def sweep(k, x):
    k.launch(x)

@kernel_contract(lambda: [])
def registered(k, x):
    k.launch(x)
''',
}


@pytest.fixture
def bad_dir(tmp_path):
    for name, text in BAD.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return tmp_path


def _findings(bad_dir, name, allow=frozenset()):
    return lint.lint_paths([bad_dir / name], bad_dir, set(allow))


def test_lint_catches_string_option(bad_dir):
    assert [f.rule for f in _findings(bad_dir, "bad_string_option.py")] \
        == ["string-option"]


def test_lint_catches_f32_vertex_ids(bad_dir):
    assert [f.rule for f in _findings(bad_dir, "bad_f32_ids.py")] \
        == ["f32-vertex-id", "f32-vertex-id"]
    guarded = bad_dir / "guarded.py"
    guarded.write_text("# ids exact below 1 << 24\n"
                       + BAD["bad_f32_ids.py"])
    assert lint.lint_paths([guarded], bad_dir, set()) == []


def test_lint_catches_packed_constants(bad_dir):
    assert [f.rule for f in _findings(bad_dir, "bad_packed_constants.py")] \
        == ["packed-constants"] * 3


def test_packed_constants_rule_is_allowlist_free(bad_dir):
    # entries for the rule (path-level and qualname-level) change nothing:
    # the rule's only fix is routing through core.packing
    findings = _findings(bad_dir, "bad_packed_constants.py")
    keys = {k for f in findings for k in f.key_candidates()}
    assert len(_findings(bad_dir, "bad_packed_constants.py", keys)) == 3


def test_packing_module_is_exempt_from_packed_constants():
    packing_py = REPO / "src" / "repro_torch" / "core" / "packing.py"
    findings = lint.lint_paths([packing_py], REPO, set())
    assert [f for f in findings if f.rule == "packed-constants"] == []


def test_lint_catches_an_unregistered_kernel_launch(bad_dir):
    found = _findings(bad_dir, "kernels/bad_unregistered_launch.py")
    assert [(f.rule, f.qualname) for f in found] == [("kernel-contract",
                                                      "sweep")]


def test_lint_allowlist_silences_by_qualname(bad_dir):
    [finding] = _findings(bad_dir, "bad_string_option.py")
    key = f"string-option:{finding.path}::{finding.qualname}"
    assert _findings(bad_dir, "bad_string_option.py", {key}) == []


def test_lint_clean_on_repo_sources():
    allow = lint.load_allowlist(
        REPO / "src" / "repro_torch" / "analysis" / "lint_allow.txt")
    used = set()
    findings = lint.lint_paths([REPO / "src" / "repro_torch"], REPO, allow,
                               used)
    assert findings == [], [str(f) for f in findings]
    assert used == allow            # no stale entry
    assert lint.main([]) == 0


def test_every_launching_wrapper_is_registered():
    launching = {f.qualname for f in lint.lint_paths(
        [REPO / "src" / "repro_torch" / "kernels" / "ops.py"], REPO, set())}
    assert launching == set()
    assert {n for n in REGISTRY} >= {"spmv", "spmm", "pull", "pull_mm",
                                     "spmv_packed", "spmm_packed",
                                     "embedding_bag_grouped"}


def test_port_rules_are_the_jax_rules_that_apply():
    # traced-branch and interpret-literal have no counterpart (no tracing,
    # no interpret mode); pallas-contract becomes kernel-contract
    assert set(jlint.RULE_NAMES) - set(lint.RULE_NAMES) == {
        "traced-branch", "interpret-literal", "pallas-contract"}
    assert lint.NO_ALLOW_RULES == jlint.NO_ALLOW_RULES


# ------------------------------------------------------------- option home


def test_option_vocabularies_are_canonical():
    assert tuple(sm.SEMIRINGS) == options.SEMIRINGS
    assert eng.DIRECTIONS is options.DIRECTIONS
    assert CC_SEMIRINGS is options.CC_SEMIRINGS


def test_entry_points_reject_unknown_options():
    tiled = build_slimsell(pg.kronecker(6, 4, seed=0), C=8, L=16).to_torch(
        "cpu")
    with pytest.raises(KeyError):
        bfs(tiled, 0, "nope", device="cpu")
    with pytest.raises(ValueError):
        options.EngineConfig(direction="sideways")
    with pytest.raises(ValueError):
        options.EngineConfig(sanitize="yes")
    with pytest.raises(ValueError):
        cc(tiled, semiring="tropical", device="cpu")
    with pytest.raises(ValueError):
        eng.run_fused(bfs_spec("tropical"), tiled, 0, max_iters=4,
                      direction="sideways")
    with pytest.raises(ValueError):
        ops.embedding_bag(torch.zeros(4, 4), torch.zeros(8, 2,
                                                         dtype=torch.int32),
                          mode="median")
    from repro_torch.distributed import launch
    with pytest.raises(ValueError, match="backend"):
        launch(print, (1,), ("data",), backend="mpi", device="cpu")
