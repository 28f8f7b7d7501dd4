"""DLRM inference in the port against the JAX package's jnp path.

Each case hands the same seeded numpy inputs to ``repro`` on the JAX CPU
and to the port with ``device="cpu"``. Tolerances, set before any run:

* ``embedding_bag_ref`` against ``repro/kernels/ref.py::embedding_bag_ref``
  over the JAX test's sweep and the edge cases (d = 16 and 130, B = 1 and
  13, bags of only pads, random -1 pads): rtol = atol = 1e-6, the bound of
  ``tests/test_kernels.py``; at K = 1 bit-equal (one row, nothing summed).
  An id at or past V makes its bag NaN in both.
* ``mlp_apply``, ``dlrm_forward``, ``dlrm_loss``, ``dlrm_user_tower`` and
  ``retrieval_scores``: rtol = atol = 1e-5 (float32 products and sums in
  another order), on ``reduced_config()`` and a small config with
  multi_hot 3 and pads, the weights carried by ``convert``.
* ``CriteoPipeline``: bit-equal to ``repro``'s over several steps and host
  splits. The configurations equal ``repro``'s field by field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import dlrm_mlperf as jcfgs
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro_torch import convert
from repro_torch.configs import dlrm_mlperf as pcfgs
from repro_torch.data import pipeline as ppipe
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.models import dlrm as pdlrm
from repro_torch.models import gnn as pgnn

BAG_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)

# (V, d, B, K): the JAX test's sweep, then d = 16 and 130 (a d that is not
# a multiple of 4 or 128), B = 1 and 13 (not multiples of 8)
BAG_CASES = [(500, 128, 16, 1), (1000, 128, 32, 8), (200, 256, 8, 4),
             (64, 16, 13, 3), (50, 130, 1, 5), (300, 128, 13, 1)]
PADS = ["none", "random", "empty"]


def _bags(V, B, K, pads, rng):
    if pads == "none":
        return rng.integers(0, V, size=(B, K)).astype(np.int32)
    bags = rng.integers(-1, V, size=(B, K)).astype(np.int32)
    bags[0, :] = -1  # a bag of only pads
    if pads == "empty":
        bags[:] = -1
    return bags


@pytest.mark.parametrize("pads", PADS)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,K", BAG_CASES)
def test_embedding_bag_ref_matches_jnp(V, d, B, K, mode, pads):
    rng = np.random.default_rng([V, d, B, K, len(mode), len(pads)])
    table = rng.standard_normal((V, d)).astype(np.float32)
    bags = _bags(V, B, K, pads, rng)
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                             jnp.asarray(bags), mode=mode))
    got = pref.embedding_bag_ref(torch.from_numpy(table),
                                 torch.from_numpy(bags), mode)
    assert got.shape == want.shape == (B, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BAG_TOL)
    if K == 1:
        assert np.array_equal(got.numpy(), want)
    if pads == "empty":
        assert not got.any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ids_past_the_table_give_nan_bags(mode):
    """Outside the contract, both packages agree: the bag is NaN."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    bags = rng.integers(-1, 20, size=(6, 3)).astype(np.int32)
    bags[2, 1], bags[4, 0] = 20, 1000
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                             jnp.asarray(bags), mode=mode))
    got = pref.embedding_bag_ref(torch.from_numpy(table),
                                 torch.from_numpy(bags), mode).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[[2, 4]]).all() and not np.isnan(got[[0, 1, 3, 5]]).any()
    np.testing.assert_allclose(got[[0, 1, 3, 5]], want[[0, 1, 3, 5]], **BAG_TOL)


def test_wrapper_on_cpu_runs_the_plain_version_on_strided_bags():
    """A CPU table goes through the plain version, with no launch; a field
    of a [B, F, K] id tensor is a strided view, taken as it is."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((40, 12)).astype(np.float32))
    sparse = torch.from_numpy(rng.integers(-1, 40, size=(9, 4, 3)).astype(np.int32))
    before = ops.launch_counts()
    for i in range(4):
        view = sparse[:, i]
        assert not view.is_contiguous()
        for mode in ("sum", "mean"):
            assert torch.equal(ops.embedding_bag(table, view, mode),
                               pref.embedding_bag_ref(table, view.contiguous(),
                                                      mode))
    assert ops.launch_counts() == before
    assert (ops.launch_counts()["embedding_bag_grouped"]
            == ops.EMBEDDING_BAG_GROUPED.launches)


@pytest.mark.parametrize("bad", ["mode", "float64", "int64", "device", "1d"])
def test_wrapper_guards(bad):
    table = torch.zeros(10, 4)
    bags = torch.zeros(3, 2, dtype=torch.int32)
    err, match, args = {
        "mode": (ValueError, "mode", (table, bags, "max")),
        "float64": (TypeError, "float32 table", (table.double(), bags)),
        "int64": (TypeError, "int32 bags", (table, bags.long())),
        "device": (ValueError, "bags on meta", (table, bags.to("meta"))),
        "1d": (ValueError, "expected table", (table, bags[0])),
    }[bad]
    with pytest.raises(err, match=match):
        ops.embedding_bag(*args)


@pytest.mark.parametrize("pads", PADS)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d,K", [(16, 1), (16, 3), (130, 3), (128, 8)])
def test_embedding_bag_grouped_matches_per_table_and_jnp(d, K, mode, pads):
    """The grouped wrapper on the CPU (the plain loop): field t of a
    strided [B, T, K] id view through table t, bit-equal to the per-table
    ``embedding_bag_ref`` and to ``repro``'s lookup of each field."""
    rng = np.random.default_rng([d, K, len(mode), len(pads), 6])
    vocabs = [30, 3, 200, 11]
    tables = [rng.standard_normal((v, d)).astype(np.float32) for v in vocabs]
    B = 13
    ids = np.stack([_bags(v, B, K, pads, rng) for v in vocabs], 1)
    bags = torch.from_numpy(np.repeat(ids, 2, axis=0))[::2]  # strided along B
    assert not bags.is_contiguous()
    pt = [torch.from_numpy(t) for t in tables]
    before = ops.launch_counts()
    got = ops.embedding_bag_grouped(pt, bags, mode)
    assert ops.launch_counts() == before
    assert got.shape == (B, len(vocabs), d) and got.dtype == torch.float32
    for t, table in enumerate(tables):
        assert torch.equal(got[:, t], pref.embedding_bag_ref(
            pt[t], bags[:, t].contiguous(), mode))
        want = np.asarray(jref.embedding_bag_ref(
            jnp.asarray(table), jnp.asarray(ids[:, t]), mode=mode))
        assert np.array_equal(got[:, t].numpy(), want)


def test_embedding_bag_grouped_writes_into_out():
    """``out`` may be the [B, 1 + T, d] slice the interaction stacks: the
    bags land there, the bottom output's row is left as it was."""
    rng = np.random.default_rng(7)
    tables = [torch.from_numpy(rng.standard_normal((v, 8)).astype(np.float32))
              for v in (5, 9, 4)]
    bags = torch.from_numpy(rng.integers(-1, 4, size=(6, 3, 2)).astype(np.int32))
    Z = torch.full((6, 4, 8), 3.0)
    got = ops.embedding_bag_grouped(tables, bags, "sum", out=Z[:, 1:])
    assert got.data_ptr() == Z[:, 1:].data_ptr()
    assert torch.equal(Z[:, 0], torch.full((6, 8), 3.0))
    assert torch.equal(Z[:, 1:], ops.embedding_bag_grouped(tables, bags))


@pytest.mark.parametrize("bad", ["mode", "none", "int64", "fields", "width",
                                 "float64", "device", "out"])
def test_embedding_bag_grouped_guards(bad):
    tables = [torch.zeros(10, 4), torch.zeros(7, 4)]
    bags = torch.zeros(3, 2, 1, dtype=torch.int32)
    err, match, args, kw = {
        "mode": (ValueError, "mode", (tables, bags, "max"), {}),
        "none": (ValueError, "at least one table", ([], bags), {}),
        "int64": (TypeError, "int32 bags", (tables, bags.long()), {}),
        "fields": (ValueError, "expected bags", (tables[:1], bags), {}),
        "width": (ValueError, "every table", ([tables[0], torch.zeros(7, 5)],
                                              bags), {}),
        "float64": (TypeError, "float32 tables",
                    ([tables[0], tables[1].double()], bags), {}),
        "device": (ValueError, "every table",
                   ([tables[0], tables[1].to("meta")], bags), {}),
        "out": (ValueError, "out must be", (tables, bags),
                {"out": torch.zeros(3, 2, 5)}),
    }[bad]
    with pytest.raises(err, match=match):
        ops.embedding_bag_grouped(*args, **kw)


def test_lookups_are_views_of_one_grouped_result():
    """``lookups`` keeps its list of [B, d] results: the fields of one
    [B, n_sparse, d] tensor, each equal to the per-table plain bag."""
    cfg = pcfgs.reduced_config()
    params = pdlrm.dlrm_init(cfg, generator=torch.Generator().manual_seed(8),
                             device="cpu")
    arrays = ppipe.CriteoPipeline(cfg.vocabs, 16, cfg.multi_hot,
                                  seed=8).get_batch(0)
    sparse = torch.from_numpy(arrays["sparse"])
    embs = pdlrm.lookups(params, sparse)
    assert len(embs) == cfg.n_sparse
    for i, (e, table) in enumerate(zip(embs, params["tables"])):
        assert e.shape == (16, cfg.embed_dim)
        assert torch.equal(e, pref.embedding_bag_ref(table, sparse[:, i]))


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("act", ["relu", "silu"])
def test_mlp_apply_matches_jnp(act, final_act):
    sizes = [13, 32, 24, 5]
    jl = jgnn.mlp_init(jax.random.PRNGKey(3), sizes)
    rng = np.random.default_rng(3)
    jl = [{"w": l["w"], "b": jnp.asarray(rng.standard_normal(l["b"].shape),
                                        jnp.float32)} for l in jl]
    x = rng.standard_normal((17, 13)).astype(np.float32)
    want = np.asarray(jgnn.mlp_apply(jl, jnp.asarray(x),
                                     act=getattr(jax.nn, act),
                                     final_act=final_act))
    pl = [{k: torch.from_numpy(np.array(v)) for k, v in l.items()} for l in jl]
    got = pgnn.mlp_apply(pl, torch.from_numpy(x),
                         act=getattr(torch.nn.functional, act),
                         final_act=final_act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mlp_init_shapes_and_scale():
    layers = pgnn.mlp_init([13, 512, 256], generator=torch.Generator().manual_seed(1),
                           device="cpu")
    assert [tuple(l["w"].shape) for l in layers] == [(13, 512), (512, 256)]
    assert all(not l["b"].any() for l in layers)
    # He-normal: std sqrt(2 / fan_in), to ~2% over 131,072 draws
    assert abs(float(layers[1]["w"].std()) * (512 / 2) ** 0.5 - 1.0) < 0.02


SMALL = dict(vocabs=(50, 20, 7), embed_dim=8, bot_mlp=(13, 16, 8),
             top_mlp=(16, 8, 1), multi_hot=3)
CONFIGS = ["reduced", "small_multi_hot3"]


def _configs(name):
    if name == "reduced":
        return jcfgs.reduced_config(), pcfgs.reduced_config()
    return jdlrm.DLRMConfig(**SMALL), pdlrm.DLRMConfig(**SMALL)


def _case(name, B=24):
    """The same weights and batch in both packages."""
    jcfg, pcfg = _configs(name)
    jp = jdlrm.dlrm_init(jcfg, jax.random.PRNGKey(len(name)))
    arrays = jpipe.CriteoPipeline(tuple(jcfg.vocabs), B, jcfg.multi_hot,
                                  seed=len(name)).get_batch(2)
    if jcfg.multi_hot > 1:  # pads, and one bag of only pads
        rng = np.random.default_rng(7)
        sparse = arrays["sparse"].copy()
        sparse[rng.random(sparse.shape) < 0.3] = -1
        sparse[1, 0, :] = -1
        arrays = dict(arrays, sparse=sparse)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    pp = convert.dlrm_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, jp), pcfg, device="cpu")
    pbatch = convert.dlrm_batch_from_arrays(arrays, device="cpu")
    return jcfg, pcfg, jp, jbatch, pp, pbatch


@pytest.mark.parametrize("name", CONFIGS)
def test_dlrm_forward_matches_jnp(name):
    jcfg, pcfg, jp, jbatch, pp, pbatch = _case(name)
    want = np.asarray(jdlrm.dlrm_forward(jp, jbatch, jcfg))
    before = ops.launch_counts()
    got = pdlrm.dlrm_forward(pp, pbatch, pcfg, device="cpu")
    assert ops.launch_counts() == before
    assert got.shape == want.shape == (24,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_dlrm_loss_matches_jnp(name):
    jcfg, pcfg, jp, jbatch, pp, pbatch = _case(name)
    want = float(jdlrm.dlrm_loss(jp, jbatch, jcfg))
    got = pdlrm.dlrm_loss(pp, pbatch, pcfg, device="cpu")
    assert got.shape == () and np.isfinite(want)
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_user_tower_and_retrieval_match_jnp(name):
    jcfg, pcfg, jp, jbatch, pp, pbatch = _case(name)
    user = {"dense": jbatch["dense"][:1]}
    want_u = np.array(jdlrm.dlrm_user_tower(jp, user, jcfg))
    got_u = pdlrm.dlrm_user_tower(pp, {"dense": pbatch["dense"][:1]}, pcfg,
                                  device="cpu")
    np.testing.assert_allclose(got_u.numpy(), want_u, **TOL)
    cands = np.random.default_rng(8).standard_normal(
        (1000, jcfg.bot_mlp[-1])).astype(np.float32)
    want = np.asarray(jdlrm.retrieval_scores(jnp.asarray(want_u[0]),
                                             jnp.asarray(cands)))
    got = pdlrm.retrieval_scores(torch.from_numpy(want_u[0]),
                                 torch.from_numpy(cands))
    assert got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_module_equals_function():
    _, pcfg, _, _, pp, pbatch = _case("small_multi_hot3")
    model = pdlrm.DLRM(pcfg, pp)
    assert len(model.tables) == pcfg.n_sparse
    assert torch.equal(model(pbatch), pdlrm.dlrm_forward(pp, pbatch, pcfg,
                                                         device="cpu"))


def test_interaction_pairs_in_jnp_order():
    """torch.triu_indices(f, f, 1) lists the pairs as jnp.triu_indices."""
    for f in (2, 5, 27):
        iu, ju = jnp.triu_indices(f, k=1)
        pair = torch.triu_indices(f, f, offset=1)
        assert np.array_equal(pair.numpy(), np.stack([iu, ju]))


@pytest.mark.parametrize("step,host_id,n_hosts", [(0, 0, 1), (1, 0, 1),
                                                  (7, 0, 2), (7, 1, 2),
                                                  (3, 2, 4)])
@pytest.mark.parametrize("multi_hot", [1, 3])
def test_criteo_pipeline_bit_equal(step, host_id, n_hosts, multi_hot):
    vocabs = tuple(pcfgs.capped_config(1000).vocabs)
    a = jpipe.CriteoPipeline(vocabs, 64, multi_hot, seed=5).get_batch(
        step, host_id, n_hosts)
    b = ppipe.CriteoPipeline(vocabs, 64, multi_hot, seed=5).get_batch(
        step, host_id, n_hosts)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert b["sparse"].shape == (64 // n_hosts, 26, multi_hot)
    assert (b["sparse"] < np.asarray(vocabs)[None, :, None]).all()


def test_configs_equal_repro():
    for fn in ("make_config", "reduced_config"):
        a, b = getattr(jcfgs, fn)(), getattr(pcfgs, fn)()
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert np.dtype(fa.pop("dtype")).name == "float32"
        assert fb.pop("dtype") == torch.float32
        assert fa == fb, fn
        assert (a.n_sparse, a.n_interactions) == (b.n_sparse, b.n_interactions)
    assert pdlrm.MLPERF_VOCABS == jdlrm.MLPERF_VOCABS
    assert pcfgs.RECSYS_SHAPES == jcells.RECSYS_SHAPES
    for k in ("ARCH_ID", "FAMILY", "SHAPES"):
        assert getattr(pcfgs, k) == getattr(jcfgs, k), k


def test_capped_config_rows():
    cfg = pcfgs.capped_config()
    assert sum(cfg.vocabs) == 87_950_072
    assert sum(cfg.vocabs) * cfg.embed_dim * 4 == 45_030_436_864
    assert sum(v == 2 ** 24 for v in cfg.vocabs) == 5
    assert sum(pcfgs.make_config().vocabs) == 187_767_399
    assert dataclasses.replace(cfg, vocabs=()) == dataclasses.replace(
        pcfgs.make_config(), vocabs=())


def test_dlrm_init_shapes_and_scale():
    cfg = pcfgs.reduced_config()
    p = pdlrm.dlrm_init(cfg, generator=torch.Generator().manual_seed(2),
                        device="cpu")
    assert [tuple(t.shape) for t in p["tables"]] == [(v, 16) for v in cfg.vocabs]
    assert [tuple(l["w"].shape) for l in p["top"]] == [(26, 32), (32, 1)]
    assert all(t.dtype == torch.float32 for t in p["tables"])
    big = pdlrm.dlrm_init(dataclasses.replace(cfg, vocabs=(20000,)),
                          device="cpu")["tables"][0]
    # N(0, 1/16): 320,000 draws give the std to well under 1%
    assert abs(float(big.std()) * 4.0 - 1.0) < 0.01
    again = pdlrm.dlrm_init(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p["tables"], again["tables"]))


def test_converters_reject_mismatches():
    jcfg, pcfg, jp, _, _, _ = _case("reduced")
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="the config"):
        convert.dlrm_params_from_arrays(arrays, pcfgs.make_config(), device="cpu")
    bad = dict(arrays, tables=arrays["tables"][:1] + [np.zeros((4, 3))])
    with pytest.raises(ValueError, match="one width"):
        convert.dlrm_params_from_arrays(bad, device="cpu")
    bad = dict(arrays, bot=arrays["bot"][::-1])
    with pytest.raises(ValueError, match="chained"):
        convert.dlrm_params_from_arrays(bad, device="cpu")
    ok = {"dense": np.zeros((4, 13)), "sparse": np.zeros((4, 4, 1))}
    batch = convert.dlrm_batch_from_arrays(ok, device="cpu")
    assert batch["sparse"].dtype == torch.int32
    assert batch["dense"].dtype == torch.float32
    for key, value, match in (("dense", np.zeros(4), "dense"),
                              ("sparse", np.zeros((4, 4)), "sparse"),
                              ("sparse", np.zeros((3, 4, 1)), "sparse"),
                              ("label", np.zeros(3), "label")):
        with pytest.raises(ValueError, match=match):
            convert.dlrm_batch_from_arrays({**ok, key: value}, device="cpu")


def test_forward_checks_placement(monkeypatch):
    _, pcfg, _, _, pp, pbatch = _case("reduced")
    with pytest.raises(ValueError, match="is on cpu"):
        pdlrm.dlrm_forward(pp, pbatch, pcfg, device="meta")
    moved = dict(pbatch, sparse=pbatch["sparse"].to("meta"))
    with pytest.raises(ValueError, match=r"batch\['sparse'\] is on meta"):
        pdlrm.dlrm_forward(pp, moved, pcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdlrm.dlrm_forward(pp, pbatch, pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdlrm.dlrm_user_tower(pp, pbatch, pcfg)
