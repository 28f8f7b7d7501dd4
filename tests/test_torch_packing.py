"""SlimSell-B in the port (plain path, CPU) against the JAX package.

Packing, the bit gather and the OR reductions equal ``repro.core.packing``
word for word (the port's int32 words viewed as uint32); the plain packed
SpMV and SpMM equal the jnp sweeps; packed BFS and multi-source BFS, fused
and hostloop, are bit-equal to the JAX package's packed jnp path and to
the port's own lane-boolean path (distances, DP parents, iterations, work
logs); every padding bit above n (or above B) stays zero. Every value is
an integer or a bit pattern, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as jbfs
from repro.core import engine as jeng
from repro.core import formats as jf
from repro.core import multi_bfs as jmulti
from repro.core import packing as jpk
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch import convert
from repro_torch.core import bfs as pbfs
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core import multi_bfs as pmulti
from repro_torch.core import packing as ppk
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.core.options import EngineConfig
from repro_torch.graph500 import validate_bfs_tree
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

MODES = ["fused", "hostloop"]
# each takes (generators, formats) of one package: (csr, root, L)
GRAPHS = {
    "kron": (lambda g, f: g.kronecker(8, 8, seed=3), 5, 16),
    "rmat": (lambda g, f: g.kronecker(9, 16, seed=5), 7, 32),
    "star": (lambda g, f: g.star(97), 3, 16),              # tail word (97)
    "path": (lambda g, f: f.build_csr(
        np.stack([np.arange(69), np.arange(1, 70)], axis=1), 70), 0, 16),
}
ROOTS47 = np.arange(47) * 3 % 70  # a ragged batch: 47 roots, 2 word planes


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def layouts():
    """{graph: (jax layout, csr, cpu layout)}, C=8 and the graph's L."""
    out = {}
    for name, (make, _, L) in GRAPHS.items():
        csr = make(pg, pf)
        jt = jf.build_slimsell(make(jg, jf), C=8, L=L).to_jax()
        out[name] = (jt, csr, pf.build_slimsell(csr, C=8, L=L).to_torch("cpu"))
    return out


# ----------------------------------------------------------- packing basics


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("width", [1, 31, 32, 33, 47, 64, 95])
def test_pack_unpack_round_trip(width, axis):
    """Tail widths n % 32 in {0, 1, 31} and B in {1, 31, 33, 47, 64}."""
    rng = np.random.default_rng([width, axis])
    shape = (width, 5) if axis == 0 else (5, width)
    bits = rng.random(shape) < 0.4
    want = np.asarray(jpk.pack_bits(jnp.asarray(bits), axis=axis))
    words = ppk.pack_bits(torch.from_numpy(bits), axis=axis)
    assert words.dtype == torch.int32
    assert words.shape[axis] == ppk.packed_words(width)
    assert np.array_equal(_u32(words), want)
    assert np.array_equal(ppk.pack_bits_np(bits, axis=axis).view(np.uint32), want)
    assert np.array_equal(ppk.unpack_bits(words, width, axis=axis).numpy(), bits)
    assert np.array_equal(ppk.unpack_bits_np(words.numpy(), width, axis=axis), bits)
    assert np.array_equal(ppk.unpack_bits_np(want, width, axis=axis), bits)
    last = np.moveaxis(words.numpy(), axis, -1)
    assert ppk.check_tail_zero_host(last, width)


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 64, 97])
def test_masks_match_jax(n_bits):
    assert ppk.packed_words(n_bits) == jpk.packed_words(n_bits)
    assert np.uint32(ppk.tail_mask(n_bits) & 0xFFFFFFFF) == jpk.tail_mask(n_bits)
    assert np.array_equal(ppk.padding_mask(n_bits).view(np.uint32),
                          jpk.padding_mask(n_bits))
    words = jpk.padding_mask(n_bits)
    assert ppk.check_tail_zero_host(words.view(np.int32), n_bits)
    if n_bits % 32:
        bad = words.copy()
        bad[-1] |= np.uint32(1 << 31)  # a padding bit set
        assert not ppk.check_tail_zero_host(bad.view(np.int32), n_bits)
        assert not jpk.check_tail_zero_host(bad, n_bits)
    v = np.arange(200)
    assert np.array_equal(ppk.word_of(v), jpk.word_of(v))
    assert np.array_equal(ppk.bit_of(v), jpk.bit_of(v))


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_gather_bits_matches_jax():
    rng = np.random.default_rng(1)
    words = _words(rng, 40)
    idx = rng.integers(0, 40 * 32, size=(6, 9))
    got = ppk.gather_bits(torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        jpk.gather_bits(jnp.asarray(words), jnp.asarray(idx))))


@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (1, 2), (-1,)])
def test_or_reduce_matches_jax(axes):
    rng = np.random.default_rng(len(axes))
    x = _words(rng, (6, 7, 13))
    got = ppk.or_reduce(torch.from_numpy(x.view(np.int32)), axes)
    want = jpk.or_reduce(jnp.asarray(x), tuple(a % 3 for a in axes))
    assert np.array_equal(_u32(got), np.asarray(want))
    if axes == (-1,):
        assert np.array_equal(
            _u32(ppk.or_reduce_last(torch.from_numpy(x.view(np.int32)))),
            np.asarray(jpk.or_reduce_last(jnp.asarray(x))))


@pytest.mark.parametrize("width", [None, 3])
def test_segment_or_matches_jax(width):
    rng = np.random.default_rng(width or 0)
    shape = (60,) if width is None else (60, width)
    x = _words(rng, shape)
    ids = rng.integers(0, 12, size=60)
    ids[ids == 4] = 5  # segment 4 stays empty
    got = ppk.segment_or(torch.from_numpy(x.view(np.int32)),
                         torch.from_numpy(ids), 14)
    want = jpk.segment_or(jnp.asarray(x), jnp.asarray(ids), 14)
    assert np.array_equal(_u32(got), np.asarray(want))
    assert not got[4].any() and not got[13].any()


def test_packed_semiring():
    sr = psr.get("boolean_packed")
    assert sr is psr.BOOLEAN_PACKED and sr.dtype == torch.int32
    assert sr.zero == 0 and sr.one == ppk.FULL_WORD == sr.edge_value == -1
    assert sr.code not in {s.code for s in psr.SEMIRINGS.values() if s is not sr}
    x = torch.tensor([5, -7, 1 << 30], dtype=torch.int32)
    assert torch.equal(sr.edge(x), x)  # the all-ones word ANDs to x
    assert int(sr.reduce(x, 0)) == (5 | -7 | (1 << 30))
    with pytest.raises(ValueError, match="OR"):
        sr.scatter_reduce


# ------------------------------------------------------------ packed sweeps


def _sweep_mask(kind, tiled, rng):
    """None, half the tiles at random, or every tile of ~60% of the chunks
    (whole chunks dropped)."""
    if kind == "none":
        return None
    rb = tiled.row_block.numpy()
    if kind == "random":
        return rng.random(tiled.n_tiles) < 0.5
    keep = rng.random(tiled.n_chunks) < 0.6
    return keep[rb]


@pytest.fixture(scope="module")
def sweep_layouts():
    """A graph with a tail word (n = 221) and one without (n = 256)."""
    out = {}
    for name, make in (("er", lambda g: g.erdos_renyi(221, 5.0, seed=1)),
                       ("kron", lambda g: g.kronecker(8, 8, seed=1))):
        out[name] = (jf.build_slimsell(make(jg), C=8, L=16).to_jax(),
                     pf.build_slimsell(make(pg), C=8, L=16).to_torch("cpu"))
    return out


@pytest.mark.parametrize("mask_kind", ["none", "random", "chunks"])
@pytest.mark.parametrize("graph", ["er", "kron"])
def test_spmv_packed_matches_jnp(sweep_layouts, graph, mask_kind):
    jt, pt = sweep_layouts[graph]
    rng = np.random.default_rng([len(graph), len(mask_kind)])
    x = jpk.pack_bits_np(rng.random(pt.n) < 0.1)
    mask = _sweep_mask(mask_kind, pt, rng)
    want = jspmv.slimsell_spmv_packed(
        jt, jnp.asarray(x), backend="jnp",
        tile_mask=None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    xt = torch.from_numpy(x.view(np.int32))
    got = pspmv.slimsell_spmv_packed(pt, xt, tile_mask=tm)
    assert torch.equal(got, pspmv.spmv_packed_plain(pt, xt, tm))
    assert got.shape == (ppk.packed_words(pt.n),) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), np.asarray(want))
    assert got.any() and ppk.check_tail_zero_host(got.numpy(), pt.n)


@pytest.mark.parametrize("width", [1, 5, 33, 64, 97, 160])
@pytest.mark.parametrize("mask_kind", ["none", "random", "chunks"])
def test_spmm_packed_matches_jnp(sweep_layouts, mask_kind, width):
    jt, pt = sweep_layouts["er"]
    rng = np.random.default_rng([width, len(mask_kind)])
    X = jpk.pack_bits_np(rng.random((pt.n, width)) < 0.1, axis=1)
    mask = _sweep_mask(mask_kind, pt, rng)
    want = jspmv.slimsell_spmm(
        jsr.BOOLEAN_PACKED, jt, jnp.asarray(X), backend="jnp",
        tile_mask=None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    Xt = torch.from_numpy(X.view(np.int32))
    got = pspmv.slimsell_spmm(psr.BOOLEAN_PACKED, pt, Xt, tile_mask=tm)
    assert torch.equal(got, pspmv.spmm_packed_plain(pt, Xt, tm))
    assert got.shape == (pt.n, ppk.packed_words(width))
    assert np.array_equal(_u32(got), np.asarray(want))
    assert got.any() and ppk.check_tail_zero_host(got.numpy(), width)


def test_packed_wrappers_check_inputs(sweep_layouts):
    _, pt = sweep_layouts["er"]
    W = ppk.packed_words(pt.n)
    before = ops.launch_counts()
    ops.spmv_packed(pt, torch.zeros(W, dtype=torch.int32))
    ops.spmm_packed(pt, torch.zeros((pt.n, 2), dtype=torch.int32))
    assert ops.launch_counts() == before  # CPU tensors run the plain versions
    with pytest.raises(ValueError, match=f"\\[{W}\\]"):
        ops.spmv_packed(pt, torch.zeros(pt.n, dtype=torch.int32))
    with pytest.raises(TypeError, match="boolean_packed"):
        ops.spmv_packed(pt, torch.zeros(W, dtype=torch.int64))
    with pytest.raises(ValueError, match="tile_mask"):
        ops.spmm_packed(pt, torch.zeros((pt.n, 2), dtype=torch.int32),
                        tile_mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="B\\]"):
        ops.spmm_packed(pt, torch.zeros(pt.n, dtype=torch.int32))


# --------------------------------------------------------- packed BFS paths


def _same(got, want, fields):
    for f in fields:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_packed_bfs_bit_equal(layouts, graph, mode):
    jt, csr, pt = layouts[graph]
    root = GRAPHS[graph][1]
    kw = dict(need_parents=True, log_work=True)
    want = jbfs.bfs(jt, root, "boolean", packed=True, config=JConfig(mode=mode),
                    **kw)
    got = pbfs.bfs(pt, root, "boolean", packed=True,
                   config=EngineConfig(mode=mode), device="cpu", **kw)
    lane = pbfs.bfs(pt, root, "boolean", config=EngineConfig(mode=mode),
                    device="cpu", **kw)
    for ref in (want, lane):
        assert got.iterations == ref.iterations
        _same(got, ref, ("distances", "parents", "work_log"))
    validate_bfs_tree(csr, root, got.distances, got.parents)


@pytest.mark.parametrize("batch_size", [None, 20])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_packed_multi_bfs_bit_equal(layouts, graph, mode, batch_size):
    """47 roots: one ragged batch of 2 word planes (17 tail bits), or
    batches of 20 with the last one padded."""
    jt, csr, pt = layouts[graph]
    roots = ROOTS47 % pt.n
    kw = dict(need_parents=True, log_work=True, batch_size=batch_size)
    want = jmulti.multi_source_bfs(jt, roots, "boolean", packed=True,
                                   config=JConfig(mode=mode), **kw)
    got = pmulti.multi_source_bfs(pt, roots, "boolean", packed=True,
                                  config=EngineConfig(mode=mode),
                                  device="cpu", **kw)
    lane = pmulti.multi_source_bfs(pt, roots, "boolean",
                                   config=EngineConfig(mode=mode),
                                   device="cpu", **kw)
    fields = ("distances", "parents", "iterations", "roots", "work_log")
    _same(got, want, fields)
    _same(got, lane, fields)
    for i in (0, 46):
        validate_bfs_tree(csr, int(roots[i]), got.distances[i], got.parents[i])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["bfs", "multi"])
def test_sweep_outputs_keep_tail_bits_zero(layouts, monkeypatch, kind, mode):
    """Every sweep of a packed run (n = 97, B = 47) leaves the padding bits
    above n / above B zero."""
    _, _, pt = layouts["star"]
    seen = []
    spmv, spmm = peng.slimsell_spmv_packed, peng.slimsell_spmm

    def spmv_rec(tiled, x, *, tile_mask=None):
        seen.append(("n", spmv(tiled, x, tile_mask=tile_mask)))
        return seen[-1][1]

    def spmm_rec(sr, tiled, X, *, tile_mask=None):
        seen.append(("B", spmm(sr, tiled, X, tile_mask=tile_mask)))
        return seen[-1][1]

    monkeypatch.setattr(peng, "slimsell_spmv_packed", spmv_rec)
    monkeypatch.setattr(peng, "slimsell_spmm", spmm_rec)
    cfg = EngineConfig(mode=mode)
    if kind == "bfs":
        pbfs.bfs(pt, 3, "boolean", packed=True, config=cfg, device="cpu")
    else:
        pmulti.multi_source_bfs(pt, ROOTS47, "boolean", packed=True,
                                config=cfg, device="cpu")
    assert len(seen) >= 2
    for what, y in seen:
        assert what == ("n" if kind == "bfs" else "B")
        assert ppk.check_tail_zero_host(y.numpy(), pt.n if what == "n" else 47)


@pytest.mark.parametrize("kind", ["bfs", "multi"])
def test_one_packed_step_from_carried_state(layouts, kind):
    """Iteration 3 run by the port from the JAX package's packed state after
    two iterations (uint32 words, carried across as int32) gives the JAX
    package's state after three."""
    jt, _, pt = layouts["kron"]
    if kind == "bfs":
        jspec, pspec = jbfs.packed_bfs_spec(pt.n), pbfs.packed_bfs_spec(pt.n)
        arg = jnp.asarray(5, jnp.int32)
    else:
        jspec = jmulti.packed_multi_bfs_spec(47)
        pspec = pmulti.packed_multi_bfs_spec(47)
        arg = jnp.asarray(ROOTS47)
    before = jeng.run_fused(jspec, jt, arg, max_iters=2)
    after = jeng.run_fused(jspec, jt, arg, max_iters=3, log_work=True)
    assert before.iterations == 2 and after.iterations == 3
    state = convert.state_from_arrays(
        {k: np.asarray(v) for k, v in before.state.items()}, device="cpu")
    assert state["f"].dtype == torch.int32
    got, cont, used = peng.step(pspec, pt, state, 3)
    assert bool(cont) and int(used) == int(after.work_log[2])
    assert sorted(got) == sorted(after.state)
    for k, v in after.state.items():
        v = np.asarray(v)
        have = got[k].numpy()
        assert np.array_equal(have.view(np.uint32) if v.dtype == np.uint32
                              else have, v), k


@pytest.mark.parametrize("kind", ["bfs", "multi"])
def test_engine_refuses_packed_pull(layouts, kind):
    """A packed spec handed to the engine directly, past the front doors'
    checks, raises on its first pull sweep."""
    _, _, pt = layouts["kron"]
    if kind == "bfs":
        spec, arg = pbfs.packed_bfs_spec(pt.n), 5
    else:
        spec, arg = pmulti.packed_multi_bfs_spec(47), torch.from_numpy(ROOTS47)
    with pytest.raises(ValueError, match="push-only"):
        peng.step(spec, pt, spec.init_state(pt.n, arg, "cpu"), 1, pull=True,
                  nf=torch.ones((pt.n,) if kind == "bfs" else (pt.n, 47),
                                dtype=torch.bool))


@pytest.mark.parametrize("semiring,direction", [("tropical", "push"),
                                                ("boolean", "pull"),
                                                ("boolean", "auto")])
@pytest.mark.parametrize("kind", ["bfs", "multi"])
def test_packed_front_doors_reject_as_jax(layouts, kind, semiring, direction):
    jt, _, pt = layouts["kron"]
    if kind == "bfs":
        def j():
            jbfs.bfs(jt, 0, semiring, packed=True,
                     config=JConfig(direction=direction))

        def p():
            pbfs.bfs(pt, 0, semiring, packed=True,
                     config=EngineConfig(direction=direction), device="cpu")
    else:
        def j():
            jmulti.multi_source_bfs(jt, [0, 1], semiring, packed=True,
                                    config=JConfig(direction=direction))

        def p():
            pmulti.multi_source_bfs(pt, [0, 1], semiring, packed=True,
                                    config=EngineConfig(direction=direction),
                                    device="cpu")
    with pytest.raises(ValueError) as want:
        j()
    with pytest.raises(ValueError) as got:
        p()
    assert str(got.value) == str(want.value)
    assert "packed=True" in str(got.value)


# ------------------------------------------------- layout identity, storage


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_storage_and_signature_match_jax(graph):
    make = GRAPHS[graph][0]
    a, b = make(jg, jf), make(pg, pf)
    for kw in ({}, dict(C=4, L=16, sigma=32)):
        assert pf.storage_summary(b, **kw).__dict__ == \
            jf.storage_summary(a, **kw).__dict__
    s = pf.storage_summary(b)
    assert s.slimsell_vs_sellcs == jf.storage_summary(a).slimsell_vs_sellcs
    assert s.slimsell_vs_al == jf.storage_summary(a).slimsell_vs_al
    ja, pa = jf.build_slimsell(a, C=4, L=16), pf.build_slimsell(b, C=4, L=16)
    assert pf.layout_signature(pa) == jf.layout_signature(ja)
    assert pf.layout_signature(pa.to_torch("cpu")) == jf.layout_signature(ja)
    assert pf.layout_signature(pa)[-1] == ppk.packed_words(b.n)
