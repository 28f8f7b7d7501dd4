"""The port's batched multi-source SSSP against the JAX package's jnp path,
on the plain (CPU) sweeps: the stored-weight min-plus SpMM, the batched
delta-stepping spec in both engine modes, its rows against the port's own
per-root ``sssp``, batching and padding, the batched Graph500 SSSP harness
and the boundary errors.

Every input is made from a seed with numpy (the two packages' generators
are the same code) and handed to both packages. Where sweeps, buckets,
iterations, work logs or parents are compared, the JAX package's delta is
passed to both explicitly (``core.sssp.default_delta`` says why). All
comparisons are exact: a min of float32 sums is independent of the order
it is taken in, and the parent DP picks the largest score.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph500 as jg500
from repro.core import formats as jf
from repro.core import multi_sssp as jmsssp
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.core import sssp as jsssp
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch import graph500 as pg500
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core import multi_sssp as pmsssp
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.core import sssp as psssp
from repro_torch.core.options import EngineConfig
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

MODES = ["fused", "hostloop"]


def _path(f, g, n=64):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return g.with_random_weights(f.build_csr(edges, n), low=0.5, high=3.0,
                                 seed=0)


# the JAX package's test families (tests/test_multi_sssp.py); each is
# built by (formats, generators) of one package
FAMILIES = {
    "kron": lambda f, g: g.with_random_weights(g.kronecker(8, 8, seed=3),
                                               seed=5),
    "er": lambda f, g: g.with_random_weights(g.erdos_renyi(256, 4, seed=1),
                                             seed=2),
    "ring": lambda f, g: g.with_random_weights(g.ring_of_cliques(10, 5),
                                               low=0.25, high=4.0, seed=7),
    "star": lambda f, g: g.with_random_weights(g.star(100), seed=4),
    "path": _path,
    "disconnected": lambda f, g: g.with_random_weights(
        g.two_components(6, 6, seed=0), seed=9),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX layout, port layout on the CPU, weighted CSR, roots)."""
    jcsr = FAMILIES[request.param](jf, jg)
    pcsr = FAMILIES[request.param](pf, pg)
    assert np.array_equal(jcsr.weights, pcsr.weights)
    jt = jf.build_slimsell(jcsr, C=8, L=32).to_jax()
    pt = pf.build_slimsell(pcsr, C=8, L=32).to_torch("cpu")
    roots = pg500.sample_roots(pcsr, 3, seed=11)
    assert np.array_equal(roots, jg500.sample_roots(jcsr, 3, seed=11))
    return request.param, jt, pt, pcsr, roots


def _layouts(family_name):
    jt = jf.build_slimsell(FAMILIES[family_name](jf, jg), C=8, L=32).to_jax()
    pt = pf.build_slimsell(FAMILIES[family_name](pf, pg), C=8,
                           L=32).to_torch("cpu")
    return jt, pt


FIELDS = ("distances", "parents", "sweeps", "buckets", "iterations",
          "work_log", "roots", "delta")


def _assert_same(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert np.array_equal(g, w), f


def _scipy(csr, root):
    A = csr_matrix((csr.weights, csr.indices, csr.indptr), shape=(csr.n, csr.n))
    return dijkstra(A, indices=root, directed=True)


# ------------------------------------------------------------- the sweep


MASKS = ["none_given", "all_kept", "none_kept", "random"]


def _mask(kind, tiled, rng):
    if kind == "none_given":
        return None
    if kind in ("all_kept", "none_kept"):
        return np.full(tiled.n_tiles, kind == "all_kept")
    keep_chunk = rng.random(tiled.n_chunks) < 0.65
    return (rng.random(tiled.n_tiles) < 0.5) \
        & keep_chunk[np.asarray(tiled.row_block)]


@pytest.mark.parametrize("width", [1, 5, 33, 97, 160])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_minplus_spmm_matches_jnp(mask_kind, width):
    """The stored-weight SpMM, bit-equal: the front door and the plain
    version against ``repro.core.spmv.slimsell_spmm(MINPLUS, weights=)``;
    with every padding slot's weight poisoned, the port gives the same."""
    jt, pt = _layouts("kron")
    rng = np.random.default_rng([MASKS.index(mask_kind), width])
    X = rng.uniform(0.0, 4.0, (pt.n, width)).astype(np.float32)
    X[rng.random(X.shape) < 0.6] = np.inf
    mask = _mask(mask_kind, pt, rng)
    want = jspmv.slimsell_spmm(jsr.MINPLUS, jt, jnp.asarray(X),
                               weights=jt.wts, backend="jnp",
                               tile_mask=None if mask is None
                               else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    Xt = torch.from_numpy(X)
    poisoned = torch.where(pt.cols < 0, -1000.0, pt.wts)
    assert bool((pt.cols < 0).any())
    for w in (pt.wts, poisoned):
        got = pspmv.slimsell_spmm(psr.MINPLUS, pt, Xt, weights=w, tile_mask=tm)
        plain = pspmv.spmm_plain(psr.MINPLUS, pt, Xt, tm, w)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(plain.numpy(), np.asarray(want))


def test_spmm_weight_guards():
    """minplus without weights and weights under any other semiring raise,
    in the front door and the wrapper; the packed route is unchanged."""
    _, pt = _layouts("kron")
    X = torch.zeros(pt.n, 3)
    with pytest.raises(ValueError, match="stored weights"):
        pspmv.slimsell_spmm(psr.MINPLUS, pt, X)
    with pytest.raises(ValueError, match="stored weights"):
        ops.spmm(psr.MINPLUS, pt, X)
    with pytest.raises(ValueError, match="minplus"):
        pspmv.slimsell_spmm(psr.TROPICAL, pt, X, weights=pt.wts)
    words = torch.zeros(pt.n, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="minplus"):
        pspmv.slimsell_spmm(psr.BOOLEAN_PACKED, pt, words, weights=pt.wts)
    with pytest.raises(ValueError, match="weights must be"):
        ops.spmm(psr.MINPLUS, pt, X, weights=pt.wts[:1])
    assert torch.equal(pspmv.slimsell_spmm(psr.BOOLEAN_PACKED, pt, words),
                       ops.spmm_packed(pt, words))
    assert ops.SPMM_WTS in ops.KERNELS
    assert ops.SPMM_WTS.source == "slimsell_spmm"
    assert "slimsell_spmm_wts" in ops.launch_counts()


# --------------------------------------------------------- multi_source_sssp


@pytest.mark.parametrize("mode", MODES)
def test_multi_sssp_matches_jax_package(family, mode):
    """Distances, parents, sweeps, buckets, iterations and the work log,
    bit-equal to ``repro``'s jnp path at ``repro``'s delta."""
    _, jt, pt, _, roots = family
    d = jsssp.default_delta(jt)
    want = jmsssp.multi_source_sssp(jt, roots, delta=d, need_parents=True,
                                    log_work=True, config=JConfig(mode=mode))
    got = pmsssp.multi_source_sssp(pt, roots, delta=d, need_parents=True,
                                   log_work=True,
                                   config=EngineConfig(mode=mode),
                                   device="cpu")
    assert got.distances.dtype == np.float32 and got.parents.dtype == np.int32
    _assert_same(got, want)


def test_rows_equal_per_root_sssp_and_dijkstra(family):
    """Row i is the port's own ``sssp(roots[i])`` (distances, parents,
    sweeps, buckets), fused and hostloop, and Dijkstra's distances."""
    _, _, pt, csr, roots = family
    per = [psssp.sssp(pt, int(r), need_parents=True, device="cpu")
           for r in roots]
    for mode in MODES:
        res = pmsssp.multi_source_sssp(pt, roots, need_parents=True,
                                       config=EngineConfig(mode=mode),
                                       device="cpu")
        for i, r in enumerate(roots):
            assert np.array_equal(res.distances[i], per[i].distances)
            assert np.array_equal(res.parents[i], per[i].parents)
            assert (res.sweeps[i], res.buckets[i]) == \
                (per[i].sweeps, per[i].buckets)
            pg500.validate_sssp_tree(csr, int(r), res.distances[i],
                                     res.parents[i], d_ref=_scipy(csr, int(r)))


def test_default_delta_matches_jax_package(family):
    """The default delta alone. The port's is the mean weight rounded once
    to float32; ``repro`` sums the float32 weights in float32, whose
    relative error is at most (count - 1) * 2^-24 (the recursive-sum
    bound), which the two must agree within. The kron family's weights on
    [1, 10] already put them 1.5e-6 apart."""
    _, jt, pt, _, roots = family
    want = jmsssp.multi_source_sssp(jt, roots[:1])
    got = pmsssp.multi_source_sssp(pt, roots[:1], device="cpu")
    w = pt.wts[pt.cols >= 0].double()
    assert got.delta == float(np.float32(float(w.mean())))
    assert got.delta == pytest.approx(want.delta,
                                      rel=(w.numel() - 1) * 2.0 ** -24)


@pytest.mark.parametrize("delta", [0.3, 1.0, np.inf])
def test_delta_per_column(delta):
    """Other bucket widths: bit-equal to ``repro`` and to the per-root
    runs; under inf (Bellman-Ford) every column takes one bucket."""
    jt, pt = _layouts("kron")
    roots = np.array([0, 5, 17, 200], np.int32)
    for mode in MODES:
        want = jmsssp.multi_source_sssp(jt, roots, delta=delta,
                                        need_parents=True, log_work=True,
                                        config=JConfig(mode=mode))
        got = pmsssp.multi_source_sssp(pt, roots, delta=delta,
                                       need_parents=True, log_work=True,
                                       config=EngineConfig(mode=mode),
                                       device="cpu")
        _assert_same(got, want)
        for i, r in enumerate(roots):
            per = psssp.sssp(pt, int(r), delta=delta, device="cpu")
            assert np.array_equal(got.distances[i], per.distances)
            assert (got.sweeps[i], got.buckets[i]) == (per.sweeps, per.buckets)
        if delta == np.inf:
            assert (got.buckets == 1).all()


# ---------------------------------------------------------------- batching


@pytest.mark.parametrize("mode", MODES)
def test_batch_split_and_padding(mode):
    """batch_size=2 over 5 roots: three batches, the last padded by its
    last root, the padded column dropped; the same as one batch and as
    ``repro``'s split run."""
    jt, pt = _layouts("kron")
    roots = pg500.sample_roots(FAMILIES["kron"](pf, pg), 5, seed=7)
    d = jsssp.default_delta(jt)
    kw = dict(delta=d, need_parents=True, log_work=True)
    whole = pmsssp.multi_source_sssp(pt, roots, config=EngineConfig(mode=mode),
                                     device="cpu", **kw)
    split = pmsssp.multi_source_sssp(pt, roots, batch_size=2,
                                     config=EngineConfig(mode=mode),
                                     device="cpu", **kw)
    want = jmsssp.multi_source_sssp(jt, roots, batch_size=2,
                                    config=JConfig(mode=mode), **kw)
    _assert_same(split, want)
    _assert_same(split, whole, ("distances", "parents", "sweeps", "buckets"))
    assert split.iterations.shape == (3,) and split.work_log.shape[0] == 3


def test_duplicate_roots():
    jt, pt = _layouts("kron")
    d = jsssp.default_delta(jt)
    got = pmsssp.multi_source_sssp(pt, [7, 7, 11], delta=d, need_parents=True,
                                   device="cpu")
    want = jmsssp.multi_source_sssp(jt, [7, 7, 11], delta=d,
                                    need_parents=True)
    _assert_same(got, want, ("distances", "parents", "sweeps", "buckets"))
    assert np.array_equal(got.distances[0], got.distances[1])


@pytest.mark.parametrize("width", [5, 33, 97, 160])
def test_batch_widths(width):
    """Widths past one lane tile and not a multiple of 32, through the
    plain SpMM (the kernel takes any B): bit-equal to ``repro``."""
    jt, pt = _layouts("er")
    roots = np.random.default_rng(width).integers(0, pt.n, width).astype(
        np.int32)
    d = jsssp.default_delta(jt)
    want = jmsssp.multi_source_sssp(jt, roots, delta=d, log_work=True)
    got = pmsssp.multi_source_sssp(pt, roots, delta=d, log_work=True,
                                   device="cpu")
    _assert_same(got, want, ("distances", "sweeps", "buckets", "iterations",
                             "work_log"))


def test_batched_spec_sweeps_the_full_weights():
    """Every sweep of the batch takes the layout's own ``wts`` (no
    per-column views) through the stored-weight SpMM."""
    _, pt = _layouts("kron")
    spec = pmsssp.multi_sssp_spec(pt, 0.5)
    st = spec.init_state(pt.n, torch.tensor([0, 3]), "cpu")
    assert spec.batched and spec.weights(st) is pt.wts
    seen = []
    real = peng.slimsell_spmm

    def spy(sr, tiled, x, *, weights=None, tile_mask=None):
        seen.append(weights is pt.wts and x.shape == (pt.n, 2))
        return real(sr, tiled, x, weights=weights, tile_mask=tile_mask)

    peng.slimsell_spmm = spy
    try:
        res = peng.run_fused(spec, pt, torch.tensor([0, 3]), max_iters=100)
    finally:
        peng.slimsell_spmm = real
    assert seen and all(seen) and len(seen) == res.iterations


# ----------------------------------------------------------------- harness


def test_batched_harness_validates_and_matches_per_root():
    """The batched harness: sweeps and buckets of the per-root harness,
    ``batch=3`` in the summary, every tree validated; the same keys and
    schedule as ``repro``'s batched harness at its delta."""
    rep = pg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=6, seed=3,
                                  batched=True, batch_size=3, device="cpu")
    assert rep.validated == 6 and rep.batched and rep.batch_size == 3
    assert np.isfinite(rep.teps).all() and (rep.teps > 0).all()
    assert "batch=3" in rep.summary()
    per = pg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=6, seed=3,
                                  device="cpu")
    assert not per.batched and "batch=" not in per.summary()
    assert np.array_equal(rep.sweeps, per.sweeps)
    assert np.array_equal(rep.buckets, per.buckets)
    want = jg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=6, seed=3,
                                   batched=True, batch_size=3, validate=False,
                                   need_parents=False)
    again = pg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=6, seed=3,
                                    batched=True, batch_size=3,
                                    delta=want.delta, validate=False,
                                    need_parents=False, device="cpu")
    assert np.array_equal(again.roots, want.roots)
    assert np.array_equal(again.sweeps, want.sweeps)
    assert np.array_equal(again.buckets, want.buckets)
    assert again.batch_size == want.batch_size == 3


# -------------------------------------------------------------- boundaries


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e), str(e)
    return None


def test_boundaries_match_jax_package():
    """Each bad call raises in both packages, the same exception type with
    the same message."""
    jcsr = FAMILIES["path"](jf, jg)
    pcsr = FAMILIES["path"](pf, pg)
    w = jcsr.weights.copy()
    w[0] = -1.0
    jneg = jf.build_slimsell(dataclasses.replace(jcsr, weights=w), C=8,
                             L=32).to_jax()
    pneg = pf.build_slimsell(dataclasses.replace(pcsr, weights=w.copy()), C=8,
                             L=32)
    jt = jf.build_slimsell(jcsr, C=8, L=32).to_jax()
    pt = pf.build_slimsell(pcsr, C=8, L=32)
    junw = jf.build_slimsell(jg.kronecker(6, 4, seed=0), C=8, L=32).to_jax()
    punw = pf.build_slimsell(pg.kronecker(6, 4, seed=0), C=8, L=32)
    J, P = jmsssp.multi_source_sssp, pmsssp.multi_source_sssp
    cases = {
        "unweighted layout": (lambda: J(junw, [0, 1]),
                              lambda: P(punw, [0, 1], device="cpu")),
        "negative weights": (lambda: J(jneg, [0, 1]),
                             lambda: P(pneg, [0, 1], device="cpu")),
        "empty roots": (lambda: J(jt, []), lambda: P(pt, [], device="cpu")),
        "root out of range": (lambda: J(jt, [0, 99]),
                              lambda: P(pt, [0, 99], device="cpu")),
        "batch_size 0": (lambda: J(jt, [0, 1], batch_size=0),
                         lambda: P(pt, [0, 1], batch_size=0, device="cpu")),
        "pull config": (
            lambda: J(jt, [0, 1], config=JConfig(direction="pull")),
            lambda: P(pt, [0, 1], config=EngineConfig(direction="pull"),
                      device="cpu")),
    }
    for name, (jfn, pfn) in cases.items():
        want = _errors(jfn)
        assert want is not None and want[0] is ValueError, name
        assert _errors(pfn) == want, name
    # a bad mode fails where the config is made, in both packages
    with pytest.raises(ValueError, match="unknown mode"):
        JConfig(mode="warp")
    with pytest.raises(ValueError, match="unknown mode"):
        EngineConfig(mode="warp")
    with pytest.raises(ValueError, match="batch_size"):
        pg500.run_graph500_sssp(scale=5, batched=True, batch_size=0,
                                device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_pull_on_the_batched_weighted_spec_raises(mode):
    """The engine refuses pull and auto for the stored-weight batch, and a
    pull sweep with weights."""
    _, pt = _layouts("kron")
    spec = pmsssp.multi_sssp_spec(pt, 0.5)
    run = peng.run_fused if mode == "fused" else peng.run_hostloop
    for direction in ("pull", "auto"):
        with pytest.raises(ValueError, match="push"):
            run(spec, pt, torch.tensor([0, 1]), max_iters=4,
                direction=direction)
    with pytest.raises(ValueError, match="push"):
        peng._sweep(spec, pt, torch.zeros(pt.n, 2), None,
                    torch.ones(pt.n, 2, dtype=torch.bool), pt.wts)
