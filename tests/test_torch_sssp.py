"""The port's weighted SSSP (delta-stepping) against the JAX package's jnp
path, on the plain (CPU) sweeps: the min-plus stored-weight SpMV, ``sssp``
in both engine modes, ``sssp_parents``, the Dijkstra oracle, the SSSP tree
validator and the Graph500 SSSP harness.

Where sweeps, buckets, work logs or parents are compared, the JAX package's
default delta is passed to both explicitly: the port's mean weight differs
from it in the last bits (``default_delta``), and a different delta may
move a distance across a bucket boundary. The two defaults are compared on
their own, with rtol 1e-6. All other comparisons are exact: a min of float32
sums is independent of the order it is taken in.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph500 as jg500
from repro.core import bfs as jbfs
from repro.core import formats as jf
from repro.core import multi_bfs as jmulti
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.core import sssp as jsssp
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch import convert
from repro_torch import graph500 as pg500
from repro_torch.configs import sssp_graph500 as pcfg
from repro_torch.core import bfs as pbfs
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core import multi_bfs as pmulti
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.core import sssp as psssp
from repro_torch.core.options import EngineConfig
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

LOW, HIGH = 1.0 / 256.0, 1.0  # Graph500 SSSP weights
GRAPHS = {
    "kron": lambda g: g.with_random_weights(g.kronecker(8, 16, seed=1),
                                            low=LOW, high=HIGH, seed=2),
    "two_components": lambda g: g.with_random_weights(
        g.two_components(7, 6, seed=0), low=LOW, high=HIGH, seed=9),
}
ROOT = 3


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    """(name, JAX layout, port layout on the CPU, weighted CSR)."""
    jcsr, pcsr = GRAPHS[request.param](jg), GRAPHS[request.param](pg)
    assert np.array_equal(jcsr.weights, pcsr.weights)
    jt = jf.build_slimsell(jcsr, C=8, L=16).to_jax()
    pt = pf.build_slimsell(pcsr, C=8, L=16).to_torch("cpu")
    return request.param, jt, pt, pcsr


def _frontier(n, rng):
    """Float32 distances on a few vertices, +inf elsewhere."""
    x = rng.uniform(0.0, 4.0, n).astype(np.float32)
    x[rng.random(n) < 0.6] = np.inf
    return x


# ------------------------------------------------------------ the sweep


def test_weight_constants_match_jax_package():
    from repro.configs import sssp_graph500 as jcfg
    assert (pcfg.WEIGHT_LOW, pcfg.WEIGHT_HIGH) == (jcfg.WEIGHT_LOW,
                                                  jcfg.WEIGHT_HIGH) == (LOW, HIGH)


@pytest.mark.parametrize("view", ["full", "light", "heavy"])
@pytest.mark.parametrize("masked", [False, True])
def test_minplus_spmv_matches_jnp(graph, masked, view):
    """The stored-weight sweep, bit-equal: the front door and the plain
    version against ``repro.core.spmv.slimsell_spmv(MINPLUS, weights=)``,
    over the full ``wts`` and its light / heavy views."""
    _, jt, pt, _ = graph
    rng = np.random.default_rng([masked, len(view)])
    x = _frontier(pt.n, rng)
    views = psssp.weight_views(pt.wts, psssp.default_delta(pt))
    w = {"full": pt.wts, "light": views[0], "heavy": views[1]}[view]
    mask = None
    if masked:
        keep_chunk = rng.random(pt.n_chunks) < 0.65
        mask = (rng.random(pt.n_tiles) < 0.5) \
            & keep_chunk[np.asarray(pt.row_block)]
    want = jspmv.slimsell_spmv(jsr.MINPLUS, jt, jnp.asarray(x),
                               weights=jnp.asarray(w.numpy()),
                               tile_mask=None if mask is None
                               else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    got = pspmv.slimsell_spmv(psr.MINPLUS, pt, torch.from_numpy(x), weights=w,
                              tile_mask=tm)
    plain = pspmv.spmv_plain(psr.MINPLUS, pt, torch.from_numpy(x), tm, w)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(plain.numpy(), np.asarray(want))


def test_padding_slots_stay_inert(graph):
    """A padding slot's weight is never read: setting every one to -1000
    changes nothing, in the front door and in the plain version."""
    _, _, pt, _ = graph
    x = torch.from_numpy(_frontier(pt.n, np.random.default_rng(5)))
    poisoned = torch.where(pt.cols < 0, -1000.0, pt.wts)
    want = pspmv.slimsell_spmv(psr.MINPLUS, pt, x, weights=pt.wts)
    assert torch.equal(pspmv.slimsell_spmv(psr.MINPLUS, pt, x,
                                           weights=poisoned), want)


def test_minplus_needs_weights(graph):
    _, jt, pt, _ = graph
    x = torch.zeros(pt.n)
    with pytest.raises(ValueError, match="stored weights"):
        jspmv.slimsell_spmv(jsr.MINPLUS, jt, jnp.zeros(pt.n))
    with pytest.raises(ValueError, match="stored weights"):
        pspmv.slimsell_spmv(psr.MINPLUS, pt, x)
    with pytest.raises(ValueError, match="stored weights"):
        pspmv.slimsell_spmm(psr.MINPLUS, pt, x[:, None])
    with pytest.raises(ValueError, match="stored weights"):
        pspmv.slimsell_pull(psr.MINPLUS, pt, x,
                            row_mask=torch.ones(pt.n, dtype=torch.bool))
    with pytest.raises(ValueError, match="minplus"):
        ops.spmv(psr.TROPICAL, pt, x, weights=pt.wts)
    with pytest.raises(ValueError, match="weights must be"):
        ops.spmv(psr.MINPLUS, pt, x, weights=pt.wts[:1])


def test_weights_with_a_pull_sweep_raise(graph):
    _, _, pt, _ = graph
    spec = psssp.sssp_spec(pt, 0.5)
    with pytest.raises(ValueError, match="push"):
        peng.run_fused(spec, pt, ROOT, max_iters=4, direction="pull")
    with pytest.raises(ValueError, match="push"):
        peng.run_hostloop(spec, pt, ROOT, max_iters=4, direction="auto")
    with pytest.raises(ValueError, match="push"):
        peng._sweep(spec, pt, torch.zeros(pt.n), None,
                    torch.ones(pt.n, dtype=torch.bool), pt.wts)


# ------------------------------------------------------------------ sssp


@pytest.mark.parametrize("slimwork", [True, False])
@pytest.mark.parametrize("delta", ["jax_default", "inf", "0.05"])
@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_sssp_matches_jax_package(graph, mode, delta, slimwork):
    """Distances, parents, sweeps, buckets and the work log, bit-equal."""
    _, jt, pt, _ = graph
    d = jsssp.default_delta(jt) if delta == "jax_default" else float(delta)
    want = jsssp.sssp(jt, ROOT, delta=d, need_parents=True, log_work=True,
                      slimwork=slimwork, config=JConfig(mode=mode))
    got = psssp.sssp(pt, ROOT, delta=d, need_parents=True, log_work=True,
                     slimwork=slimwork, config=EngineConfig(mode=mode),
                     device="cpu")
    assert got.distances.dtype == np.float32
    assert np.array_equal(got.distances, want.distances)
    assert np.array_equal(got.parents, want.parents)
    assert (got.sweeps, got.buckets, got.delta) == \
        (want.sweeps, want.buckets, want.delta)
    assert np.array_equal(got.work_log, want.work_log)
    if delta == "inf":
        assert got.buckets == 1  # Bellman-Ford


@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_sssp_max_iters_matches_jax_package(graph, mode):
    _, jt, pt, _ = graph
    d = jsssp.default_delta(jt)
    want = jsssp.sssp(jt, ROOT, delta=d, max_iters=2, log_work=True,
                      config=JConfig(mode=mode))
    got = psssp.sssp(pt, ROOT, delta=d, max_iters=2, log_work=True,
                     config=EngineConfig(mode=mode), device="cpu")
    assert got.sweeps == want.sweeps == 2
    assert got.buckets == want.buckets
    assert np.array_equal(got.distances, want.distances)
    assert np.array_equal(got.work_log, want.work_log)
    assert not np.isfinite(got.distances).all()  # cut short


def test_default_delta_matches_jax_package(graph):
    _, jt, pt, _ = graph
    want = jsssp.default_delta(jt)
    got = psssp.default_delta(pt)
    assert got == pytest.approx(want, rel=1e-6)
    # float32, like the JAX package's, and cached on the layout
    assert got == float(np.float32(got))
    assert pt._weight_stats_cache[1] == got


def test_sssp_matches_dijkstra(graph):
    _, _, pt, csr = graph
    res = psssp.sssp(pt, ROOT, need_parents=True, device="cpu")
    pg500.validate_sssp_tree(csr, ROOT, res.distances, res.parents,
                             d_ref=_scipy(csr, ROOT))
    if csr.n == 256:
        return
    assert np.isinf(res.distances).any()  # the other component


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


def test_errors_match_jax_package():
    """Each bad call raises the same exception type in both packages."""
    jcsr = jg.with_random_weights(jg.kronecker(6, 4, seed=0), seed=1)
    pcsr = pg.with_random_weights(pg.kronecker(6, 4, seed=0), seed=1)
    w = jcsr.weights.copy()
    w[0] = -1.0
    jneg = dataclasses.replace(jcsr, weights=w)
    pneg = dataclasses.replace(pcsr, weights=w.copy())
    cases = {
        "negative weights": (
            lambda: jsssp.sssp(jf.build_slimsell(jneg, C=8, L=16).to_jax(), 0),
            lambda: psssp.sssp(pf.build_slimsell(pneg, C=8, L=16), 0,
                               device="cpu")),
        "unweighted layout": (
            lambda: jsssp.sssp(jf.build_slimsell(jg.kronecker(6, 4, seed=0),
                                                 C=8, L=16).to_jax(), 0),
            lambda: psssp.sssp(pf.build_slimsell(pg.kronecker(6, 4, seed=0),
                                                 C=8, L=16), 0, device="cpu")),
        "pull config": (
            lambda: jsssp.sssp(jf.build_slimsell(jcsr, C=8, L=16).to_jax(), 0,
                               config=JConfig(direction="pull")),
            lambda: psssp.sssp(pf.build_slimsell(pcsr, C=8, L=16), 0,
                               config=EngineConfig(direction="pull"),
                               device="cpu")),
        "root out of range": (
            lambda: jsssp.sssp(jf.build_slimsell(jcsr, C=8, L=16).to_jax(), 64),
            lambda: psssp.sssp(pf.build_slimsell(pcsr, C=8, L=16), 64,
                               device="cpu")),
        "non-positive delta": (
            lambda: jsssp.sssp(jf.build_slimsell(jcsr, C=8, L=16).to_jax(), 0,
                               delta=0.0),
            lambda: psssp.sssp(pf.build_slimsell(pcsr, C=8, L=16), 0,
                               delta=0.0, device="cpu")),
        "minplus to bfs": (
            lambda: jbfs.bfs(jf.build_slimsell(jcsr, C=8, L=16).to_jax(), 0,
                             "minplus"),
            lambda: pbfs.bfs(pf.build_slimsell(pcsr, C=8, L=16), 0, "minplus",
                             device="cpu")),
        "minplus to multi_source_bfs": (
            lambda: jmulti.multi_source_bfs(
                jf.build_slimsell(jcsr, C=8, L=16).to_jax(), [0, 1], "minplus"),
            lambda: pmulti.multi_source_bfs(
                pf.build_slimsell(pcsr, C=8, L=16), [0, 1], "minplus",
                device="cpu")),
    }
    for name, (jfn, pfn) in cases.items():
        want = _errors(jfn)
        assert want is not None, name
        assert _errors(pfn) is want, name


# --------------------------------------------------------- oracle, validator


def _scipy(csr, root):
    A = csr_matrix((csr.weights, csr.indices, csr.indptr), shape=(csr.n, csr.n))
    return dijkstra(A, indices=root, directed=True)


def test_dijkstra_reference_matches_scipy(graph):
    _, _, _, csr = graph
    for root in (0, ROOT, int(np.argmax(csr.deg))):
        got = psssp.dijkstra_reference(csr, root)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, _scipy(csr, root), rtol=1e-6)
    with pytest.raises(ValueError, match="weighted"):
        psssp.dijkstra_reference(pg.kronecker(5, 4, seed=0), 0)


def test_validate_sssp_tree_rejects_bad_trees():
    csr = GRAPHS["kron"](pg)
    pt = pf.build_slimsell(csr, C=8, L=16).to_torch("cpu")
    res = psssp.sssp(pt, ROOT, need_parents=True, device="cpu")
    d, p = res.distances, res.parents
    pg500.validate_sssp_tree(csr, ROOT, d, p)
    far = int(np.argmax(np.where(np.isfinite(d), d, -1)))
    bad_d = d.copy()
    bad_d[far] += 0.25
    with pytest.raises(AssertionError, match="Dijkstra"):
        pg500.validate_sssp_tree(csr, ROOT, bad_d, p)
    # a parent over a real edge that is not tight, then over no edge at all
    v, u = next((v, int(u)) for v in np.nonzero(np.isfinite(d))[0]
                for u, w in zip(csr.neighbors(v),
                                csr.weights[csr.indptr[v]:csr.indptr[v + 1]])
                if not np.isclose(d[u] + w, d[v], rtol=1e-4, atol=1e-5))
    bad_p = p.copy()
    bad_p[v] = u
    with pytest.raises(AssertionError, match="non-tight"):
        pg500.validate_sssp_tree(csr, ROOT, d, bad_p)
    bad_p[v] = next(x for x in range(csr.n)
                    if x not in set(csr.neighbors(v).tolist()))
    with pytest.raises(AssertionError, match="not in graph"):
        pg500.validate_sssp_tree(csr, ROOT, d, bad_p)


def test_sssp_parents_match_jax_package(graph):
    """The weighted DP pass alone, on the same distances, with the same
    tolerance test and the positive-weight bonus."""
    _, jt, pt, _ = graph
    d = jsssp.sssp(jt, ROOT, delta=0.3).distances
    want = jsssp.sssp_parents(jt, jnp.asarray(d), jnp.asarray(ROOT, jnp.int32))
    got = psssp.sssp_parents(pt, torch.from_numpy(d.copy()), ROOT)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~np.isfinite(d)] == -1).all()


# ------------------------------------------------------ harness, convert


def test_run_graph500_sssp_validates_and_matches_jax_package():
    got = pg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=4, seed=3,
                                  device="cpu")
    assert got.validated == 4 and got.roots.size == 4
    assert np.isfinite(got.teps).all() and (got.teps > 0).all()
    assert "graph500-sssp" in got.summary() and "validated=4" in got.summary()
    # the same keys, and with the JAX package's delta the same schedule
    want = jg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=4, seed=3,
                                   need_parents=False, validate=False)
    again = pg500.run_graph500_sssp(scale=8, edge_factor=8, n_roots=4, seed=3,
                                    delta=want.delta, validate=False,
                                    need_parents=False, device="cpu")
    assert np.array_equal(got.roots, want.roots)
    assert np.array_equal(again.sweeps, want.sweeps)
    assert np.array_equal(again.buckets, want.buckets)
    assert (got.n, got.m) == (want.n, want.m)
    with pytest.raises(ValueError, match="weighted CSR"):
        pg500.run_graph500_sssp(scale=5, csr=pg.kronecker(5, 4, seed=0),
                                device="cpu")


@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_jax_built_layout_carried_across_gives_the_same_sssp(graph, mode):
    _, jt, pt, _ = graph
    carried = convert.tiled_from_arrays(
        {k: getattr(jt, k) for k in convert.LAYOUT_ARRAYS},
        {k: getattr(jt, k) for k in convert.LAYOUT_META}, device="cpu")
    assert carried.wts is not None and torch.equal(carried.wts, pt.wts)
    d = jsssp.default_delta(jt)
    kw = dict(delta=d, need_parents=True, log_work=True,
              config=EngineConfig(mode=mode), device="cpu")
    a, b = psssp.sssp(carried, ROOT, **kw), psssp.sssp(pt, ROOT, **kw)
    want = jsssp.sssp(jt, ROOT, delta=d, need_parents=True, log_work=True,
                      config=JConfig(mode=mode))
    for r in (a, b):
        assert np.array_equal(r.distances, want.distances)
        assert np.array_equal(r.parents, want.parents)
        assert np.array_equal(r.work_log, want.work_log)
        assert (r.sweeps, r.buckets) == (want.sweeps, want.buckets)
