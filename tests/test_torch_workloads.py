"""The port's k-hop and PageRank against the JAX package's jnp path and the
independent oracles of ``tests/oracles.py``, on the plain (CPU) sweeps;
and the engine's halt at ``max_iters`` for a spec that never converges.

k-hop is discrete: masks, distances and iterations are bit-equal to the
JAX package's and to the networkx cutoff BFS. PageRank sums floats in
another order than the JAX package, so it is held to tolerances, fixed
before any comparison was run:

* ranks within rtol 1e-5, atol 1e-8 of the JAX package's, and within
  ``TOLERANCES["pagerank"]`` of networkx's float64 PageRank;
* iterations equal at ``PAGERANK_PARAMS``;
* residual logs within rtol 1e-4 and an absolute ``2 n ulp(max rank)``:
  a residual is a float32 sum of n differences of ranks, each of which
  may differ by an ulp or two between two summation orders, so the late
  residuals (near ``tol``) differ far beyond 1e-4 relative.

The port's fused and hostloop runs use the same sweep and the same masks,
so they are compared bit for bit. The JAX package's hostloop is not a
reference for PageRank where a layout has a tile of padding alone (see
``test_pagerank_hostloop_with_padding_tiles``).
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core.khop import khop as jkhop
from repro.core.khop import khop_many as jkhop_many
from repro.core.options import EngineConfig as JConfig
from repro.core.pagerank import pagerank as jpagerank
from repro.graphs import generators as jg
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core.khop import khop, khop_many
from repro_torch.core.options import EngineConfig
from repro_torch.core.pagerank import (PAGERANK_MAX_ITERS, pagerank,
                                       pagerank_views)
from repro_torch.graphs import generators as pg

from oracles import (PAGERANK_PARAMS, TOLERANCES, khop_oracle,
                     pagerank_oracle)

MODES = ["fused", "hostloop"]
KS = [0, 1, 2, 3, None]


def path_graph(formats, n: int):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return formats.build_csr(edges, n)


# ``tests/test_workloads.py``'s families, built by either package
FAMILIES = {
    "kron": lambda g, f: g.kronecker(9, 8, seed=3),
    "er": lambda g, f: g.erdos_renyi(256, 6, seed=1),
    "ring": lambda g, f: g.ring_of_cliques(10, 5),
    "star": lambda g, f: g.star(100),
    "path": lambda g, f: path_graph(f, 64),
    "disconnected": lambda g, f: g.two_components(6, 6, seed=0),
}


@functools.lru_cache(maxsize=None)
def family(name):
    """(port CSR, JAX layout, port layout on the CPU), built once."""
    jcsr, pcsr = FAMILIES[name](jg, jf), FAMILIES[name](pg, pf)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    return (pcsr, jf.build_slimsell(jcsr, C=8, L=32).to_jax(),
            pf.build_slimsell(pcsr, C=8, L=32).to_torch("cpu"))


def sample_sources(csr, m=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(csr.n, size=min(m, csr.n), replace=False))


def assert_same_khop(got, want):
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.count, want.count)


# ------------------------------------------------------------------- k-hop


@pytest.mark.parametrize("k", KS, ids=[str(k) for k in KS])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_khop_matches_jax_and_oracle(name, k):
    csr, jt, pt = family(name)
    root = int(np.argmax(csr.deg))
    got = khop(pt, root, k, device="cpu")
    assert_same_khop(got, jkhop(jt, root, k))
    mask_ref, dist_ref = khop_oracle(csr, root, k)
    np.testing.assert_array_equal(got.mask, mask_ref)
    np.testing.assert_array_equal(got.distances, dist_ref)
    assert got.count == mask_ref.sum()


@pytest.mark.parametrize("direction,packed",
                         [("push", False), ("pull", False), ("auto", False),
                          ("push", True)],
                         ids=["push", "pull", "auto", "push-packed"])
@pytest.mark.parametrize("mode", MODES)
def test_khop_modes_directions_packed(mode, direction, packed):
    csr, jt, pt = family("ring")
    root = 3
    for k in (1, 2):
        got = khop(pt, root, k, packed=packed,
                   config=EngineConfig(mode=mode, direction=direction),
                   device="cpu")
        assert_same_khop(got, jkhop(jt, root, k, packed=packed, config=JConfig(
            mode=mode, backend="jnp", direction=direction)))
        mask_ref, dist_ref = khop_oracle(csr, root, k)
        np.testing.assert_array_equal(got.mask, mask_ref)
        np.testing.assert_array_equal(got.distances, dist_ref)


@pytest.mark.parametrize("packed", [False, True])
def test_khop_many_matches_per_root(packed):
    csr, jt, pt = family("er")
    roots = sample_sources(csr, m=12, seed=3)
    res = khop_many(pt, roots, 2, packed=packed, device="cpu")
    assert res.distances.shape == (roots.size, csr.n)
    assert_same_khop(res, jkhop_many(jt, roots, 2, packed=packed))
    for b, root in enumerate(roots):
        mask_ref, dist_ref = khop_oracle(csr, int(root), 2)
        np.testing.assert_array_equal(res.mask[b], mask_ref)
        np.testing.assert_array_equal(res.distances[b], dist_ref)
        np.testing.assert_array_equal(
            res.distances[b], khop(pt, int(root), 2, device="cpu").distances)


@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
def test_khop_many_directions_match_jax(direction):
    csr, jt, pt = family("kron")
    roots = sample_sources(csr, m=12, seed=5)
    for k in (1, 3, None):
        got = khop_many(pt, roots, k, batch_size=5,
                        config=EngineConfig(direction=direction), device="cpu")
        assert_same_khop(got, jkhop_many(
            jt, roots, k, batch_size=5,
            config=JConfig(backend="jnp", direction=direction)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("many", [False, True])
def test_khop_zero_is_the_root_alone(many, packed):
    """k = 0: the engine's loop never runs (no sweep), the ball is the root."""
    csr, _, pt = family("kron")
    roots = sample_sources(csr, m=4, seed=1)
    if many:
        res = khop_many(pt, roots, 0, packed=packed, device="cpu")
        want = np.full((roots.size, csr.n), -1)
        want[np.arange(roots.size), roots] = 0
    else:
        res = khop(pt, int(roots[0]), 0, packed=packed, device="cpu")
        want = np.full(csr.n, -1)
        want[roots[0]] = 0
    np.testing.assert_array_equal(res.distances, want)
    assert np.all(res.iterations == 0) and np.all(res.count == 1)


def test_khop_validation():
    _, jt, pt = family("path")
    for fn, arg in ((khop, 0), (khop_many, [0, 1])):
        with pytest.raises(ValueError, match="k must be"):
            fn(pt, arg, -1, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        jkhop(jt, 0, -1)


# ---------------------------------------------------------------- pagerank


def assert_close_to_jax(got, want, n):
    """The port's PageRank against the JAX package's fused jnp run, within
    the module's stated tolerances."""
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-5, atol=1e-8)
    ulp = float(np.spacing(np.float32(want.ranks.max())))
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=1e-4,
                               atol=2 * n * ulp)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_pagerank_matches_jax_and_networkx(name, mode):
    csr, jt, pt = family(name)
    want = jpagerank(jt, config=JConfig(backend="jnp"), **PAGERANK_PARAMS)
    got = pagerank(pt, config=EngineConfig(mode=mode), device="cpu",
                   **PAGERANK_PARAMS)
    assert got.converged and got.ranks.dtype == np.float32
    assert abs(got.ranks.sum() - 1.0) < 1e-4
    assert_close_to_jax(got, want, csr.n)
    np.testing.assert_allclose(
        got.ranks, pagerank_oracle(csr, damping=PAGERANK_PARAMS["damping"]),
        **TOLERANCES["pagerank"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_pagerank_fused_equals_hostloop(name):
    _, _, pt = family(name)
    fused, host = (pagerank(pt, config=EngineConfig(mode=m), device="cpu")
                   for m in MODES)
    assert fused.iterations == host.iterations
    np.testing.assert_array_equal(fused.ranks, host.ranks)
    np.testing.assert_array_equal(fused.residuals, host.residuals)


@pytest.mark.parametrize("mode", MODES)
def test_pagerank_hostloop_with_padding_tiles(mode):
    """A layout with a tile of padding alone (the chunk of isolated vertices
    of kronecker(9, 8, seed=1)): the port's runs hold networkx's ranks and
    the JAX package's fused run. The JAX package's hostloop pads its tile
    list with repeats of the last kept tile, which the real semiring adds
    again, so it is not the reference here."""
    jcsr, pcsr = jg.kronecker(9, 8, seed=1), pg.kronecker(9, 8, seed=1)
    pt = pf.build_slimsell(pcsr, C=8, L=32).to_torch("cpu")
    cols = pt.cols.reshape(pt.n_tiles, -1)
    assert bool((cols < 0).all(dim=1).any())
    jt = jf.build_slimsell(jcsr, C=8, L=32).to_jax()
    want = jpagerank(jt, config=JConfig(backend="jnp"), **PAGERANK_PARAMS)
    got = pagerank(pt, config=EngineConfig(mode=mode), device="cpu",
                   **PAGERANK_PARAMS)
    assert_close_to_jax(got, want, pcsr.n)
    np.testing.assert_allclose(
        got.ranks, pagerank_oracle(pcsr, damping=PAGERANK_PARAMS["damping"]),
        **TOLERANCES["pagerank"])


def test_pagerank_result_shape():
    _, _, pt = family("ring")
    res = pagerank(pt, device="cpu", **PAGERANK_PARAMS)
    # residual history: one entry per sweep, at or below tol at the end
    assert res.residuals.shape == (res.iterations,)
    assert res.residuals[-1] <= PAGERANK_PARAMS["tol"]
    assert np.all(res.residuals[:-1] > 0)


def test_pagerank_damping_sweep():
    # teleport-heavy ranks flatten toward uniform; walk-heavy ranks spread
    csr, jt, pt = family("star")
    flat = pagerank(pt, damping=0.05, tol=1e-6, device="cpu").ranks
    sharp = pagerank(pt, damping=0.9, tol=1e-6, device="cpu").ranks
    assert flat.std() < sharp.std()
    for a in (0.05, 0.9):
        got = pagerank(pt, damping=a, tol=1e-6, device="cpu")
        np.testing.assert_allclose(got.ranks, pagerank_oracle(csr, damping=a),
                                   **TOLERANCES["pagerank"])
        want = jpagerank(jt, damping=a, tol=1e-6,
                         config=JConfig(backend="jnp"))
        np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-5,
                                   atol=1e-8)


def test_pagerank_validation():
    _, jt, pt = family("path")
    for fn, t, kw in ((pagerank, pt, {"device": "cpu"}), (jpagerank, jt, {})):
        with pytest.raises(ValueError, match="damping"):
            fn(t, damping=1.0, **kw)
        with pytest.raises(ValueError, match="tol"):
            fn(t, tol=0.0, **kw)
    with pytest.raises(ValueError, match="push-only"):
        pagerank(pt, config=EngineConfig(direction="pull"), device="cpu")


def test_pagerank_unconverged_at_max_iters():
    # max_iters below the convergence point: the engine's k <= max_iters
    # guard is the only exit, and the result says so
    _, jt, pt = family("ring")
    for mode in MODES:
        res = pagerank(pt, tol=1e-30, max_iters=3,
                       config=EngineConfig(mode=mode), device="cpu")
        assert res.iterations == 3 and not res.converged
        assert res.residuals.shape == (3,)
    want = jpagerank(jt, tol=1e-30, max_iters=3,
                     config=JConfig(backend="jnp"))
    np.testing.assert_allclose(res.ranks, want.ranks, rtol=1e-5, atol=1e-8)
    assert PAGERANK_MAX_ITERS == 256


def test_pagerank_views_match_jax():
    from repro.core.pagerank import pagerank_views as jviews
    deg = np.array([0, 1, 3, 0, 7, 2], np.int64)
    inv_deg, dangling = pagerank_views(torch.from_numpy(deg))
    j_inv, j_dangling = jviews(deg)
    np.testing.assert_array_equal(inv_deg.numpy(), np.asarray(j_inv))
    np.testing.assert_array_equal(dangling.numpy(), np.asarray(j_dangling))


# -------------------------------------------------- engine regressions


def _osc_update(state, y, k):
    # period-2 flip: no fixpoint exists, cont never goes False
    return dict(state, x=1.0 - state["x"]), torch.tensor(True)


OSCILLATOR_SPEC = peng.FixpointSpec(
    name="test/oscillator",
    sr_name="real",
    init_state=lambda n, arg, device: {
        "x": torch.zeros(n, dtype=torch.float32, device=device)},
    frontier=lambda state, k: state["x"],
    source_bits=lambda state, k: torch.ones(state["x"].shape[0],
                                            dtype=torch.bool),
    not_final=lambda state: torch.ones(state["x"].shape[0], dtype=torch.bool),
    update=_osc_update,
    host_bits=lambda state, k, need_sb, need_nf:
        (np.ones(state["x"].shape[0], bool), None),
)


@pytest.mark.parametrize("run", [peng.run_fused, peng.run_hostloop],
                         ids=["fused", "hostloop"])
def test_nonmonotone_spec_halts_at_max_iters(run):
    # the contract PageRank leans on: a spec whose cont never drops still
    # terminates, at exactly max_iters sweeps
    _, _, pt = family("path")
    res = run(OSCILLATOR_SPEC, pt, 0, max_iters=7)
    assert res.iterations == 7
    np.testing.assert_array_equal(res.state["x"].numpy(),
                                  np.ones(pt.n, np.float32))
