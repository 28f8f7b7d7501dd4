"""The card checks of ``chip_smoke.py`` that decide a run, on synthetic
results here: the PageRank sweep-count rule (``pagerank_close``, its
bound ``2 sum_i ulp(r_i)`` over the plain ranks), the
betweenness bounds (``bc_close``), and the float64 Brandes the card's
betweenness is held to (``brandes_f64``) against the plain-python oracle
of ``tests/oracles.py``.
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import formats as pf
from repro_torch.graphs import generators as pg

from oracles import betweenness_oracle

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ PageRank


def star_ranks(n=64, hub=0.46):
    """Ranks shaped as star(n)'s: the hub holds ``hub`` of the mass."""
    r = np.full(n, (1.0 - hub) / (n - 1), np.float32)
    r[0] = hub
    return r


def pr_result(ranks, iterations, resid_at, k):
    """A PageRank result of ``iterations`` sweeps whose residual at sweep
    ``k`` is ``resid_at`` (the others far above tol)."""
    residuals = np.full(iterations, 1e-3, np.float32)
    residuals[k - 1] = resid_at
    return types.SimpleNamespace(ranks=ranks, iterations=iterations,
                                 residuals=residuals)


TOL = 1e-6
# (kernel sweeps, plain sweeps, the plain residual at the shorter run's last
# sweep, ranks, passes?)
PR_CASES = {
    # star(64) on the card: the kernel stops at 89, the plain sweeps at 90
    # with 1.0347e-6 at 89 (3.5% of tol away; the bound is 3.8e-6)
    "star64-89-vs-90": (89, 90, 1.0347e-6, star_ranks(), True),
    "star64-90-vs-89": (90, 89, 8.866e-7, star_ranks(), True),
    "equal": (16, 16, 6.5e-7, star_ranks(), True),
    # one apart, the residual 1.1e-5 from tol: far outside 1.77e-7
    "one-apart-far": (40, 41, 1.2e-5, star_ranks(), False),
    # 1000 vertices of rank 1e-3: bound 2.3e-7, the residual 5e-7 from tol
    "one-apart-many-small-ranks": (20, 21, 1.5e-6,
                                   np.full(1000, 1e-3, np.float32), False),
    "two-apart": (88, 90, TOL, star_ranks(), False),
    # 1e-6 from tol: inside the old 2 n ulp(max rank) (3.8e-6), outside
    # 2 sum ulp(r_i) (1.77e-7)
    "star64-old-bound-only": (89, 90, 2e-6, star_ranks(), False),
    # a scale-20-like result: n = 2^20, a hub at 1e-3, the rest near 1/n;
    # 2 sum ulp(r_i) 1.2e-7, while 2 n ulp(max rank) is 2.4e-4
    "scale20-inside": (17, 18, TOL + 1e-7, None, True),
    "scale20-old-bound-only": (17, 18, TOL + 5e-6, None, False),
}


def scale20_ranks():
    n = 2 ** 20
    r = np.full(n, (1.0 - 1e-3) / (n - 1), np.float32)
    r[0] = 1e-3
    return r


@pytest.mark.parametrize("case", sorted(PR_CASES))
def test_pagerank_close_sweep_rule(smoke, case):
    got_k, ref_k, resid, ranks, passes = PR_CASES[case]
    if ranks is None:
        ranks = scale20_ranks()
    k = min(got_k, ref_k)
    got = pr_result(ranks, got_k, 1e-6, k)
    ref = pr_result(ranks, ref_k, resid, k)
    if not passes:
        with pytest.raises(AssertionError, match="sweeps, plain"):
            smoke.pagerank_close(got, ref, TOL, case)
        return
    l1, one_apart = smoke.pagerank_close(got, ref, TOL, case)
    assert l1 == 0.0
    assert (one_apart is None) == (got_k == ref_k)


def test_pagerank_close_ranks_and_bound(smoke):
    ref = pr_result(star_ranks(), 90, 1.0347e-6, 89)
    # the worked example: 2 * (ulp(0.46) + 63 * ulp(0.54 / 63))
    # = 2 * (2^-25 + 63 * 2^-30); the looser 2 * 64 * ulp(0.46) beside it
    assert smoke.PR_RESID_ULPS == 2
    assert smoke.pagerank_resid_bound(ref) == pytest.approx(
        2 * (2.0 ** -25 + 63 * 2.0 ** -30), rel=1e-12)
    assert smoke.pagerank_resid_bound(ref) == pytest.approx(1.769e-7,
                                                            rel=1e-3)
    assert smoke.pagerank_resid_bound_max(ref) == pytest.approx(3.815e-6,
                                                                rel=1e-3)
    big = pr_result(scale20_ranks(), 18, TOL, 17)
    assert smoke.pagerank_resid_bound(big) < 2e-7
    assert smoke.pagerank_resid_bound_max(big) > 1e-4
    assert smoke.pagerank_gap(pr_result(star_ranks(), 89, TOL, 89), ref,
                              TOL) == pytest.approx(3.47e-8, rel=1e-3)
    off = star_ranks()
    off[1] *= 1.01   # outside rtol 1e-4: the ranks' bounds still raise
    with pytest.raises(AssertionError, match="ranks not within"):
        smoke.pagerank_close(pr_result(off, 90, 1e-6, 89), ref, TOL, "ranks")
    assert not hasattr(smoke, "PR_TOL_REL")


# --------------------------------------------------------- betweenness


def mixed_graph():
    edges = [(i, i + 1) for i in range(9)] + [(10, j) for j in range(11, 16)]
    return pf.build_csr(np.asarray(edges, np.int64), 20)


F64_GRAPHS = {
    "ring": (lambda: pg.ring_of_cliques(10, 5), None),
    "path": (lambda: pf.build_csr(np.stack([np.arange(63), np.arange(1, 64)],
                                           axis=1), 64), None),
    "disconnected": (lambda: pg.two_components(6, 6, seed=0), None),
    "kron": (lambda: pg.kronecker(8, 6, seed=3), [5, 17, 100, 200, 255]),
    "mixed": (mixed_graph, [16, 0, 4, 10, 0, 11, 19]),
}


@pytest.mark.parametrize("name", sorted(F64_GRAPHS))
def test_brandes_f64_matches_oracle(smoke, name):
    make, sources = F64_GRAPHS[name]
    csr = make()
    roots = np.arange(csr.n) if sources is None else np.asarray(sources)
    d, sigma, delta = smoke.brandes_f64(csr, roots)
    np.testing.assert_allclose(smoke.bc_from_delta(delta, roots),
                               betweenness_oracle(csr, sources),
                               rtol=1e-12, atol=1e-9)
    # given the depths, the same counts and dependencies
    _, sigma2, delta2 = smoke.brandes_f64(csr, roots, d=d)
    np.testing.assert_array_equal(sigma2, sigma)
    np.testing.assert_array_equal(delta2, delta)


def bc_run(scores, forward, iterations=None):
    """A betweenness result and its probe: ``forward`` the (d, sigma,
    sweeps) of each batch."""
    res = types.SimpleNamespace(
        scores=np.asarray(scores, np.float64),
        iterations=iterations if iterations is not None
        else 2 * sum(f[2] for f in forward))
    return res, {"forward": forward}


def bc_forward(sigma, sweeps=3):
    sigma = torch.tensor(sigma, dtype=torch.float32)
    return (torch.zeros(sigma.shape, dtype=torch.int32), sigma, sweeps)


BIG = float(2 ** 24)
SCORES = np.array([0.0, 1.0, 250.0, 1000.0])
# (kernel's sigma, kernel's scores, passes?) against plain sigma
# [1, 3, 2^24 * 3, 2^25] and SCORES
BC_CASES = {
    "equal": ([1.0, 3.0, BIG * 3, BIG * 2], SCORES, True),
    "past-2^24-within-1e-5": ([1.0, 3.0, BIG * 3 + 16, BIG * 2 - 32],
                              SCORES, True),
    "past-2^24-beyond-1e-5": ([1.0, 3.0, BIG * 3 + 1024, BIG * 2], SCORES,
                              False),
    "below-2^24-one-apart": ([1.0, 4.0, BIG * 3, BIG * 2], SCORES, False),
    "scores-within-1e-4": ([1.0, 3.0, BIG * 3, BIG * 2],
                           SCORES * (1 + 5e-5) + 1e-4, True),
    "scores-beyond-1e-4": ([1.0, 3.0, BIG * 3, BIG * 2],
                           SCORES * (1 + 3e-4), False),
}


@pytest.mark.parametrize("case", sorted(BC_CASES))
def test_bc_close_bounds(smoke, case):
    sigma, scores, passes = BC_CASES[case]
    ref = bc_run(SCORES, [bc_forward([1.0, 3.0, BIG * 3, BIG * 2])])
    got = bc_run(scores, [bc_forward(sigma)])
    if passes:
        errs = smoke.bc_close(got, ref, case)
        assert errs["sigma_rel_err"] <= smoke.BC_SIGMA_RTOL
    else:
        with pytest.raises(AssertionError, match="betweenness"):
            smoke.bc_close(got, ref, case)


def test_bc_close_sweeps_and_depths(smoke):
    ref = bc_run(SCORES, [bc_forward([1.0, 3.0], sweeps=3)])
    with pytest.raises(AssertionError, match="sweeps"):
        smoke.bc_close(bc_run(SCORES, [bc_forward([1.0, 3.0], sweeps=4)]),
                       ref, "sweeps")
    d, sigma, k = bc_forward([1.0, 3.0])
    with pytest.raises(AssertionError, match="depths"):
        smoke.bc_close(bc_run(SCORES, [(d + 1, sigma, k)],
                              ref[0].iterations), ref, "depths")
