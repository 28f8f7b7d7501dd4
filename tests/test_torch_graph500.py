"""The port's Graph500 harness against the JAX package's: the same search
keys, every tree validated, on the plain (CPU) path."""
import numpy as np
import pytest

from repro import graph500 as jg500
from repro.graphs.generators import kronecker as jkron
from repro_torch import graph500 as pg500
from repro_torch.graphs.generators import kronecker as pkron


def test_run_graph500_matches_jax_package():
    want = jg500.run_graph500(scale=8, edge_factor=16, n_roots=64, batch_size=16)
    got = pg500.run_graph500(scale=8, edge_factor=16, n_roots=64, batch_size=16,
                             device="cpu")
    assert np.array_equal(got.roots, want.roots)
    assert got.validated == want.validated == got.roots.size == 64
    assert (got.n, got.m) == (want.n, want.m)
    assert got.batch_seconds.size == 4 and (got.teps > 0).all()
    assert "validated=64" in got.summary()


def test_sample_roots_match_jax_package():
    a, b = jkron(9, 4, seed=3), pkron(9, 4, seed=3)
    assert np.array_equal(jg500.sample_roots(a, 32), pg500.sample_roots(b, 32))


def test_validate_bfs_tree_rejects_bad_trees():
    csr = pkron(7, 8, seed=1)
    root = int(pg500.sample_roots(csr, 1)[0])
    d, p = pg500.bfs_traditional(csr, root)
    pg500.validate_bfs_tree(csr, root, d, p)
    reached = np.nonzero(d > 1)[0][0]
    bad_d = d.copy()
    bad_d[reached] += 1
    with pytest.raises(AssertionError, match="oracle"):
        pg500.validate_bfs_tree(csr, root, bad_d, p)
    bad_p = p.copy()
    bad_p[reached] = root
    with pytest.raises(AssertionError, match="levels"):
        pg500.validate_bfs_tree(csr, root, d, bad_p)


def test_run_graph500_refuses_a_graph_of_another_scale():
    csr = pkron(6, 4, seed=1)
    with pytest.raises(ValueError, match="scale 7"):
        pg500.run_graph500(scale=7, csr=csr, device="cpu")
    other = pg500.build_slimsell(pkron(5, 4, seed=1), C=8, L=16)
    with pytest.raises(ValueError, match="tiled has n=32"):
        pg500.run_graph500(scale=6, csr=csr, tiled=other, device="cpu")


# ------------------------------------------ both harnesses through a session
#
# The harnesses run each batch through a GraphSession in both packages
# (``bfs_many``, ``sssp``); the reports keep no distances, so the tests
# record what the sessions returned. Bounds: roots, validated counts,
# distances, parents, sweeps, buckets and deltas bit-equal, dtypes
# included. The SSSP runs pass the JAX package's default delta to both:
# the port sums the mean weight in float64, the JAX package in float32.


def recorded(monkeypatch, cls, name):
    """Keep what ``cls.name`` returns during the test."""
    out = []
    orig = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        res = orig(self, *args, **kwargs)
        out.append(res)
        return res

    monkeypatch.setattr(cls, name, wrapper)
    return out


def flat(calls):
    """The QueryResults of the recorded calls, in order."""
    return [r for c in calls for r in (c if isinstance(c, list) else [c])]


def assert_same_results(got, want):
    assert len(got) == len(want)
    for p, j in zip(got, want):
        assert (p.status, p.sweeps, p.buckets, p.delta) == \
            (j.status, j.sweeps, j.buckets, j.delta)
        jd, jp = np.asarray(j.values), np.asarray(j.parents)
        assert p.values.dtype == jd.dtype and p.parents.dtype == jp.dtype
        np.testing.assert_array_equal(p.values, jd)
        np.testing.assert_array_equal(p.parents, jp)


@pytest.mark.parametrize("direction", ["push", "pull"])
def test_run_graph500_through_session_matches_jax_and_front_door(
        monkeypatch, direction):
    from repro.core.options import EngineConfig as JConfig
    from repro.serving import GraphSession as JSession
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.options import EngineConfig
    from repro_torch.serving import GraphSession
    jcalls = recorded(monkeypatch, JSession, "bfs_many")
    pcalls = recorded(monkeypatch, GraphSession, "bfs_many")
    csr = pkron(8, 16, seed=1)
    want = jg500.run_graph500(scale=8, edge_factor=16, n_roots=24,
                              batch_size=8, config=JConfig(
                                  backend="jnp", direction=direction))
    tiled = pg500.build_slimsell(csr, C=8, L=128, sigma=csr.n).to_torch("cpu")
    got = pg500.run_graph500(scale=8, edge_factor=16, n_roots=24,
                             batch_size=8, csr=csr, tiled=tiled,
                             direction=direction, device="cpu")
    assert np.array_equal(got.roots, want.roots)
    assert got.validated == want.validated == 24
    assert (got.n, got.m, got.direction) == (want.n, want.m, direction)
    assert got.batch_seconds.size == 3 and (got.teps > 0).all()
    assert_same_results(flat(pcalls), flat(jcalls))
    results = flat(pcalls)
    for start in range(0, 24, 8):
        door = multi_source_bfs(tiled, got.roots[start:start + 8],
                                need_parents=True,
                                config=EngineConfig(direction=direction),
                                device="cpu")
        for i, r in enumerate(results[start:start + 8]):
            np.testing.assert_array_equal(r.distances, door.distances[i])
            np.testing.assert_array_equal(r.parents, door.parents[i])
            assert r.sweeps == door.iterations[0]


@pytest.mark.parametrize("batched", [False, True])
def test_run_graph500_sssp_through_session_matches_jax_and_front_door(
        monkeypatch, batched):
    from repro.core import formats as jf
    from repro.core.sssp import default_delta as jdefault_delta
    from repro.graphs.generators import with_random_weights as jweights
    from repro.serving import GraphSession as JSession
    from repro_torch.configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.sssp import sssp
    from repro_torch.graphs.generators import with_random_weights
    from repro_torch.serving import GraphSession
    jcsr = jweights(jkron(8, 16, seed=1), low=WEIGHT_LOW, high=WEIGHT_HIGH,
                    seed=2)
    pcsr = with_random_weights(pkron(8, 16, seed=1), low=WEIGHT_LOW,
                               high=WEIGHT_HIGH, seed=2)
    delta = float(jdefault_delta(jf.build_slimsell(jcsr, C=8, L=128,
                                                   sigma=jcsr.n).to_jax()))
    jcalls = recorded(monkeypatch, JSession, "sssp")
    pcalls = recorded(monkeypatch, GraphSession, "sssp")
    kw = dict(scale=8, edge_factor=16, n_roots=8, delta=delta,
              batched=batched, batch_size=4)
    want = jg500.run_graph500_sssp(csr=jcsr, **kw)
    tiled = pg500.build_slimsell(pcsr, C=8, L=128,
                                 sigma=pcsr.n).to_torch("cpu")
    got = pg500.run_graph500_sssp(csr=pcsr, tiled=tiled, device="cpu", **kw)
    assert np.array_equal(got.roots, want.roots)
    assert got.validated == want.validated == 8
    for f in ("sweeps", "buckets"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert (got.delta, got.batched, got.batch_size) == \
        (want.delta, batched, 4 if batched else 1)
    assert len(pcalls) == (2 if batched else 8)
    results = flat(pcalls)
    assert_same_results(results, flat(jcalls))
    if batched:
        doors = [multi_source_sssp(tiled, got.roots[s:s + 4], delta=delta,
                                   need_parents=True, device="cpu")
                 for s in (0, 4)]
        rows = [(d.distances[i], d.parents[i], d.sweeps[i], d.buckets[i])
                for d in doors for i in range(4)]
    else:
        rows = [(d.distances, d.parents, d.sweeps, d.buckets)
                for d in (sssp(tiled, int(r), delta=delta, need_parents=True,
                               device="cpu") for r in got.roots)]
    for r, (d, p, sweeps, buckets) in zip(results, rows):
        np.testing.assert_array_equal(r.distances, d)
        np.testing.assert_array_equal(r.parents, p)
        assert (r.sweeps, r.buckets, r.delta) == (sweeps, buckets, delta)


def test_harness_uses_a_device_layout_without_copy(monkeypatch):
    """A layout already on the harness's device reaches the session as it
    is: one resident layout, never copied."""
    from repro_torch.serving import GraphSession
    seen = []
    orig = GraphSession.__init__

    def init(self, graph, **kw):
        orig(self, graph, **kw)
        seen.append((graph, self.tiled))

    monkeypatch.setattr(GraphSession, "__init__", init)
    csr = pkron(6, 4, seed=1)
    tiled = pg500.build_slimsell(csr, C=8, L=16).to_torch("cpu")
    pg500.run_graph500(scale=6, n_roots=4, batch_size=4, csr=csr,
                       tiled=tiled, device="cpu")
    assert len(seen) == 1 and seen[0][0] is tiled and seen[0][1] is tiled
