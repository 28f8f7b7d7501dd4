"""The port's serving session (``repro_torch.serving.GraphSession``) against
the JAX package's ``repro.serving.GraphSession`` on the CPU, and against
the port's own front doors. The router, the flush thread under producer
threads and the first-launch repair are in ``tests/test_torch_router.py``;
the Graph500 harnesses' session route in ``tests/test_torch_graph500.py``.

The same query streams, made from a seed with numpy, go through both
packages: the JAX package on its jnp path, the port with
``device="cpu"``. SSSP queries name the JAX package's default delta
explicitly: the port sums the mean weight in float64, the JAX package in
float32, so the two defaults agree only to ~1e-6 relative. Tolerances,
fixed before any comparison was run:

* BFS, SSSP and k-hop distances and parents, CC labels and counts, sweep
  and bucket counts, deltas: bit-equal, dtypes included;
* PageRank ranks within rtol 1e-5, atol 1e-8, its residual within rtol
  1e-4 and ``2 n ulp(max rank)``, its sweeps at most one apart, and
  betweenness scores within rtol 1e-5 and atol 1e-6 x the largest
  (``tests/test_torch_serving.py``'s bounds);
* statuses, slots, the metrics' counters (latencies aside; the sweep total
  apart by PageRank's sweep gap alone) and the typed errors and their
  messages equal.
"""
import doctest
import functools
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core.options import EngineConfig as JConfig
from repro.core.sssp import default_delta as jdefault_delta
from repro.graphs import generators as jg
from repro.serving import GraphSession as JSession
from repro.serving import session as jsession
from repro_torch.core import formats as pf
from repro_torch.core.betweenness import betweenness
from repro_torch.core.bfs import bfs
from repro_torch.core.cc import cc
from repro_torch.core.khop import khop
from repro_torch.core.options import EngineConfig
from repro_torch.core.pagerank import pagerank
from repro_torch.core.sssp import sssp
from repro_torch.graphs import generators as pg
from repro_torch.serving import (DeadlineExpired, GraphSession, QueryHandle,
                                 SessionClosed, session)

PR_RTOL, PR_ATOL = 1e-5, 1e-8
BC_RTOL, BC_ATOL_REL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def layouts():
    """(port CSR, JAX layout, port layout on the CPU, JAX default delta) of
    the weighted kronecker(7, 8) graph at C=8, L=16, built once."""
    jcsr = jg.with_random_weights(jg.kronecker(7, 8, seed=1), seed=2)
    pcsr = pg.with_random_weights(pg.kronecker(7, 8, seed=1), seed=2)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    jt = jf.build_slimsell(jcsr, C=8, L=16, sigma=jcsr.n).to_jax()
    pt = pf.build_slimsell(pcsr, C=8, L=16, sigma=pcsr.n).to_torch("cpu")
    return pcsr, jt, pt, float(jdefault_delta(jt))


def pair(**kw):
    """A JAX-package session and a port session over the same graph."""
    _, jt, pt, _ = layouts()
    return JSession(jt, **kw), GraphSession(pt, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def shared_pair():
    """One module-wide pair at max_batch=16, as the JAX package's
    ``tests/test_serving.py`` shares one session."""
    return pair(max_batch=16)


def assert_same_result(p, j):
    """One query's result from both packages, within the module's bounds."""
    assert (p.qid, p.algorithm, p.semiring, p.status, p.buckets, p.delta,
            p.n_components) == (j.qid, j.algorithm, j.semiring, j.status,
                                j.buckets, j.delta, j.n_components)
    assert (p.values is None) == (j.values is None)
    if p.values is None:
        return
    jv = np.asarray(j.values)
    assert p.values.dtype == jv.dtype
    if p.algorithm == "pagerank":
        n = jv.size
        np.testing.assert_allclose(p.values, jv, rtol=PR_RTOL, atol=PR_ATOL)
        ulp = float(np.spacing(np.float32(jv.max())))
        assert abs(p.residual - j.residual) <= 1e-4 * j.residual + 2 * n * ulp
        assert abs(p.sweeps - j.sweeps) <= 1
    else:
        assert p.sweeps == j.sweeps
        if p.algorithm == "betweenness":
            np.testing.assert_allclose(p.values, jv, rtol=BC_RTOL,
                                       atol=BC_ATOL_REL * float(jv.max()))
        else:
            np.testing.assert_array_equal(p.values, jv)
    assert (p.parents is None) == (j.parents is None)
    if p.parents is not None:
        assert p.parents.dtype == np.asarray(j.parents).dtype
        np.testing.assert_array_equal(p.parents, np.asarray(j.parents))


def assert_same_counters(pstats, jstats, pres=(), jres=()):
    """Two snapshots' counters and ratios equal, latencies aside, the sweep
    total apart by the PageRank results' sweep gap alone."""
    gap = sum(p.sweeps - j.sweeps for p, j in zip(pres, jres)
              if j.algorithm == "pagerank")
    assert pstats["sweeps_total"] - jstats["sweeps_total"] == gap
    skip = ("sweeps_total", "sweeps_per_query")

    def counters(snap):
        return {k: v for k, v in snap.items()
                if not k.startswith("latency") and k not in skip}
    assert counters(pstats) == counters(jstats)


def both(fn, jsess, psess):
    """``fn(session)`` on both packages: the two outcomes, each a value or
    the raised exception's (type name, message)."""
    out = []
    for s in (jsess, psess):
        try:
            out.append(fn(s))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out


# ------------------------------------------------------- mixed-stream oracle


def test_mixed_stream_matches_jax_and_front_doors():
    """The JAX package's 104-query stream (BFS in four semirings, SSSP, CC,
    flushes interleaved): slot for slot and result for result equal to the
    JAX session, and equal to the port's own front doors."""
    csr, _, pt, delta = layouts()
    jsess, psess = pair(max_batch=16)
    rng = np.random.default_rng(0)
    plan, handles = [], []
    for i in range(104):
        kind = ("bfs", "sssp", "cc")[i % 3]
        if kind == "cc":
            plan.append(("cc", None, "selmax"))
            kw = {}
        elif kind == "sssp":
            root = int(rng.integers(csr.n))
            while ("sssp", root, "minplus") in plan:
                root = int(rng.integers(csr.n))
            plan.append(("sssp", root, "minplus"))
            kw = dict(delta=delta)
        else:
            semiring = ("tropical", "selmax", "boolean", "real")[i % 4]
            root = int(rng.integers(csr.n))
            while ("bfs", root, semiring) in plan:
                root = int(rng.integers(csr.n))
            plan.append(("bfs", root, semiring))
            kw = dict(semiring=semiring)
        kind, root, _ = plan[-1]
        handles.append([s.submit(kind, root, **kw) for s in (jsess, psess)])
        if i % 17 == 16:
            jsess.flush()
            psess.flush()
    jsess.drain()
    psess.drain()
    cc_door = cc(pt, device="cpu")
    for (kind, root, semiring), (jh, ph) in zip(plan, handles):
        assert isinstance(ph, QueryHandle) and ph.done and ph.qid == jh.qid
        res = ph.result()
        assert_same_result(res, jh.result())
        if kind == "cc":
            np.testing.assert_array_equal(res.labels, cc_door.labels)
        elif kind == "sssp":
            door = sssp(pt, root, delta=delta, device="cpu")
            np.testing.assert_array_equal(res.distances, door.distances)
            assert (res.sweeps, res.buckets) == (door.sweeps, door.buckets)
        else:
            np.testing.assert_array_equal(
                res.distances, bfs(pt, root, semiring, device="cpu").distances)
    pstats, jstats = psess.stats(), jsess.stats()
    assert_same_counters(pstats, jstats)
    assert pstats["completed"] == 104 and pstats["batches_dispatched"] < 104
    assert 0 < pstats["batch_fill_ratio"] <= 1


def test_parents_match_jax_and_front_doors():
    _, _, pt, delta = layouts()
    jsess, psess = shared_pair()
    for semiring in ("tropical", "selmax"):
        got = psess.bfs(3, semiring, need_parents=True)
        assert_same_result(got, jsess.bfs(3, semiring, need_parents=True))
        door = bfs(pt, 3, semiring, need_parents=True, device="cpu")
        np.testing.assert_array_equal(got.parents, door.parents)
    got = psess.sssp(5, delta=delta, need_parents=True)
    assert_same_result(got, jsess.sssp(5, delta=delta, need_parents=True))
    door = sssp(pt, 5, delta=delta, need_parents=True, device="cpu")
    np.testing.assert_array_equal(got.parents, door.parents)


# ------------------------------------------------------------------ padding


def test_partial_batch_padding_matches_jax():
    """Widths are powers of two; padded columns never leak into results."""
    _, _, pt, _ = layouts()
    jsess, psess = pair(max_batch=8)
    for count in (1, 2, 3, 5, 7):   # 3 / 5 / 7 pad up to 4 / 8 / 8
        roots = list(range(10, 10 + count))
        got, want = psess.bfs_many(roots), jsess.bfs_many(roots)
        for root, p, j in zip(roots, got, want):
            assert_same_result(p, j)
            np.testing.assert_array_equal(
                p.distances, bfs(pt, root, device="cpu").distances)
    st = psess.stats()
    assert_same_counters(st, jsess.stats())
    assert st["columns_total"] == 1 + 2 + 4 + 8 + 8
    assert st["columns_real"] == 1 + 2 + 3 + 5 + 7


def test_bucketing_separates_incompatible_queries():
    _, _, _, delta = layouts()
    for s in pair(max_batch=16):
        s.submit("bfs", 0)
        s.submit("bfs", 1, semiring="boolean")
        s.submit("sssp", 2, delta=delta)
        s.drain()
        assert s.stats()["batches_dispatched"] == 3


def test_whole_graph_queries_share_one_run():
    """The JAX package's batcher test through the session: five BFS roots
    ride one width-8 slot, three CC queries one shared width-1 run."""
    jsess, psess = pair(max_batch=8)
    out = []
    for s in (jsess, psess):
        hs = [s.submit("bfs", r) for r in range(5)]
        hs += [s.submit("cc") for _ in range(3)]
        assert s.batcher.depth() == 8
        s.drain()
        out.append([h.result() for h in hs])
        st = s.stats()
        assert (st["batches_dispatched"], st["columns_total"],
                st["columns_real"]) == (2, 9, 6)
    for p, j in zip(*reversed(out)):
        assert_same_result(p, j)
    assert_same_counters(psess.stats(), jsess.stats())


# ------------------------------------------------------- submit validation


def test_duplicate_root_rejected_at_submit():
    for s in pair():
        s.submit("bfs", 4)
        with pytest.raises(ValueError, match="already pending"):
            s.submit("bfs", 4)
        s.submit("bfs", 4, semiring="boolean")  # another bucket: fine
        s.drain()
        s.submit("bfs", 4)                      # the batch went: fine
        s.drain()
        assert s.stats()["completed"] == 3


BAD_SUBMITS = {
    "unknown algorithm": (("triangles", 0), {}),
    "root for pagerank": (("pagerank", 0), {}),
    "root past n": (("bfs", 128), {}),
    "negative root": (("sssp", -1), {}),
    "missing root": (("bfs",), {}),
    "root for cc": (("cc", 0), {}),
    "bfs minplus": (("bfs", 0), dict(semiring="minplus")),
    "sssp tropical": (("sssp", 0), dict(semiring="tropical")),
    "delta for bfs": (("bfs", 0), dict(delta=1.0)),
    "cc real": (("cc",), dict(semiring="real")),
    "pagerank tropical": (("pagerank",), dict(semiring="tropical")),
    "damping 1": (("pagerank",), dict(damping=1.0)),
    "tol 0": (("pagerank",), dict(tol=0.0)),
    "damping for bfs": (("bfs", 0), dict(damping=0.5)),
    "betweenness boolean": (("betweenness",), dict(semiring="boolean")),
    "khop without k": (("khop", 0), {}),
    "khop k < 0": (("khop", 0), dict(k=-1)),
    "khop tropical": (("khop", 0), dict(semiring="tropical", k=1)),
    "k for bfs": (("bfs", 0), dict(k=1)),
    "packed tropical": (("bfs", 0), dict(packed=True)),
    "packed sssp": (("sssp", 0), dict(packed=True)),
}


@pytest.mark.parametrize("case", sorted(BAD_SUBMITS))
def test_bad_submit_rejected_as_jax(case):
    """Every boundary check raises what the JAX package raises, with its
    message, and enqueues nothing."""
    args, kw = BAD_SUBMITS[case]
    jsess, psess = shared_pair()
    depth = psess.batcher.depth()
    jout, pout = both(lambda s: s.submit(*args, **kw), jsess, psess)
    assert isinstance(pout, tuple) and pout[0] == "ValueError"
    assert pout == jout
    assert psess.batcher.depth() == depth


def test_submit_checks_weights_and_packed_direction_as_jax():
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    jsess = jsession(edges)
    psess = session(edges, device="cpu")
    jout, pout = both(lambda s: s.submit("sssp", 0), jsess, psess)
    assert pout == jout and "weighted layout" in pout[1]
    jauto = jsession(edges, config=JConfig(direction="auto"))
    pauto = session(edges, config=EngineConfig(direction="auto"),
                    device="cpu")
    jout, pout = both(lambda s: s.submit("bfs", 0, semiring="boolean",
                                         packed=True), jauto, pauto)
    assert pout == jout and "push-direction" in pout[1]


# ----------------------------------------------------------------- deadlines


def test_deadline_expired_is_typed_timeout():
    out = []
    for s in pair():
        h = s.submit("bfs", 9, deadline=0.0)
        live = s.submit("bfs", 10)
        time.sleep(0.005)
        res = h.result()                 # drains; must not hang
        assert res.status == "timeout" and not res.ok and res.values is None
        out.append((res, live.result(), s.stats()["timeouts"]))
    (pres, plive, pt_), (jres, jlive, jt_) = reversed(out)
    assert_same_result(pres, jres)
    assert_same_result(plive, jlive)
    assert plive.ok and pt_ == jt_ == 1
    with pytest.raises(DeadlineExpired):
        pres.raise_for_status()
    with pytest.raises(DeadlineExpired):
        _ = pres.distances


class FakeClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_fake_clock_session_expires_queued_queries():
    """Queued-past-deadline queries never dispatch: the session's flush
    (driven by the same fake clock) completes them as valueless timeouts."""
    out = []
    for s, clock in ((JSession, FakeClock()), (GraphSession, FakeClock())):
        kw = {} if s is JSession else dict(device="cpu")
        sess = s(layouts()[1 if s is JSession else 2], clock=clock,
                 max_batch=8, **kw)
        dead = sess.submit("bfs", 0, deadline=1.0)
        live = sess.submit("bfs", 1, deadline=10.0)
        clock.advance(2.0)
        sess.drain()
        assert dead.result().status == "timeout"
        assert dead.result().values is None and live.result().ok
        assert sess.stats()["columns_real"] == 1
        out.append((dead.result(), live.result(), sess.stats()))
        sess.close()
    (jd, jl, js), (pd, pl, ps) = out
    assert_same_result(pd, jd)
    assert_same_result(pl, jl)
    assert pd.latency_s == jd.latency_s == 2.0
    assert_same_counters(ps, js)


def test_stats_reconcile_after_drain():
    """submitted == completed + timeouts + shed across the ok, expired and
    shed paths of one fake-clock session, as in the JAX package."""
    out = []
    for s in (JSession, GraphSession):
        clock = FakeClock()
        kw = {} if s is JSession else dict(device="cpu")
        sess = s(layouts()[1 if s is JSession else 2], clock=clock,
                 max_batch=8, max_pending=8, on_full="shed", max_inflight=2,
                 **kw)
        handles = [sess.submit("bfs", r) for r in range(4)]
        handles += [sess.submit("bfs", 10 + r, deadline=0.5)
                    for r in range(2)]
        clock.advance(1.0)
        handles += [sess.submit("bfs", 20 + r) for r in range(4)]
        sess.drain()
        st = sess.stats()
        assert (st["submitted"], st["shed"], st["timeouts"],
                st["completed"]) == (10, 2, 2, 6)
        assert st["queue_depth"] == 0 and st["inflight"] == 0
        out.append((st, [h.result() for h in handles]))
        sess.close()
    (js, jr), (ps, pr) = out
    assert_same_counters(ps, js)
    for p, j in zip(pr, jr):
        assert_same_result(p, j)
    assert sorted(r.status for r in pr) == ["ok"] * 6 + ["shed"] * 2 \
        + ["timeout"] * 2


# ------------------------------------------------------------- handle cache


def test_compile_cache_hit_counting():
    jsess, psess = pair(max_batch=8)
    for s in (jsess, psess):
        s.bfs_many([0, 1, 2, 3])         # width 4: miss
        assert s.stats()["compile_cache_misses"] == 1
        s.bfs_many([4, 5, 6, 7])         # width 4 again: hit
        st = s.stats()
        assert st["compile_cache_hits"] == 1
        assert st["compile_cache_misses"] == 1
        s.bfs_many([8, 9])               # width 2: new signature, miss
        st = s.stats()
        assert st["compile_cache_hits"] == 1
        assert st["compile_cache_misses"] == 2
    assert_same_counters(psess.stats(), jsess.stats())


# ----------------------------------------------------- config= and facades


def test_session_takes_config_only():
    """The port's session takes the engine knobs as ``config=`` only: the
    JAX package's deprecated per-call keywords and its backend are not
    options here, so they are refused as unknown keywords."""
    _, _, pt, _ = layouts()
    for kw in (dict(mode="hostloop"), dict(direction="pull"),
               dict(backend="jnp")):
        with pytest.raises(TypeError, match="unexpected keyword"):
            GraphSession(pt, device="cpu", **kw)
    sess = GraphSession(pt, device="cpu")
    assert sess.config == EngineConfig()
    with pytest.raises(ValueError, match="unknown on_full 'drop'"):
        GraphSession(pt, on_full="drop", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        EngineConfig(mode="warp")
    with pytest.raises(ValueError, match="unknown direction"):
        EngineConfig(direction="sideways")


@pytest.mark.parametrize("config", [dict(mode="hostloop"),
                                    dict(direction="pull"),
                                    dict(direction="auto")])
def test_session_config_matches_jax(config):
    """A session under one ``config=`` serves what the JAX package's
    session under the same knobs serves."""
    jsess = JSession(layouts()[1], config=JConfig(backend="jnp", **config),
                     max_batch=4)
    psess = GraphSession(layouts()[2], config=EngineConfig(**config),
                         max_batch=4, device="cpu")
    assert psess.config.signature() == \
        (config.get("direction", "push"), config.get("mode", "fused"))
    roots = [0, 3, 11]
    if config.get("mode") == "hostloop":
        got = [psess.bfs(r) for r in roots]
        want = [jsess.bfs(r) for r in roots]
    else:
        got, want = psess.bfs_many(roots), jsess.bfs_many(roots)
    for p, j in zip(got, want):
        assert_same_result(p, j)
    assert_same_counters(psess.stats(), jsess.stats())


def test_facades_match_jax():
    """cc (packed too), pagerank, betweenness, khop, khop_many and the
    batched sssp facade against the JAX session's, and the port's front
    doors."""
    _, _, pt, delta = layouts()
    jsess, psess = shared_pair()
    pairs = [
        (psess.cc("boolean", packed=True), jsess.cc("boolean", packed=True)),
        (psess.pagerank(damping=0.7), jsess.pagerank(damping=0.7)),
        (psess.betweenness(), jsess.betweenness()),
        (psess.khop(6, 2), jsess.khop(6, 2)),
        (psess.khop(6, 1, packed=True), jsess.khop(6, 1, packed=True)),
        *zip(psess.khop_many([1, 2, 40], 2), jsess.khop_many([1, 2, 40], 2)),
        *zip(psess.sssp([7, 8], delta=delta),
             jsess.sssp([7, 8], delta=delta)),
        *zip(psess.sssp(9, delta=delta, batch=True),
             jsess.sssp(9, delta=delta, batch=True))]
    for p, j in pairs:
        assert_same_result(p, j)
    (ccp, _), (pr, _), (bc, _), (k2, _), (k1, _) = pairs[:5]
    np.testing.assert_array_equal(
        ccp.labels, cc(pt, semiring="boolean", packed=True, device="cpu").labels)
    np.testing.assert_array_equal(
        pr.ranks, pagerank(pt, damping=0.7, device="cpu").ranks)
    np.testing.assert_allclose(bc.scores, betweenness(pt, device="cpu").scores,
                               rtol=BC_RTOL)
    np.testing.assert_array_equal(k2.distances,
                                  khop(pt, 6, 2, device="cpu").distances)
    np.testing.assert_array_equal(
        k1.distances, khop(pt, 6, 1, packed=True, device="cpu").distances)
    with pytest.raises(AttributeError, match="no distance vector"):
        _ = pr.distances


# ------------------------------------------------------------- construction


def test_session_from_edge_list():
    edges = np.array([[0, 1], [1, 2], [2, 3], [4, 5]])
    s = session(edges, device="cpu")
    j = jsession(edges)
    assert s.layout_signature == j.layout_signature
    got, want = s.bfs(0), j.bfs(0)
    assert got.distances.tolist() == [0, 1, 2, 3, -1, -1]
    assert_same_result(got, want)
    got, want = s.cc(), j.cc()
    assert got.n_components == 2
    assert_same_result(got, want)
    for fn in (session, jsession):
        with pytest.raises(ValueError, match=r"\[m, 2\]"):
            fn(np.zeros((3, 3)), **({"device": "cpu"} if fn is session
                                    else {}))


def test_session_keeps_a_device_layout_and_moves_a_host_one():
    """A layout already on the session's device is used as it is (no copy:
    at scale 20 it holds 0.5+ GB); a host layout is moved once; a layout
    on another device is refused, as by the front doors."""
    csr = layouts()[0]
    pt = layouts()[2]
    sess = GraphSession(pt, device="cpu")
    assert sess.tiled is pt and sess.dispatcher.tiled is pt
    assert sess.tiled.cols.data_ptr() == pt.cols.data_ptr()
    assert sess.device == torch.device("cpu")
    host = pf.build_slimsell(csr, C=8, L=16, sigma=csr.n)
    moved = GraphSession(host, device="cpu")
    assert host.device is None and moved.tiled.device == torch.device("cpu")
    np.testing.assert_array_equal(moved.bfs(3).distances,
                                  sess.bfs(3).distances)
    with pytest.raises(ValueError, match="weights must be baked"):
        GraphSession(pt, weights=np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="the layout is on cpu"):
        GraphSession(pt, device="meta")


def test_closed_session_and_unknown_qid_are_typed():
    _, _, pt, _ = layouts()
    s = GraphSession(pt, device="cpu")
    with pytest.raises(KeyError, match="unknown query id 0"):
        s.result(0)
    h = s.submit("bfs", 0)
    assert not h.done and "pending" in repr(h)
    assert h.result().ok and h.done and "done" in repr(h)
    s.close()
    with pytest.raises(SessionClosed, match="dropped"):
        s.result(h.qid)
    with pytest.raises(SessionClosed, match="after close"):
        s.bfs(1)


def test_module_docstring_example():
    """``session``'s doctest: a path from an edge list on the CPU."""
    failed, tried = doctest.testmod(
        sys.modules["repro_torch.serving.session"], verbose=False)[:2]
    assert tried >= 3 and failed == 0
