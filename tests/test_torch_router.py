"""The port's router and concurrent serving (``repro_torch.serving.Router``,
``GraphSession(background=True)``, backpressure, shutdown) against the JAX
package's on the CPU, and the first-launch repair of the kernel wrappers
(``kernels.ops.Kernel``, ``kernels.build.build``) under racing threads.

The threaded tests assert invariants only: every query ends exactly once;
an ok result (or a late timeout's values) is bit-equal to its synchronous
twin, the JAX package's front door for the same query on the same graph
(and the port's own front door); the counters reconcile as ``submitted ==
completed + timeouts + shed``. They never assert how many queries time
out, and every thread they start is joined with a timeout and then checked
to have ended. The single-threaded tests hold statuses, counters, typed
errors and results to the JAX package's session and router on the same
calls: integers bit-equal, dtypes included (no float query runs here).
"""
import ctypes
import functools
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.bfs import bfs as jbfs
from repro.core.cc import cc as jcc
from repro.core import formats as jf
from repro.core.sssp import default_delta as jdefault_delta
from repro.core.sssp import sssp as jsssp
from repro.graphs import generators as jg
from repro.serving import GraphSession as JSession
from repro.serving import Router as JRouter
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core.bfs import bfs
from repro_torch.core.cc import cc
from repro_torch.core.sssp import sssp
from repro_torch.graphs import generators as pg
from repro_torch.kernels import build, ops
from repro_torch.serving import (GraphSession, QueryShed, QueueFull, Router,
                                 SessionClosed, UnknownGraph)

N_PRODUCERS = 4
N_QUERIES = 208          # across all producers, as in the JAX package's test
JOIN_S = 60.0            # every thread is joined within this


@functools.lru_cache(maxsize=None)
def graphs():
    """name -> (JAX layout, port layout on the CPU, JAX default delta) of two
    weighted graphs with different layouts, built once."""
    out = {}
    for name, (jgraph, pgraph) in {
            "g0": (jg.kronecker(7, 8, seed=1), pg.kronecker(7, 8, seed=1)),
            "g1": (jg.erdos_renyi(150, 5, seed=3),
                   pg.erdos_renyi(150, 5, seed=3))}.items():
        seed = 2 if name == "g0" else 4
        jcsr = jg.with_random_weights(jgraph, seed=seed)
        pcsr = pg.with_random_weights(pgraph, seed=seed)
        assert np.array_equal(jcsr.indices, pcsr.indices)
        jt = jf.build_slimsell(jcsr, C=8, L=16, sigma=jcsr.n).to_jax()
        pt = pf.build_slimsell(pcsr, C=8, L=16, sigma=pcsr.n).to_torch("cpu")
        out[name] = (jt, pt, float(jdefault_delta(jt)))
    return out


@functools.lru_cache(maxsize=None)
def twin(graph: str, kind: str, root, semiring):
    """The synchronous twin of one query: the JAX package's front door,
    checked against the port's own front door on the same graph."""
    jt, pt, delta = graphs()[graph]
    if kind == "cc":
        want, got = np.asarray(jcc(jt).labels), cc(pt, device="cpu").labels
    elif kind == "sssp":
        want = np.asarray(jsssp(jt, root, delta=delta).distances)
        got = sssp(pt, root, delta=delta, device="cpu").distances
    else:
        want = np.asarray(jbfs(jt, root, semiring).distances)
        got = bfs(pt, root, semiring, device="cpu").distances
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return want


def mixed_plan(seed: int, n_queries: int):
    """The JAX package's randomized BFS / SSSP / CC plan over both graphs:
    roots drawn without replacement per (graph, bucket), so no two
    producers ever hold one root pending in one bucket."""
    rng = np.random.default_rng(seed)
    pools, plan = {}, []
    for _ in range(n_queries):
        graph = ("g0", "g1")[int(rng.integers(2))]
        r = int(rng.integers(10))
        if r == 9:
            plan.append((graph, "cc", None, "selmax"))
            continue
        kind, semiring = (("bfs", "tropical"), ("bfs", "selmax"),
                          ("sssp", "minplus"))[r % 3]
        pool = pools.setdefault((graph, kind, semiring),
                                list(rng.permutation(graphs()[graph][1].n)))
        if not pool:
            plan.append((graph, "cc", None, "selmax"))
            continue
        plan.append((graph, kind, int(pool.pop()), semiring))
    return plan


def run_threads(target, n_threads: int) -> None:
    """``target(t)`` on ``n_threads`` threads, joined within ``JOIN_S``;
    a thread still running or a thread's exception fails the test."""
    errors = []

    def body(t):
        try:
            target(t)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(t,), daemon=True)
               for t in range(n_threads)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + JOIN_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(th.is_alive() for th in threads), "a thread hung"
    if errors:
        raise errors[0]


def submit_plan(router, plan, n_threads: int):
    """The plan from ``n_threads`` producers, each waiting on its own
    handles; the results in plan order."""
    results = [None] * len(plan)

    def producer(t):
        handles = []
        for i in range(t, len(plan), n_threads):
            graph, kind, root, semiring = plan[i]
            delta = graphs()[graph][2]
            if kind == "cc":
                handles.append((i, router.submit(graph, "cc")))
            elif kind == "sssp":
                handles.append((i, router.submit(graph, "sssp", root,
                                                 delta=delta)))
            else:
                handles.append((i, router.submit(graph, "bfs", root,
                                                 semiring=semiring)))
        for i, h in handles:
            results[i] = h.result()

    run_threads(producer, n_threads)
    return results


def reconciled(st) -> bool:
    return st["submitted"] == st["completed"] + st["timeouts"] + st["shed"]


# ------------------------------------------------------------ stress suite


@pytest.mark.parametrize("seed", [0, 1])
def test_threaded_mixed_stream_bit_equal(seed):
    """Four producers x two graphs x 208 mixed queries through a
    background-flush router: every answer bit-equal to its synchronous
    twin, every query ended once, the counters reconciled."""
    plan = mixed_plan(seed, N_QUERIES)
    with Router(background=True, max_inflight=2, max_batch=16,
                flush_interval=0.001, device="cpu") as router:
        for name, (_, pt, _) in graphs().items():
            router.add_graph(name, pt)
        results = submit_plan(router, plan, N_PRODUCERS)
        stats = router.stats()
    assert len({(g, r.qid) for (g, *_), r in zip(plan, results)}) \
        == len(plan)
    for (graph, kind, root, semiring), res in zip(plan, results):
        assert res is not None and res.ok, (graph, kind, root, res)
        got = res.labels if kind == "cc" else res.distances
        want = twin(graph, kind, root, semiring)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    total = stats["total"]
    assert total["submitted"] == len(plan) == total["completed"]
    assert reconciled(total) and total["queue_depth"] == 0
    assert all(reconciled(st) for st in stats["graphs"].values())


def test_deadline_vs_flush_race():
    """Producers race tiny deadlines against the flush thread: every query
    ends exactly once, as ok (bit-equal) or as a typed timeout, and the
    counters reconcile."""
    _, pt, _ = graphs()["g0"]
    sess = GraphSession(pt, background=True, flush_interval=0.001,
                        max_batch=8, device="cpu")
    handles = []
    lock = threading.Lock()

    def producer(t):
        rng = np.random.default_rng(t)
        for i in range(24):
            root = int(t * 31 + i)  # distinct roots across producers
            deadline = float(rng.choice([0.0, 0.0005, 0.5]))
            h = sess.submit("bfs", root, deadline=deadline)
            with lock:
                handles.append((root, h))
            if i % 7 == 0:
                time.sleep(0.001)

    run_threads(producer, N_PRODUCERS)
    results = [(root, h.result()) for root, h in handles]
    stats = sess.stats()
    sess.close()
    assert len({h.qid for _, h in handles}) == len(handles) == 96
    for root, res in results:
        assert res.status in ("ok", "timeout")
        if res.status == "ok" or res.values is not None:
            np.testing.assert_array_equal(
                res.values, twin("g0", "bfs", root, "tropical"))
    assert stats["submitted"] == len(handles) and reconciled(stats)
    assert stats["timeouts"] == sum(r.status == "timeout"
                                    for _, r in results)


# ----------------------------------------------------------- backpressure


def test_backpressure_shed_results_are_typed():
    jt, pt, _ = graphs()["g0"]
    out = []
    for sess in (JSession(jt, max_pending=4, on_full="shed"),
                 GraphSession(pt, max_pending=4, on_full="shed",
                              device="cpu")):
        results = [h.result() for h in [sess.submit("bfs", r)
                                        for r in range(10)]]
        out.append((results, sess.stats()))
        sess.close()
    (jres, jst), (pres, pst) = out
    assert [r.status for r in pres] == [r.status for r in jres] \
        == ["ok"] * 4 + ["shed"] * 6
    for p, j in zip(pres, jres):
        assert (p.qid, p.values is None) == (j.qid, j.values is None)
        if p.ok:
            np.testing.assert_array_equal(p.distances, np.asarray(j.values))
        else:
            with pytest.raises(QueryShed):
                p.raise_for_status()
            with pytest.raises(QueryShed):
                _ = p.distances
    for k in ("submitted", "completed", "timeouts", "shed",
              "batches_dispatched", "columns_real"):
        assert pst[k] == jst[k]
    assert pst["shed"] == 6 and reconciled(pst) and pst["submitted"] == 10


def test_backpressure_raise_policy_and_recovery():
    jt, pt, _ = graphs()["g0"]
    msgs = []
    for sess in (JSession(jt, max_pending=2, on_full="raise"),
                 GraphSession(pt, max_pending=2, on_full="raise",
                              device="cpu")):
        sess.submit("bfs", 0)
        sess.submit("bfs", 1)
        with pytest.raises(QueueFull if isinstance(sess, GraphSession)
                           else Exception, match="queue full") as e:
            sess.submit("bfs", 2)
        msgs.append(str(e.value))
        sess.flush()                      # drains the queue ...
        h = sess.submit("bfs", 2)         # ... so the retry is accepted
        assert h.result().ok and h.qid == 2
        sess.close()
    assert msgs[0] == msgs[1]


def test_concurrent_submits_never_overshoot_bound():
    """max_pending is enforced atomically: racing producers see at most
    max_pending accepted but undrained queries."""
    _, pt, _ = graphs()["g0"]
    sess = GraphSession(pt, max_pending=8, on_full="raise", device="cpu")
    outcomes = []
    lock = threading.Lock()

    def producer(t):
        for i in range(8):
            try:
                sess.submit("bfs", t * 8 + i)
                outcome = "accepted"
            except QueueFull:
                outcome = "full"
            with lock:
                outcomes.append(outcome)

    run_threads(producer, 4)
    assert sess.batcher.depth() <= 8
    assert outcomes.count("accepted") == 8 and outcomes.count("full") == 24
    sess.drain()
    assert sess.stats()["completed"] == 8
    sess.close()


# ------------------------------------------------------ shutdown semantics


def test_double_close_is_idempotent_and_submit_after_close_is_typed():
    _, pt, _ = graphs()["g0"]
    sess = GraphSession(pt, background=True, device="cpu")
    h = sess.submit("bfs", 0)
    assert h.result().ok
    flusher = sess._flush_thread
    sess.close()
    assert sess.closed and not flusher.is_alive()
    sess.close()                      # a second close: no-op, no error
    with pytest.raises(SessionClosed, match="after close"):
        sess.submit("bfs", 1)
    with pytest.raises(SessionClosed, match="dropped"):
        sess.result(h.qid)            # the results map went at close


def test_close_drains_inflight_work():
    """Queries still queued or in flight at close() complete (the close's
    drain), and the flush thread ends."""
    _, pt, _ = graphs()["g0"]
    sess = GraphSession(pt, background=True, max_inflight=2, device="cpu")
    for r in range(5):
        sess.submit("bfs", r)
    flusher = sess._flush_thread
    sess.close()
    stats = sess.stats()
    assert not flusher.is_alive()
    assert stats["completed"] == 5 and reconciled(stats)
    assert stats["inflight"] == 0 and stats["queue_depth"] == 0


def test_context_manager_closes_background_session():
    _, pt, _ = graphs()["g0"]
    with GraphSession(pt, background=True, device="cpu") as sess:
        res = sess.bfs(1)
        assert res.ok
        np.testing.assert_array_equal(res.distances,
                                      twin("g0", "bfs", 1, "tropical"))
    assert sess.closed
    with pytest.raises(SessionClosed):
        sess.submit("bfs", 2)


# ------------------------------------------------------------------ router


def test_router_typed_errors_and_table_ops():
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    out = []
    for router in (JRouter(), Router(device="cpu")):
        router.add_graph("a", edges)
        with pytest.raises(ValueError, match="already resident"):
            router.add_graph("a", edges)
        with pytest.raises(Exception, match="unknown graph") as e:
            router.bfs("missing", 0)
        out.append((type(e.value).__name__, str(e.value), router.graphs(),
                    router.signatures()["a"]))
        assert router.signatures()["a"] == router.session("a").layout_signature
        assert router.bfs("a", 0).distances.tolist() == [0, 1, 2, 3]
        router.remove_graph("a")
        with pytest.raises(Exception, match="unknown graph"):
            router.remove_graph("a")
        router.close()
        router.close()
        with pytest.raises(Exception, match="router is closed"):
            router.add_graph("b", edges)
        with pytest.raises(Exception, match="router is closed"):
            router.submit("a", "bfs", 0)
    assert out[0] == out[1]
    assert out[1][0] == UnknownGraph.__name__
    with pytest.raises(SessionClosed):
        router.session("a")


def test_router_sessions_are_isolated():
    """Per-graph sessions keep their own queues, metrics and layouts: one
    graph's traffic never leaks into another's counters or answers."""
    router = Router(max_batch=8, device="cpu")
    for name, (_, pt, _) in graphs().items():
        router.add_graph(name, pt)
        assert router.session(name).tiled is pt   # the layout, not a copy
    r0, r1 = router.bfs("g0", 3), router.bfs("g1", 3)
    np.testing.assert_array_equal(r0.distances, twin("g0", "bfs", 3,
                                                     "tropical"))
    np.testing.assert_array_equal(r1.distances, twin("g1", "bfs", 3,
                                                     "tropical"))
    stats = router.stats()
    assert stats["graphs"]["g0"]["submitted"] == 1
    assert stats["graphs"]["g1"]["submitted"] == 1
    assert stats["total"]["submitted"] == 2 and stats["total"]["graphs"] == 2
    assert router.signatures()["g0"] != router.signatures()["g1"]
    router.close()
    assert router.closed


def test_router_forwards_overrides_and_device():
    """``add_graph`` overrides replace the router's session defaults for one
    graph, ``device`` among them."""
    _, pt, delta = graphs()["g0"]
    router = Router(max_batch=4, device="cpu")
    a = router.add_graph("a", pt)
    b = router.add_graph("b", pt, max_batch=16, max_pending=3,
                         on_full="shed")
    assert (a.batcher.max_batch, a.batcher.max_pending) == (4, None)
    assert (b.batcher.max_batch, b.batcher.max_pending, b.on_full) == \
        (16, 3, "shed")
    assert a.tiled is b.tiled is pt and a.device == b.device
    got = router.sssp("b", [1, 2], delta=delta)
    np.testing.assert_array_equal(got[1].distances, twin("g0", "sssp", 2,
                                                         "minplus"))
    assert router.cc("a").labels.tolist() == twin("g0", "cc", None,
                                                  "selmax").tolist()
    router.close()


# ------------------------------------------- fixpoint_handle once-guard


def test_sessions_first_dispatch_shares_one_handle():
    """Eight sessions on eight threads first dispatch one new signature at
    once: the per-signature once-guard builds one handle, which every
    session's table holds."""
    edges = np.array([[i, i + 1] for i in range(96)])  # n = 97: a new key
    sessions = [GraphSession(edges, max_batch=2, device="cpu")
                for _ in range(8)]
    before = peng._fixpoint_handle_cached.cache_info().misses
    barrier = threading.Barrier(8)
    results = [None] * 8

    def worker(t):
        barrier.wait(timeout=JOIN_S)
        results[t] = sessions[t].bfs_many([0, 96])

    run_threads(worker, 8)
    assert peng._fixpoint_handle_cached.cache_info().misses - before == 1
    handles = [h for s in sessions for h in s.dispatcher._handles.values()]
    assert len(handles) == 8 and all(h is handles[0] for h in handles)
    for res in results:
        assert res[1].distances[0] == 96 and res[0].distances[96] == 96


# -------------------------------------- the kernels' first launch, repaired


class FakeLib:
    """A loaded library whose entry points succeed."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = (lambda *a: 0) if not name.endswith("_error") \
            else (lambda code: b"no error")
        return type("Entry", (), {"__call__": staticmethod(fn),
                                  "argtypes": None, "restype": None})()


def test_kernel_first_launch_builds_and_loads_once(monkeypatch):
    """Eight threads first-launch one kernel at once: the library is built
    and loaded once, and every launch is counted."""
    calls = {"build": 0, "load": 0}

    def fake_build(names, **kw):
        calls["build"] += 1
        time.sleep(0.05)   # widen the window a racing loader would hit
        return {}

    def fake_cdll(path):
        calls["load"] += 1
        return FakeLib(path)

    monkeypatch.setattr(ops.build, "build", fake_build)
    monkeypatch.setattr(ops.ctypes, "CDLL", fake_cdll)
    kern = ops.Kernel("slimsell_spmv", [ctypes.c_int])
    barrier = threading.Barrier(8)

    def launcher(t):
        barrier.wait(timeout=JOIN_S)
        kern.launch(t)

    run_threads(launcher, 8)
    assert calls == {"build": 1, "load": 1}
    assert kern.launches == 8

    # more threads than cores and a short switch interval: an unlocked
    # read-modify-write of the count would lose updates
    def many(t):
        for _ in range(1000):
            kern.launch(t)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads(many, 32)
    finally:
        sys.setswitchinterval(interval)
    assert kern.launches == 8 + 32 * 1000


def test_racing_builds_run_nvcc_once(monkeypatch, tmp_path):
    """Threads building one library at once start one compiler, whose
    temporary output is named per process and per thread."""
    started = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append((cmd, threading.get_ident()))
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            time.sleep(0.05)
            with open(self.out, "wb") as f:
                f.write(b"lib")
            return "", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    barrier = threading.Barrier(8)

    def builder(t):
        barrier.wait(timeout=JOIN_S)
        build.build(["slimsell_spmv"])

    run_threads(builder, 8)
    assert len(started) == 1
    (cmd, ident), = started
    tmp = cmd[cmd.index("-o") + 1]
    assert tmp.endswith(f".{ident}.tmp") and str(tmp_path) in tmp
    assert build.library_path("slimsell_spmv").read_bytes() == b"lib"
    assert not list(tmp_path.glob("*.tmp"))
