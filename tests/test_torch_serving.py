"""The port's serving layer (``repro_torch.serving``: batcher, metrics,
dispatcher; ``core.engine.fixpoint_handle``) against the JAX package's
``repro.serving`` on the CPU, and against the port's own front doors.

The same query streams, made from a seed with numpy, go through both
packages. Tolerances, fixed before any comparison was run:

* batch slots (keys, widths, query order, padded roots, expired lists)
  equal;
* BFS distances and parents in all four semirings and packed, SSSP at two
  bucket widths with sweeps and buckets, CC labels and component counts,
  k-hop distances: bit-equal, dtypes included; under ``direction="auto"``
  the sel-max parents are validated instead (the pull's first hit may pick
  another parent of the same depth);
* PageRank ranks within rtol 1e-5, atol 1e-8 (``tests/test_torch_workloads``
  bounds), the residual within rtol 1e-4 and ``2 n ulp(max rank)``, the
  sweeps at most one apart (that floor lies within a factor of two of tol
  on this graph, so the last residual may land on either side of it);
* betweenness scores within rtol 1e-5 and atol 1e-6 x the largest;
* the metrics' counters equal (latencies aside; the sweep total apart by
  the PageRank sweeps' gap alone).

The port's hostloop streams are held against the JAX package's fused
dispatcher and against the port's front doors: the JAX package's hostloop
re-adds a repeated tile under the real semiring with SlimWork.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro.serving import batcher as jbatcher
from repro.serving import dispatch as jdispatch
from repro.serving import metrics as jmetrics
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core.betweenness import betweenness
from repro_torch.core.bfs import bfs
from repro_torch.core.cc import CC_SPEC, cc
from repro_torch.core.khop import khop
from repro_torch.core.multi_bfs import multi_bfs_spec, packed_multi_bfs_spec
from repro_torch.core.multi_sssp import multi_source_sssp, multi_sssp_spec
from repro_torch.core.options import ALGORITHMS, QUERY_STATUSES, EngineConfig
from repro_torch.core.pagerank import pagerank, pagerank_spec, pagerank_views
from repro_torch.core.sssp import sssp
from repro_torch.graphs import generators as pg
from repro_torch.serving import batcher as pbatcher
from repro_torch.serving import dispatch as pdispatch
from repro_torch.serving import metrics as pmetrics
from repro_torch.serving import (Batcher, BatchSlot, BucketKey,
                                 DeadlineExpired, Dispatcher, Query,
                                 QueryResult, QueryShed, QueueFull,
                                 ServingMetrics)

LAYOUTS = {"C8L16": dict(C=8, L=16, full_sigma=True),
           "C4L8": dict(C=4, L=8, full_sigma=False)}
DELTAS = (0.3, 0.7)
DAMPINGS = (0.85, 0.7)
PR_RTOL, PR_ATOL = 1e-5, 1e-8
BC_RTOL, BC_ATOL_REL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def layout(name):
    """(port CSR, JAX layout, port layout on the CPU) of the weighted
    kronecker(7, 8) graph, built once per module run."""
    spec = LAYOUTS[name]
    jcsr = jg.with_random_weights(jg.kronecker(7, 8, seed=1), seed=2)
    pcsr = pg.with_random_weights(pg.kronecker(7, 8, seed=1), seed=2)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    sigma = pcsr.n if spec["full_sigma"] else None
    return (pcsr,
            jf.build_slimsell(jcsr, C=spec["C"], L=spec["L"],
                              sigma=sigma).to_jax(),
            pf.build_slimsell(pcsr, C=spec["C"], L=spec["L"],
                              sigma=sigma).to_torch("cpu"))


def mixed_stream(n, seed=0):
    """Query fields (dicts) of one stream holding all six algorithms: BFS
    in the four semirings and packed, some with parents; SSSP at two
    deltas; CC sel-max twice, boolean lane and packed; PageRank at two
    dampings; k-hop at k = 1 and 2, lane and packed; betweenness."""
    rng = np.random.default_rng(seed)
    roots = [int(r) for r in rng.choice(n, 6, replace=False)]
    qs = []

    def add(**kw):
        q = dict(qid=len(qs), algorithm="bfs", semiring="tropical",
                 root=None, delta=None, need_parents=False, deadline_at=None,
                 submitted_at=0.0)
        q.update(kw)
        qs.append(q)

    for sem in ("tropical", "real", "boolean", "selmax"):
        for i, r in enumerate(roots[:5]):
            add(semiring=sem, root=r, need_parents=i % 2 == 0)
    for r in roots[:5]:
        add(semiring="boolean", root=r, packed=True, need_parents=True)
    for delta in DELTAS:
        for i, r in enumerate(roots[:4]):
            add(algorithm="sssp", semiring="minplus", root=r, delta=delta,
                need_parents=i % 2 == 1)
    add(algorithm="cc", semiring="selmax")
    add(algorithm="cc", semiring="selmax")
    add(algorithm="cc", semiring="boolean")
    add(algorithm="cc", semiring="boolean", packed=True)
    for damping in DAMPINGS:
        add(algorithm="pagerank", semiring="real", damping=damping, tol=1e-6)
    for k, packed in ((1, False), (2, False), (2, True)):
        for r in roots[:3]:
            add(algorithm="khop", semiring="boolean", root=r, k=k,
                packed=packed)
    add(algorithm="betweenness", semiring="real")
    return qs


def run_stream(batcher_mod, dispatch_mod, metrics_mod, tiled, config, qs, *,
               max_inflight, **kw):
    """Drain the stream into slots and dispatch them all: the dispatcher,
    its metrics, and ``{bucket: error type}`` of the refused slots."""
    metrics = metrics_mod.ServingMetrics()
    disp = dispatch_mod.Dispatcher(tiled, config, metrics,
                                   max_inflight=max_inflight,
                                   clock=lambda: 0.0, **kw)
    batcher = batcher_mod.Batcher(max_batch=8)
    for q in qs:
        batcher.add(batcher_mod.Query(**q))
    slots, expired = batcher.drain(0.0)
    assert not expired
    refused = {}
    for slot in slots:
        try:
            disp.dispatch(slot)
        except (ValueError, TypeError, NotImplementedError) as e:
            key = (slot.key.algorithm, slot.key.semiring, slot.key.packed)
            refused[key] = type(e)
    disp.drain()
    return disp, metrics, refused


@functools.lru_cache(maxsize=None)
def jax_run(name, direction):
    """The JAX package's fused dispatcher on the mixed stream (jnp path)."""
    csr, jt, _ = layout(name)
    disp, metrics, refused = run_stream(
        jbatcher, jdispatch, jmetrics, jt,
        JConfig(direction=direction, backend="jnp"), mixed_stream(csr.n),
        max_inflight=2)
    return disp.results, metrics.snapshot(), refused


def port_run(name, config, max_inflight):
    csr, _, pt = layout(name)
    disp, metrics, refused = run_stream(
        pbatcher, pdispatch, pmetrics, pt, config, mixed_stream(csr.n),
        max_inflight=max_inflight, device="cpu")
    return disp.results, metrics.snapshot(), refused


def validate_parents(csr, d, p, root):
    """A BFS tree: the root its own parent, every reached vertex's parent a
    neighbour one level up, unreached vertices -1."""
    assert p.dtype == np.int32 and p[root] == root
    for v in range(csr.n):
        if v == root:
            continue
        if d[v] < 0:
            assert p[v] == -1
        else:
            assert d[p[v]] == d[v] - 1 and p[v] in csr.neighbors(v)


def assert_same_result(csr, j, p, *, selmax_validated=False):
    """One query's result from both packages, within the module's bounds."""
    assert (p.algorithm, p.semiring, p.status, p.buckets, p.delta,
            p.n_components) == (j.algorithm, j.semiring, j.status,
                                j.buckets, j.delta, j.n_components)
    jv = np.asarray(j.values)
    assert p.values.dtype == jv.dtype
    if p.algorithm == "pagerank":
        # the residual's float32 floor, 2 n ulp(max rank), lies within a
        # factor of two of tol on this graph: the sweeps may be one apart
        np.testing.assert_allclose(p.values, jv, rtol=PR_RTOL, atol=PR_ATOL)
        ulp = float(np.spacing(np.float32(jv.max())))
        assert abs(p.residual - j.residual) <= 1e-4 * j.residual \
            + 2 * csr.n * ulp
        assert abs(p.sweeps - j.sweeps) <= 1
    else:
        assert p.sweeps == j.sweeps
        if p.algorithm == "betweenness":
            np.testing.assert_allclose(p.values, jv, rtol=BC_RTOL,
                                       atol=BC_ATOL_REL * float(jv.max()))
        else:
            np.testing.assert_array_equal(p.values, jv)
    assert (p.parents is None) == (j.parents is None)
    if p.parents is None:
        return
    if selmax_validated and p.semiring == "selmax":
        root = int(np.flatnonzero(p.values == 0)[0])
        validate_parents(csr, p.values, p.parents, root)
    else:
        assert p.parents.dtype == np.asarray(j.parents).dtype
        np.testing.assert_array_equal(p.parents, np.asarray(j.parents))


def assert_same_counters(psnap, jsnap, pres, jres, **port_counts):
    """The snapshots' counters and ratios equal, latencies and
    ``submitted`` (the session's counter) aside, and ``port_counts`` in
    place of the JAX package's; ``sweeps_total`` apart by the PageRank
    queries' sweep gaps alone (each PageRank query is a slot of its own)."""
    gap = sum(pres[q].sweeps - j.sweeps for q, j in jres.items()
              if j.algorithm == "pagerank")
    assert psnap["sweeps_total"] - jsnap["sweeps_total"] == gap
    skip = ("submitted", "sweeps_total", "sweeps_per_query")

    def counters(snap):
        return {k: v for k, v in snap.items()
                if not k.startswith("latency") and k not in skip}
    assert counters(psnap) == dict(counters(jsnap), **port_counts)


# ------------------------------------------------------------------ batcher


def batcher_stream(n, seed):
    """Query fields with deadlines: about a third expire at ``now = 5``."""
    rng = np.random.default_rng(seed)
    qs = []
    for qid in range(60):
        alg = ["bfs", "sssp", "khop", "cc", "pagerank", "betweenness"][
            int(rng.integers(0, 6))]
        q = dict(qid=qid, algorithm=alg, semiring="tropical", root=None,
                 delta=None, need_parents=bool(rng.integers(0, 2)),
                 deadline_at=(None, 2.0, 9.0)[int(rng.integers(0, 3))],
                 submitted_at=0.0)
        if alg in ("bfs", "sssp", "khop"):
            q["root"] = qid   # distinct roots: no duplicate in a bucket
        if alg == "sssp":
            q.update(semiring="minplus",
                     delta=float(rng.choice([0.25, 0.5])))
        if alg == "khop":
            q.update(semiring="boolean", k=int(rng.integers(1, 3)),
                     packed=bool(rng.integers(0, 2)))
        if alg == "bfs":
            q["packed"] = bool(rng.integers(0, 2))
            q["semiring"] = "boolean" if q["packed"] else "tropical"
        if alg == "pagerank":
            q.update(semiring="real", damping=float(rng.choice([0.85, 0.5])),
                     tol=1e-6)
        qs.append(q)
    return qs


@pytest.mark.parametrize("max_batch", [1, 3, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_batcher_slots_match_jax(max_batch, seed):
    qs = batcher_stream(512, seed)
    jb, pb = jbatcher.Batcher(max_batch), Batcher(max_batch)
    for q in qs:
        assert dataclasses.astuple(jb.add(jbatcher.Query(**q))) == \
            dataclasses.astuple(pb.add(Query(**q)))
    assert jb.depth() == pb.depth() == len(qs)
    (jslots, jexp), (pslots, pexp) = jb.drain(5.0), pb.drain(5.0)
    assert pb.depth() == 0
    assert [q.qid for q in pexp] == [q.qid for q in jexp] and pexp
    assert len(pslots) == len(jslots)
    for js, ps in zip(jslots, pslots):
        assert dataclasses.astuple(ps.key) == dataclasses.astuple(js.key)
        assert (ps.width, ps.n_real) == (js.width, js.n_real)
        assert [q.qid for q in ps.queries] == [q.qid for q in js.queries]
        if ps.key.algorithm in ("bfs", "sssp", "khop"):
            jr, pr = js.roots(), ps.roots()
            assert pr.dtype == jr.dtype == np.int32
            np.testing.assert_array_equal(pr, jr)


@pytest.mark.parametrize("max_pending", [1, 4])
def test_batcher_queue_full_and_duplicate_root(max_pending):
    fields = dict(algorithm="bfs", semiring="tropical", delta=None,
                  need_parents=False, deadline_at=None, submitted_at=0.0)
    assert pbatcher.QueueFull is QueueFull
    for mod in (jbatcher, pbatcher):
        b = mod.Batcher(max_batch=8, max_pending=max_pending)
        for qid in range(max_pending):
            b.add(mod.Query(qid=qid, root=qid, **fields))
        with pytest.raises(mod.QueueFull, match="submission queue full"):
            b.add(mod.Query(qid=99, root=99, **fields))
        assert b.drain(0.0)[0][0].n_real == max_pending and b.depth() == 0
        b = mod.Batcher(max_batch=8)
        b.add(mod.Query(qid=0, root=7, **fields))
        with pytest.raises(ValueError, match="root 7 is already pending"):
            b.add(mod.Query(qid=1, root=7, **fields))
    with pytest.raises(ValueError):
        Batcher(max_batch=0)
    with pytest.raises(ValueError):
        Batcher(max_pending=0)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 33, 64])
def test_next_pow2_matches_jax(k):
    assert pbatcher.next_pow2(k) == jbatcher.next_pow2(k)


def test_metrics_snapshot_matches_jax():
    jm, pm = jmetrics.ServingMetrics(), ServingMetrics()
    assert pm.snapshot().keys() == jm.snapshot().keys()
    for m in (jm, pm):
        m.inc(submitted=5, completed=4, timeouts=1, batches_dispatched=2,
              columns_total=8, columns_real=5, compile_cache_misses=2,
              sweeps_total=17)
        for lat in (0.003, 0.001, 0.002, 0.010):
            m.record_latency(lat)
    js, ps = jm.snapshot(queue_depth=3, inflight=1), \
        pm.snapshot(queue_depth=3, inflight=1)
    assert ps == js


# --------------------------------------------------------------- dispatcher


@pytest.mark.parametrize("max_inflight", [0, 2])
@pytest.mark.parametrize("direction", ["push", "auto"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dispatcher_matches_jax(name, direction, max_inflight):
    """The mixed stream through both dispatchers (fused mode): every result
    within the module's bounds, the same buckets refused with the same
    error type (packed sweeps and betweenness under auto), the same
    counters."""
    csr = layout(name)[0]
    jres, jsnap, jrefused = jax_run(name, direction)
    pres, psnap, prefused = port_run(name, EngineConfig(direction=direction),
                                     max_inflight)
    assert prefused == jrefused
    assert bool(prefused) == (direction == "auto")
    assert pres.keys() == jres.keys()
    for qid, j in jres.items():
        assert_same_result(csr, j, pres[qid],
                           selmax_validated=direction == "auto")
    assert_same_counters(psnap, jsnap, pres, jres)
    assert psnap["compile_cache_misses"] > 0


@pytest.mark.parametrize("max_inflight", [0, 2])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_hostloop_stream_matches_jax_fused_and_front_doors(name, max_inflight):
    """The port's hostloop stream runs every slot through its front doors:
    held against the JAX package's fused dispatcher (the same results and
    counters, no handle) and against a per-query front-door call."""
    csr, _, pt = layout(name)
    cfg = EngineConfig(mode="hostloop")
    jres, jsnap, _ = jax_run(name, "push")
    pres, psnap, prefused = port_run(name, cfg, max_inflight)
    assert not prefused and pres.keys() == jres.keys()
    for qid, j in jres.items():
        assert_same_result(csr, j, pres[qid])
    assert_same_counters(psnap, jsnap, pres, jres, compile_cache_hits=0,
                         compile_cache_misses=0)
    for q in mixed_stream(csr.n):
        got = pres[q["qid"]]
        root, alg = q["root"], q["algorithm"]
        if alg == "bfs":
            ref = bfs(pt, root, q["semiring"], need_parents=q["need_parents"],
                      packed=q.get("packed", False), config=cfg, device="cpu")
            np.testing.assert_array_equal(got.values, ref.distances)
            if q["need_parents"]:
                np.testing.assert_array_equal(got.parents, ref.parents)
        elif alg == "sssp":
            ref = sssp(pt, root, delta=q["delta"],
                       need_parents=q["need_parents"], config=cfg,
                       device="cpu")
            np.testing.assert_array_equal(got.values, ref.distances)
            assert (got.sweeps, got.buckets) == (ref.sweeps, ref.buckets)
            if q["need_parents"]:
                np.testing.assert_array_equal(got.parents, ref.parents)
        elif alg == "khop":
            ref = khop(pt, root, q["k"], packed=q.get("packed", False),
                       config=cfg, device="cpu")
            np.testing.assert_array_equal(got.values, ref.distances)
        elif alg == "cc":
            ref = cc(pt, semiring=q["semiring"], packed=q.get("packed", False),
                     config=cfg, device="cpu")
            np.testing.assert_array_equal(got.values, ref.labels)
            assert (got.sweeps, got.n_components) == (ref.iterations,
                                                      ref.n_components)
        elif alg == "pagerank":
            ref = pagerank(pt, damping=q["damping"], tol=q["tol"], config=cfg,
                           device="cpu")
            np.testing.assert_array_equal(got.values, ref.ranks)
            assert got.sweeps == ref.iterations
        else:
            ref = betweenness(pt, config=cfg, device="cpu")
            np.testing.assert_array_equal(got.values, ref.scores)
            assert got.sweeps == ref.iterations


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_cache_hit_serves_its_own_constants(name):
    """Two dampings and two deltas in one drain: the second bucket of each
    hits the first one's handle, and each result equals its own front-door
    call, bit for bit."""
    csr, _, pt = layout(name)
    roots = [3, 17, 40, 99]
    qs = [dict(qid=i, algorithm="pagerank", semiring="real", root=None,
               delta=None, need_parents=False, deadline_at=None,
               submitted_at=0.0, damping=a, tol=1e-6)
          for i, a in enumerate(DAMPINGS)]
    for delta in DELTAS:
        for r in roots:
            qs.append(dict(qid=len(qs), algorithm="sssp", semiring="minplus",
                           root=r, delta=delta, need_parents=True,
                           deadline_at=None, submitted_at=0.0))
    disp, metrics, refused = run_stream(pbatcher, pdispatch, pmetrics, pt,
                                        EngineConfig(), qs, max_inflight=2,
                                        device="cpu")
    assert not refused
    assert (metrics.compile_cache_misses, metrics.compile_cache_hits) == (2, 2)
    ranks = []
    for i, a in enumerate(DAMPINGS):
        ref = pagerank(pt, damping=a, tol=1e-6, device="cpu")
        got = disp.results[i]
        np.testing.assert_array_equal(got.ranks, ref.ranks)
        assert got.sweeps == ref.iterations
        assert got.residual == float(ref.residuals[-1])
        ranks.append(got.ranks)
    assert not np.array_equal(*ranks)
    for j, delta in enumerate(DELTAS):
        ref = multi_source_sssp(pt, roots, delta=delta, need_parents=True,
                                device="cpu")
        for i in range(len(roots)):
            got = disp.results[2 + j * len(roots) + i]
            assert got.delta == delta
            np.testing.assert_array_equal(got.distances, ref.distances[i])
            np.testing.assert_array_equal(got.parents, ref.parents[i])
            assert (got.sweeps, got.buckets) == (ref.sweeps[i], ref.buckets[i])
    sweeps = [[disp.results[2 + j * len(roots) + i].sweeps
               for i in range(len(roots))] for j in range(2)]
    assert sweeps[0] != sweeps[1]


# ------------------------------------------------ pipelining (fake clock)


class FakeClock:
    """Deterministic monotonic time for deadline and latency tests."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _slot(qids_roots, clock, *, deadline_at=None, width=None):
    queries = [Query(qid=qid, algorithm="bfs", semiring="tropical",
                     root=root, delta=None, need_parents=False,
                     deadline_at=deadline_at, submitted_at=clock())
               for qid, root in qids_roots]
    return BatchSlot(key=BucketKey("bfs", "tropical"),
                     queries=queries, width=width or len(queries))


def _dispatcher(clock, max_inflight):
    metrics = ServingMetrics()
    return Dispatcher(layout("C8L16")[2], EngineConfig(), metrics,
                      max_inflight=max_inflight, clock=clock,
                      device="cpu"), metrics


def test_max_inflight_bounds_inflight_slots():
    clock = FakeClock()
    disp, metrics = _dispatcher(clock, max_inflight=2)
    for k in range(5):
        disp.dispatch(_slot([(k, k)], clock))
        assert disp.inflight() <= 2
    # 5 dispatched, bound 2 -> exactly 3 were force-harvested
    assert disp.inflight() == 2
    disp.drain()
    assert disp.inflight() == 0
    assert metrics.batches_dispatched == 5


def test_harvest_order_matches_submit_order_per_bucket():
    """With max_inflight=2, dispatching slot k+2 harvests exactly slot k
    (FIFO), so results appear in submit order."""
    clock = FakeClock()
    disp, _ = _dispatcher(clock, max_inflight=2)
    completion = []
    publish = disp._publish

    def traced_publish(result):
        completion.append(result.qid)
        publish(result)

    disp._publish = traced_publish
    for k in range(6):
        disp.dispatch(_slot([(k, k)], clock))
        # slots 0..k-2 are harvested, the trailing two still in flight
        assert completion == list(range(max(0, k - 1)))
    disp.drain()
    assert completion == list(range(6))


def test_zero_inflight_is_fully_synchronous():
    clock = FakeClock()
    disp, _ = _dispatcher(clock, max_inflight=0)
    disp.dispatch(_slot([(0, 3)], clock))
    assert disp.inflight() == 0 and 0 in disp.results
    want = bfs(layout("C8L16")[2], 3, device="cpu").distances
    np.testing.assert_array_equal(disp.results[0].values, want)


def test_fake_clock_decides_deadline_at_harvest():
    """An in-flight deadline expiry is decided by the injected clock: the
    result degrades to a timeout carrying the late values."""
    clock = FakeClock(100.0)
    disp, metrics = _dispatcher(clock, max_inflight=1)
    disp.dispatch(_slot([(0, 1)], clock, deadline_at=100.5))
    clock.advance(1.0)               # deadline passes while in flight
    disp.dispatch(_slot([(1, 2)], clock, deadline_at=103.0))
    disp.drain()
    late, ok = disp.results[0], disp.results[1]
    pt = layout("C8L16")[2]
    assert late.status == "timeout"
    np.testing.assert_array_equal(late.values,
                                  bfs(pt, 1, device="cpu").distances)
    assert late.latency_s == pytest.approx(1.0)
    with pytest.raises(DeadlineExpired) as exc:
        late.distances
    assert exc.value.result is late
    assert ok.status == "ok"
    assert ok.latency_s == pytest.approx(0.0)
    assert metrics.timeouts == 1 and metrics.completed == 1


def test_expire_and_shed_complete_without_values():
    clock = FakeClock(10.0)
    disp, metrics = _dispatcher(clock, max_inflight=1)
    q = _slot([(5, 4), (6, 7)], FakeClock(8.0)).queries
    disp.expire(q[0])
    disp.shed(q[1])
    gone, shed = disp.results[5], disp.results[6]
    assert (gone.status, gone.values, gone.latency_s) == ("timeout", None, 2.0)
    assert (shed.status, shed.values) == ("shed", None)
    with pytest.raises(QueryShed):
        shed.raise_for_status()
    snap = metrics.snapshot()
    assert (snap["timeouts"], snap["shed"], snap["completed"]) == (1, 1, 0)
    assert metrics.latencies_s == [2.0]


@pytest.mark.parametrize("status", QUERY_STATUSES)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_query_result_accessors_match_jax(algorithm, status):
    """The typed accessors: which raise AttributeError, DeadlineExpired or
    QueryShed, for every algorithm and status, as in the JAX package."""
    values = np.arange(4)

    def outcome(cls, access):
        r = cls(qid=1, algorithm=algorithm, semiring="tropical",
                status=status, values=values)
        try:
            out = access(r)
        except AttributeError:
            return "AttributeError"
        except RuntimeError as e:
            return type(e).__name__
        return "values" if out is values else out

    for access in (lambda r: r.distances, lambda r: r.labels,
                   lambda r: r.ranks, lambda r: r.scores, lambda r: r.ok):
        assert outcome(QueryResult, access) == \
            outcome(jdispatch.QueryResult, access)
    with pytest.raises(ValueError):
        QueryResult(qid=1, algorithm=algorithm, semiring="tropical",
                    status="lost", values=None)


# ---------------------------------------------------------- fixpoint handles


def test_fixpoint_handle_concurrent_first_call_builds_once():
    """Threads missing on the same new signature build one handle: the
    once-guard records exactly one cache miss, and every thread gets the
    same handle object."""
    kwargs = dict(slimwork=True, max_iters=7919, direction="push",
                  batch_width=None)
    before = peng._fixpoint_handle_cached.cache_info()
    barrier = threading.Barrier(8)
    handles, errors = [], []
    lock = threading.Lock()

    def worker():
        try:
            barrier.wait(timeout=10)
            h = peng.fixpoint_handle(CC_SPEC, **kwargs)
            with lock:
                handles.append(h)
        except Exception as e:  # noqa: BLE001 - surfaced via errors
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    after = peng._fixpoint_handle_cached.cache_info()
    assert len(handles) == 8
    assert all(h is handles[0] for h in handles)
    assert after.misses - before.misses == 1


def _pagerank_factory(tiled, damping, tol):
    return pagerank_spec(tiled.n, damping, tol, *pagerank_views(tiled.deg))


# (spec or factory, its per-run constants, arg: "roots" or 0, direction)
HANDLE_CASES = {
    "cc": (CC_SPEC, (), 0, "push"),
    "pagerank": (_pagerank_factory, (0.7, 1e-6), 0, "push"),
    "multi_bfs tropical push": (multi_bfs_spec("tropical"), (), "roots",
                                "push"),
    "multi_bfs selmax pull": (multi_bfs_spec("selmax"), (), "roots", "pull"),
    "multi_bfs real auto": (multi_bfs_spec("real"), (), "roots", "auto"),
    "packed": (packed_multi_bfs_spec(4), (), "roots", "push"),
    "multi_sssp": (multi_sssp_spec, (0.5,), "roots", "push"),
}


@pytest.mark.parametrize("case", sorted(HANDLE_CASES))
def test_handle_run_equals_run_fused(case):
    """The handle drives a state through run_fused's own loop: the same
    state and iterations, and one handle per signature."""
    spec, ctx_args, arg, direction = HANDLE_CASES[case]
    pt = layout("C8L16")[2]
    arg = torch.tensor([3, 17, 40, 99], dtype=torch.int32) \
        if arg == "roots" else arg
    width = None if isinstance(arg, int) else 4
    handle = peng.fixpoint_handle(spec, max_iters=4 * pt.n + 16,
                                  direction=direction, batch_width=width)
    assert handle is peng.fixpoint_handle(spec, max_iters=4 * pt.n + 16,
                                          direction=direction,
                                          batch_width=width)
    ctx = handle.setup(pt, ctx_args)
    state, iters = handle.run(pt, ctx, handle.init_state(pt, arg, ctx))
    ref = peng.run_fused(ctx, pt, arg, max_iters=4 * pt.n + 16,
                         direction=direction)
    assert iters == ref.iterations > 0
    assert state.keys() == ref.state.keys()
    for k, v in ref.state.items():
        assert torch.equal(state[k], v), k


def test_handle_refuses_a_mismatched_signature():
    pt = layout("C8L16")[2]
    with pytest.raises(ValueError, match="batched specs need batch_width"):
        peng.fixpoint_handle(multi_bfs_spec("tropical"), max_iters=5)
    with pytest.raises(ValueError, match="per-run constants"):
        peng.fixpoint_handle(CC_SPEC, max_iters=5).setup(pt, (0.5,))
    with pytest.raises(ValueError, match="push-only"):
        peng.fixpoint_handle(multi_sssp_spec, max_iters=5, direction="pull",
                             batch_width=4).setup(pt, (0.5,))
    with pytest.raises(ValueError, match="direction"):
        peng.fixpoint_handle(CC_SPEC, max_iters=5, direction="sideways")
