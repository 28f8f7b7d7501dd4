"""Batch execution: persistent fixpoint handles, deferred harvest, typed
results.

``Dispatcher`` turns the batcher's ``BatchSlot``s into engine work on one
resident layout:

* **Persistent handles**: each bucket signature (algorithm, semiring,
  batch width, iteration cap) maps to one ``core.engine.FixpointHandle``,
  cached per signature; the hit / miss counters of ``ServingMetrics`` show
  whether the cache is reused. The SSSP bucket width and PageRank's
  damping and tol are not part of the signature: the handle binds them
  for each run (``setup``), so every PageRank bucket shares one handle and
  none runs another bucket's constants.
* **Deferred harvest**: ``handle.run`` drives the batch to its fixpoint
  on the device and returns once the sweeps are done (the fused loop reads
  its continue flag on the host each iteration). The dispatcher keeps up
  to ``max_inflight`` run batches unharvested; harvest, one batch late in
  submit order (or at ``drain``), does the copies to the host, the parent
  passes (one root at a time, only for the columns whose query asked) and
  the component count.
* **Typed results**: harvest turns the state into per-query
  ``QueryResult``s: the query's column of the batch (equal to a dedicated
  front-door call: batching changes the schedule, never the answer),
  parents on request, per-query sweep and bucket counts, and a ``status``
  from ``options.QUERY_STATUSES``. A query whose deadline passed while
  queued completes as ``status="timeout"`` with no values; one whose
  deadline passed after dispatch completes as ``status="timeout"`` with
  the late values attached. Deadlines are decided at harvest by the
  dispatcher's clock.

The hostloop mode runs synchronously through the front doors (its loop
lives on the host), as do betweenness (two chained fixpoints with host
work between them) and boolean CC (its peeling loop is host control flow).

The dispatcher runs on its layout's device: ``device=None`` means the
card (it raises when there is none), as for every entry point; the
synchronous path passes that device to each front door.

**Threading.** Every public method runs under one ``RLock``, so at most
one thread mutates the in-flight deque, the handle table or the results
map at a time, and the ``results_ready`` condition (on the same lock) is
notified whenever a ``QueryResult`` lands.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, Optional

import numpy as np
import torch

from ..core import engine as eng
from ..core.betweenness import betweenness
from ..core.bfs import dp_transform, on_device
from ..core.cc import CC_SPEC, cc
from ..core.formats import layout_signature
from ..core.khop import khop_many
from ..core.multi_bfs import (_columns_to_host, multi_bfs_spec,
                              multi_source_bfs, packed_multi_bfs_spec)
from ..core.multi_sssp import multi_source_sssp, multi_sssp_spec
from ..core.options import EngineConfig, QUERY_STATUSES, check_choice
from ..core.pagerank import (PAGERANK_MAX_ITERS, pagerank, pagerank_spec,
                             pagerank_views)
from ..core.sssp import sssp_parents
from .batcher import BatchSlot, Query
from .metrics import ServingMetrics


class DeadlineExpired(RuntimeError):
    """Raised by ``QueryResult.raise_for_status`` for timed-out queries.

    Carries the result: ``exc.result.values`` is None when the query
    expired while queued, or the late (complete but past-deadline) data
    when it expired in flight.
    """

    def __init__(self, result: "QueryResult"):
        super().__init__(
            f"query {result.qid} ({result.algorithm}) missed its deadline")
        self.result = result


class QueryShed(RuntimeError):
    """Raised by ``QueryResult.raise_for_status`` for shed queries.

    A shed query was dropped at submit time by the bounded-queue
    backpressure policy: it never dispatched, so ``exc.result.values`` is
    always None.
    """

    def __init__(self, result: "QueryResult"):
        super().__init__(
            f"query {result.qid} ({result.algorithm}) was shed by "
            f"backpressure (submission queue full)")
        self.result = result


@dataclasses.dataclass
class QueryResult:
    """What one query gets back from the serving layer."""
    qid: int
    algorithm: str
    semiring: str
    status: str                       # one of options.QUERY_STATUSES
    values: Optional[np.ndarray]      # distances (bfs/sssp/khop), labels
    #                                   (cc), ranks (pagerank) or BC scores
    #                                   (betweenness)
    parents: Optional[np.ndarray] = None
    sweeps: int = 0                   # engine sweeps its batch executed
    buckets: Optional[int] = None     # sssp delta buckets (its column)
    delta: Optional[float] = None     # sssp bucket width actually used
    n_components: Optional[int] = None  # cc
    residual: Optional[float] = None  # pagerank final L1 residual
    latency_s: float = 0.0            # submit -> harvest wall time

    def __post_init__(self):
        check_choice("status", self.status, QUERY_STATUSES)

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def raise_for_status(self) -> "QueryResult":
        if self.status == "timeout":
            raise DeadlineExpired(self)
        if self.status == "shed":
            raise QueryShed(self)
        return self

    @property
    def distances(self) -> np.ndarray:
        """BFS/SSSP/khop distance vector; raises on timeout or a query
        whose values are not distances (cc / pagerank / betweenness)."""
        if self.algorithm in ("cc", "pagerank", "betweenness"):
            raise AttributeError(
                f"{self.algorithm} results carry no distance vector")
        self.raise_for_status()
        return self.values

    @property
    def labels(self) -> np.ndarray:
        """CC component labels; raises on timeout or a non-cc query."""
        if self.algorithm != "cc":
            raise AttributeError(f"{self.algorithm} results carry no labels")
        self.raise_for_status()
        return self.values

    @property
    def ranks(self) -> np.ndarray:
        """PageRank vector (sums to 1); raises on a non-pagerank query."""
        if self.algorithm != "pagerank":
            raise AttributeError(f"{self.algorithm} results carry no ranks")
        self.raise_for_status()
        return self.values

    @property
    def scores(self) -> np.ndarray:
        """Betweenness centrality scores; raises on other queries."""
        if self.algorithm != "betweenness":
            raise AttributeError(f"{self.algorithm} results carry no "
                                 "centrality scores")
        self.raise_for_status()
        return self.values


@dataclasses.dataclass
class _Inflight:
    """One run but unharvested fused batch (its state on the device)."""
    slot: BatchSlot
    state: dict
    iters: int


def _pagerank_bound(tiled, damping, tol, inv_deg, dangling):
    """PageRank's spec bound to one bucket's damping and tol (the handle's
    factory: every PageRank bucket shares one handle)."""
    return pagerank_spec(tiled.n, damping, tol, inv_deg, dangling)


class Dispatcher:
    """Executes batch slots on one resident layout under one config."""

    def __init__(self, tiled, config: EngineConfig, metrics: ServingMetrics,
                 *, slimwork: bool = True, max_inflight: int = 1,
                 clock: Optional[Callable[[], float]] = None, device=None):
        self.tiled = on_device(tiled, device)
        self.device = self.tiled.device
        self.config = config
        self.metrics = metrics
        self.slimwork = bool(slimwork)
        self.max_inflight = max(0, int(max_inflight))
        self.results: Dict[int, QueryResult] = {}
        # one RLock serializes dispatch / harvest / results across threads;
        # results_ready (same lock) wakes waiters when a QueryResult lands
        self.lock = threading.RLock()
        self.results_ready = threading.Condition(self.lock)
        self._clock = clock or time.monotonic
        self._inflight: Deque[_Inflight] = collections.deque()
        self._handles: Dict[tuple, eng.FixpointHandle] = {}
        self._layout_sig = layout_signature(self.tiled)
        self._pr_views = None  # lazy (inv_deg, dangling) for pagerank

    def _pagerank_views(self):
        if self._pr_views is None:
            self._pr_views = pagerank_views(self.tiled.deg)
        return self._pr_views

    # ------------------------------------------------------------- handles

    def _handle(self, name: str, spec, *, max_iters: int, direction: str,
                batch_width: Optional[int]) -> eng.FixpointHandle:
        """Handle for a bucket signature, with per-session hit/miss counts
        (``eng.fixpoint_handle`` is itself a process-wide cache; the
        per-session counters are what the fill and churn figures need).
        ``name`` is the spec's, ``spec`` the spec or its factory."""
        key = (name, max_iters, direction, batch_width, self.slimwork,
               self.config.signature(), self._layout_sig)
        with self.lock:
            handle = self._handles.get(key)
            if handle is None:
                self.metrics.inc(compile_cache_misses=1)
                handle = eng.fixpoint_handle(
                    spec, slimwork=self.slimwork, max_iters=max_iters,
                    direction=direction, batch_width=batch_width)
                self._handles[key] = handle
            else:
                self.metrics.inc(compile_cache_hits=1)
        return handle

    # ------------------------------------------------------------ dispatch

    def inflight(self) -> int:
        with self.lock:
            return len(self._inflight)

    def dispatch(self, slot: BatchSlot) -> None:
        """Run one slot; harvest the oldest batch beyond ``max_inflight``.

        Fused BFS / SSSP / sel-max CC / PageRank / k-hop go through the
        handles and wait for harvest; hostloop mode, betweenness and
        boolean CC run synchronously through the front doors and complete
        at once.
        """
        with self.lock:
            self._dispatch_locked(slot)

    def _dispatch_locked(self, slot: BatchSlot) -> None:
        cfg, alg = self.config, slot.key.algorithm
        tiled, n = self.tiled, self.tiled.n
        self.metrics.inc(
            batches_dispatched=1, columns_total=slot.width,
            columns_real=(1 if alg in ("cc", "pagerank", "betweenness")
                          else slot.n_real))

        if cfg.mode == "hostloop" or alg == "betweenness" \
                or (alg == "cc" and slot.key.semiring == "boolean"):
            self._dispatch_sync(slot)
            return

        # the sanitizer (config.sanitize) is entered here, in the thread
        # that runs the slot: a session's flush thread, or the caller
        with cfg.applied():
            if alg == "cc":
                handle = self._handle(CC_SPEC.name, CC_SPEC, max_iters=n + 1,
                                      direction="push", batch_width=None)
                ctx = handle.setup(tiled)
                state = handle.init_state(tiled, 0, ctx)
            elif alg == "pagerank":
                handle = self._handle("pagerank", _pagerank_bound,
                                      max_iters=PAGERANK_MAX_ITERS,
                                      direction="push", batch_width=None)
                ctx = handle.setup(tiled, (slot.key.damping, slot.key.tol,
                                           *self._pagerank_views()))
                state = handle.init_state(tiled, 0, ctx)
            elif alg in ("khop", "bfs"):
                # a k-hop batch is the boolean multi-BFS batch whose
                # iteration cap is the bucket's depth k; packed slots ride
                # the SlimSell-B word planes, whose distances land in the
                # same [n, width] int32
                sem = "boolean" if alg == "khop" else slot.key.semiring
                spec = (packed_multi_bfs_spec(slot.width) if slot.key.packed
                        else multi_bfs_spec(sem))
                handle = self._handle(
                    spec.name, spec,
                    max_iters=int(slot.key.k) if alg == "khop" else n,
                    direction=cfg.direction, batch_width=slot.width)
                ctx = handle.setup(tiled)
                state = handle.init_state(
                    tiled, torch.from_numpy(slot.roots()), ctx)
            else:  # sssp
                handle = self._handle("multi_sssp", multi_sssp_spec,
                                      max_iters=4 * n + 16, direction="push",
                                      batch_width=slot.width)
                ctx = handle.setup(tiled, (slot.key.delta,))
                state = handle.init_state(
                    tiled, torch.from_numpy(slot.roots()), ctx)
            state, iters = handle.run(tiled, ctx, state)
        self._inflight.append(_Inflight(slot=slot, state=state, iters=iters))
        while len(self._inflight) > self.max_inflight:
            self._harvest_one()

    def drain(self) -> None:
        """Harvest every batch still in flight."""
        with self.lock:
            while self._inflight:
                self._harvest_one()

    # ------------------------------------------------------------- harvest

    def _finish(self, query: Query, **fields) -> None:
        now = self._clock()
        status = "ok"
        if query.deadline_at is not None and now >= query.deadline_at:
            status = "timeout"   # late: degraded status, values attached
            self.metrics.inc(timeouts=1)
        else:
            self.metrics.inc(completed=1)
        latency = now - query.submitted_at
        self.metrics.record_latency(latency)
        self._publish(QueryResult(
            qid=query.qid, algorithm=query.algorithm,
            semiring=query.semiring, status=status,
            latency_s=latency, delta=query.delta, **fields))

    def _publish(self, result: QueryResult) -> None:
        with self.lock:
            self.results[result.qid] = result
            self.results_ready.notify_all()

    def expire(self, query: Query) -> None:
        """Complete a queued-expired query with a typed timeout (no values)."""
        now = self._clock()
        self.metrics.inc(timeouts=1)
        self.metrics.record_latency(now - query.submitted_at)
        self._publish(QueryResult(
            qid=query.qid, algorithm=query.algorithm,
            semiring=query.semiring, status="timeout", values=None,
            delta=query.delta, latency_s=now - query.submitted_at))

    def shed(self, query: Query) -> None:
        """Complete a backpressure-dropped query with a typed shed result
        (never dispatched, no values)."""
        now = self._clock()
        self.metrics.inc(shed=1)
        self._publish(QueryResult(
            qid=query.qid, algorithm=query.algorithm,
            semiring=query.semiring, status="shed", values=None,
            delta=query.delta, latency_s=now - query.submitted_at))

    def _harvest_one(self) -> None:
        fl = self._inflight.popleft()
        slot, state, iters = fl.slot, fl.state, fl.iters
        self.metrics.inc(sweeps_total=iters)
        alg, sem, k = slot.key.algorithm, slot.key.semiring, slot.n_real

        if alg == "cc":
            labels = (state["x"].cpu().numpy().astype(np.int64) - 1
                      ).astype(np.int32)
            n_comp = len(np.unique(labels))
            for q in slot.queries:
                self._finish(q, values=labels, sweeps=iters,
                             n_components=n_comp)
            return

        if alg == "pagerank":
            ranks = state["r"].cpu().numpy()
            resid = float(state["resid"])
            for q in slot.queries:
                self._finish(q, values=ranks, sweeps=iters, residual=resid)
            return

        if alg == "khop":
            d = _columns_to_host(state["d"], k)   # [n_real, n]; -1 beyond k
            for col, q in enumerate(slot.queries):
                self._finish(q, values=d[col], sweeps=iters)
            return

        if alg == "bfs":
            d = _columns_to_host(state["d"], k)
            p_sel = None
            if sem == "selmax" and any(q.need_parents for q in slot.queries):
                p_sel = _columns_to_host(state["p"].to(torch.int32) - 1, k)
            for col, q in enumerate(slot.queries):
                parents = None
                if q.need_parents and p_sel is not None:
                    parents = p_sel[col].copy()
                elif q.need_parents:
                    # one DP sweep per asking column, as multi_source_bfs
                    parents = dp_transform(
                        self.tiled, state["d"][:, col].contiguous(),
                        q.root).cpu().numpy()
                if parents is not None:
                    parents[q.root] = q.root
                self._finish(q, values=d[col], parents=parents, sweeps=iters)
            return

        # sssp: per-column sweep / bucket counters equal the per-root runs'
        d = _columns_to_host(state["dist"], k)
        col_sweeps = state["sweeps"].cpu().numpy()
        col_buckets = state["buckets"].cpu().numpy()
        for col, q in enumerate(slot.queries):
            parents = None
            if q.need_parents:
                parents = sssp_parents(self.tiled,
                                       state["dist"][:, col].contiguous(),
                                       q.root).cpu().numpy()
            self._finish(q, values=d[col], parents=parents,
                         sweeps=int(col_sweeps[col]),
                         buckets=int(col_buckets[col]))

    # ------------------------------------------------- synchronous fallback

    def _dispatch_sync(self, slot: BatchSlot) -> None:
        """Hostloop mode, betweenness, boolean CC: run through the front
        doors on the dispatcher's device and complete immediately."""
        cfg, alg, sem = self.config, slot.key.algorithm, slot.key.semiring
        tiled, dev = self.tiled, self.device
        if alg == "cc":
            res = cc(tiled, semiring=sem, slimwork=self.slimwork,
                     packed=slot.key.packed, config=cfg, device=dev)
            self.metrics.inc(sweeps_total=int(res.iterations))
            for q in slot.queries:
                self._finish(q, values=res.labels, sweeps=res.iterations,
                             n_components=res.n_components)
            return
        if alg == "pagerank":
            res = pagerank(tiled, damping=slot.key.damping, tol=slot.key.tol,
                           slimwork=self.slimwork, config=cfg, device=dev)
            self.metrics.inc(sweeps_total=int(res.iterations))
            resid = float(res.residuals[-1]) if res.residuals.size else 0.0
            for q in slot.queries:
                self._finish(q, values=res.ranks, sweeps=res.iterations,
                             residual=resid)
            return
        if alg == "betweenness":
            res = betweenness(tiled, slimwork=self.slimwork, config=cfg,
                              device=dev)
            self.metrics.inc(sweeps_total=int(res.iterations))
            for q in slot.queries:
                self._finish(q, values=res.scores, sweeps=res.iterations)
            return
        roots = [q.root for q in slot.queries]
        need_parents = any(q.need_parents for q in slot.queries)
        if alg == "khop":
            res = khop_many(tiled, roots, slot.key.k, packed=slot.key.packed,
                            batch_size=slot.width, slimwork=self.slimwork,
                            config=cfg, device=dev)
            self.metrics.inc(sweeps_total=int(np.sum(res.iterations)))
            for i, q in enumerate(slot.queries):
                self._finish(q, values=res.distances[i],
                             sweeps=int(np.max(res.iterations)))
            return
        if alg == "bfs":
            res = multi_source_bfs(tiled, roots, sem,
                                   need_parents=need_parents,
                                   slimwork=self.slimwork,
                                   packed=slot.key.packed,
                                   batch_size=slot.width, config=cfg,
                                   device=dev)
            self.metrics.inc(sweeps_total=int(np.sum(res.iterations)))
            for i, q in enumerate(slot.queries):
                self._finish(
                    q, values=res.distances[i],
                    parents=res.parents[i] if q.need_parents else None,
                    sweeps=int(np.max(res.iterations)))
            return
        res = multi_source_sssp(tiled, roots, delta=slot.key.delta,
                                need_parents=need_parents,
                                slimwork=self.slimwork,
                                batch_size=slot.width, config=cfg, device=dev)
        self.metrics.inc(sweeps_total=int(np.sum(res.iterations)))
        for i, q in enumerate(slot.queries):
            self._finish(q, values=res.distances[i],
                         parents=res.parents[i] if q.need_parents else None,
                         sweeps=int(res.sweeps[i]),
                         buckets=int(res.buckets[i]))
