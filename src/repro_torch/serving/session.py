"""``GraphSession``: the front door for running queries against one
resident SlimSell graph.

The session owns what the per-algorithm front doors make every caller
re-thread: the layout on its device (one SlimSell instance shared by BFS,
SSSP, CC, PageRank, betweenness and k-hop), the ``EngineConfig``, the
shape-bucketed ``Batcher``, the handle-caching ``Dispatcher`` and the
``ServingMetrics`` block.

Two usage styles share one dispatch path:

* **Direct**: ``sess.bfs(root)`` / ``sess.sssp(root)`` / ``sess.cc()``
  submit one query and drain at once: per-call semantics on the resident
  layout. The Graph500 harnesses run on ``bfs_many`` and ``sssp``.
* **Streamed**: ``h = sess.submit("bfs", root, deadline=0.05)`` enqueues
  and returns a ``QueryHandle``; queries accumulate in shape buckets until
  ``flush()`` (dispatch the pending batches, harvesting one step late) or
  ``drain()`` (dispatch and harvest everything). ``h.result()`` drains as
  needed and never hangs: every submitted query ends as a ``QueryResult``,
  ``status="timeout"`` if its deadline passed first.

Threading:

* ``submit`` is safe from any number of producer threads: the qid, the
  duplicate-root check and the bounded queue's capacity check are one
  atomic step.
* ``background=True`` starts a **flush thread** that owns the hand-off from
  the submission queue to the dispatcher: it sleeps on a condition
  variable, wakes on every submit (or every ``flush_interval`` seconds,
  the batching window that also retires queued deadlines), and drains the
  batcher into the dispatcher, so it is the thread that launches the
  kernels. ``handle.result()`` waits on the dispatcher's ``results_ready``
  condition and forces a harvest of the batches in flight when the queue
  has gone quiet.
* The submission queue is **bounded** when ``max_pending`` is set:
  ``on_full="raise"`` gives the producer the typed ``QueueFull``
  (backpressure), ``on_full="shed"`` accepts the submit and completes it
  at once as a ``status="shed"`` result (load shedding).
* ``close()`` is idempotent: it stops the flush thread, drains every
  queued and in-flight query, drops the results map and leaves the
  session closed, where ``submit`` raises the typed ``SessionClosed``.

Locks, always taken in this order: ``_submit_lock`` (qids, the closed
flag), then the dispatcher's ``lock``; ``_flush_lock`` (the batcher-to-
dispatcher hand-off), then the dispatcher's ``lock``. No thread holds the
dispatcher's lock while it takes either session lock.

The session runs on its layout's device: ``device=None`` means the card
(it raises when there is none), as for every entry point of the port. A
layout already on that device is used as it is, never copied. Unlike the
JAX package's session it takes the engine knobs as ``config=`` only: the
port has no backend option and no deprecated per-call ``direction=`` /
``mode=`` keywords.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from ..core.bfs import on_device
from ..core.formats import (CSRGraph, SlimSellTiled, build_csr, build_slimsell,
                            layout_signature, resolve_device)
from ..core.options import (ALGORITHMS, BFS_SEMIRINGS, CC_SEMIRINGS,
                            EngineConfig, check_choice)
from ..core.sssp import _require_weighted, _resolve_delta
from .batcher import Batcher, Query, QueueFull
from .dispatch import Dispatcher, QueryResult
from .metrics import ServingMetrics

GraphLike = Union[np.ndarray, CSRGraph, SlimSellTiled]

# backpressure policies for a bounded submission queue (max_pending set)
ON_FULL_POLICIES = ("raise", "shed")


class SessionClosed(RuntimeError):
    """Typed error for using a ``GraphSession`` after ``close()``.

    Raised by ``submit`` (and the facades built on it) and by ``result``
    for qids whose results were dropped at close. ``close()`` itself is
    idempotent: closing twice is a no-op, not an error.
    """


class QueryHandle:
    """A submitted query's future. ``result()`` flushes or drains the
    session as needed and returns the ``QueryResult``; it never hangs
    (expired queries come back as typed timeouts)."""

    def __init__(self, session: "GraphSession", query: Query):
        self._session = session
        self.qid = query.qid
        self.query = query

    @property
    def done(self) -> bool:
        return self.qid in self._session._results

    def result(self) -> QueryResult:
        return self._session.result(self.qid)

    def __repr__(self):
        state = "done" if self.done else "pending"
        return (f"QueryHandle(qid={self.qid}, "
                f"algorithm={self.query.algorithm!r}, {state})")


class GraphSession:
    """One resident graph and one engine config serving many queries.

    graph: an ``[m, 2]`` edge array (int), a built ``CSRGraph``, or a
    ``SlimSellTiled`` on the host or on ``device``. Edge arrays build an
    undirected CSR with ``n = max vertex id + 1``; pass ``weights``
    alongside for SSSP-capable sessions.
    config: one ``EngineConfig`` (default ``EngineConfig()``).
    max_batch: widest batch slot the batcher dispatches (power-of-two
    widths up to this).
    max_inflight: run but unharvested batches kept in flight (0 = every
    batch harvested at once).
    max_pending: bound on the submission queue (None = unbounded); with a
    bound, ``on_full`` picks the overflow policy, ``"raise"`` (typed
    ``QueueFull``) or ``"shed"`` (typed ``status="shed"`` results).
    background: start the flush thread (see the module docstring); it
    wakes on submit and at least every ``flush_interval`` seconds.
    clock: monotonic-time source for deadlines and latencies (tests inject
    a fake clock).
    device: where the layout lives and the sweeps run; None means the card.
    """

    def __init__(self, graph: GraphLike, *, config: Optional[EngineConfig] = None,
                 weights: Optional[np.ndarray] = None,
                 max_batch: int = 64, max_inflight: int = 1,
                 max_pending: Optional[int] = None, on_full: str = "raise",
                 background: bool = False, flush_interval: float = 0.002,
                 slimwork: bool = True, C: int = 8, L: int = 128,
                 clock: Optional[Callable[[], float]] = None, device=None):
        self.config = config if config is not None else EngineConfig()
        check_choice("on_full", on_full, ON_FULL_POLICIES)
        self.on_full = on_full
        self.tiled = _coerce_graph(graph, weights=weights, C=C, L=L,
                                   device=device)
        self.layout_signature = layout_signature(self.tiled)
        self.metrics = ServingMetrics()
        self._clock = clock or time.monotonic
        self.batcher = Batcher(max_batch=max_batch, max_pending=max_pending)
        self.dispatcher = Dispatcher(self.tiled, self.config, self.metrics,
                                     slimwork=slimwork,
                                     max_inflight=max_inflight,
                                     clock=self._clock,
                                     device=self.tiled.device)
        self.device = self.dispatcher.device
        self._next_qid = 0
        self._results: Dict[int, QueryResult] = self.dispatcher.results
        # _submit_lock makes (closed check, qid, enqueue) atomic against
        # other producers and against close(); _flush_lock makes
        # (batcher.drain -> dispatch every slot) atomic against drain(), so
        # a result() never sees a query that left the batcher but has not
        # reached the dispatcher yet
        self._submit_lock = threading.Lock()
        self._flush_lock = threading.RLock()
        self._closed = False
        self._flush_thread: Optional[threading.Thread] = None
        self._wake = threading.Condition()
        self._stop = False
        self._flush_interval = float(flush_interval)
        if background:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, name="graphsession-flush",
                daemon=True)
            self._flush_thread.start()

    # -------------------------------------------------------------- submit

    def submit(self, algorithm: str, root: Optional[int] = None, *,
               semiring: Optional[str] = None, delta: Optional[float] = None,
               need_parents: bool = False, packed: bool = False,
               k: Optional[int] = None, damping: Optional[float] = None,
               tol: Optional[float] = None,
               deadline: Optional[float] = None) -> QueryHandle:
        """Enqueue one query; returns its handle. All validation is here, at
        the boundary: unknown algorithm or semiring, roots out of range or
        missing, duplicate roots in the pending bucket, weights missing for
        sssp; nothing invalid reaches a batch. Thread-safe.

        deadline: seconds from now; a query still queued (or in flight)
        when it lapses completes as ``status="timeout"``.

        packed: SlimSell-B, the bit-packed boolean path (32 vertices a
        word). Valid for boolean bfs, boolean cc and khop only; packed
        queries bucket apart from lane queries and need a push config.

        k: khop depth cap (required for ``algorithm="khop"``; ``k >= 0``).
        damping / tol: PageRank's teleport factor in (0, 1) (default 0.85)
        and L1-residual threshold (default 1e-6); ``"pagerank"`` only.

        Raises ``SessionClosed`` after ``close()`` and ``QueueFull`` when a
        bounded queue overflows under ``on_full="raise"``; under
        ``on_full="shed"`` the overflowing query completes at once as a
        typed ``status="shed"`` result instead.
        """
        check_choice("algorithm", algorithm, ALGORITHMS)
        n = self.tiled.n
        if algorithm in ("cc", "pagerank", "betweenness"):
            if root is not None:
                raise ValueError(f"{algorithm} is a whole-graph query; "
                                 "root must be None")
        else:
            if root is None:
                raise ValueError(f"{algorithm} needs a root vertex")
            root = int(root)
            if not 0 <= root < n:
                raise ValueError(f"root {root} out of range for n={n}")
        if algorithm == "cc":
            semiring = check_choice("cc semiring", semiring or "selmax",
                                    CC_SEMIRINGS)
        if algorithm == "bfs":
            semiring = check_choice("semiring", semiring or "tropical",
                                    BFS_SEMIRINGS)
        if algorithm == "sssp":
            if semiring not in (None, "minplus"):
                raise ValueError(f"sssp runs on the minplus semiring only, "
                                 f"got {semiring!r}")
            semiring = "minplus"
            _require_weighted(self.tiled)
            delta = _resolve_delta(self.tiled, delta)
        elif delta is not None:
            raise ValueError(f"delta is an sssp knob; {algorithm} ignores it")
        if algorithm == "pagerank":
            semiring = check_choice("pagerank semiring", semiring or "real",
                                    ("real",),
                                    hint="PageRank is the damped real-"
                                         "semiring iteration")
            damping = 0.85 if damping is None else float(damping)
            tol = 1e-6 if tol is None else float(tol)
            if not 0.0 < damping < 1.0:
                raise ValueError(
                    f"pagerank: damping must be in (0, 1), got {damping}")
            if not tol > 0.0:
                raise ValueError(f"pagerank: tol must be > 0, got {tol}")
        elif damping is not None or tol is not None:
            raise ValueError(f"damping/tol are pagerank knobs; "
                             f"{algorithm} ignores them")
        if algorithm == "betweenness":
            semiring = check_choice("betweenness semiring",
                                    semiring or "real", ("real",),
                                    hint="Brandes sweeps run on the real "
                                         "(path-counting) semiring")
        if algorithm == "khop":
            semiring = check_choice("khop semiring", semiring or "boolean",
                                    ("boolean",),
                                    hint="k-hop filters are depth-capped "
                                         "boolean BFS")
            if k is None:
                raise ValueError("khop needs a depth cap k (k >= 0)")
            k = int(k)
            if k < 0:
                raise ValueError(f"khop: k must be >= 0, got {k}")
        elif k is not None:
            raise ValueError(f"k is a khop knob; {algorithm} ignores it")
        if packed:
            if algorithm not in ("bfs", "cc", "khop") \
                    or semiring != "boolean":
                raise ValueError(
                    "packed=True is the SlimSell-B bit-packed boolean path; "
                    f"it serves boolean bfs/cc/khop only, not {algorithm} on "
                    f"{semiring!r}")
            if self.config.direction != "push":
                raise ValueError(
                    "packed=True needs a push-direction config (the packed "
                    f"sweep is push-only), got {self.config.direction!r}")
        now = self._clock()
        with self._submit_lock:
            if self._closed:
                raise SessionClosed(
                    "session is closed; submit() after close() is invalid")
            query = Query(
                qid=self._next_qid, algorithm=algorithm, semiring=semiring,
                root=root, delta=delta, need_parents=bool(need_parents),
                deadline_at=None if deadline is None else now + float(deadline),
                submitted_at=now, packed=bool(packed), k=k,
                damping=damping, tol=tol)
            try:
                self.batcher.add(query)
            except QueueFull:
                if self.on_full == "raise":
                    raise
                # shed policy: the query is accepted and completed at once
                # as a typed shed result (no column, no dispatch)
                self._next_qid += 1
                self.metrics.inc(submitted=1)
                self.dispatcher.shed(query)
                return QueryHandle(self, query)
            self._next_qid += 1
            self.metrics.inc(submitted=1)
        self._notify_flush_thread()
        return QueryHandle(self, query)

    def _notify_flush_thread(self) -> None:
        if self._flush_thread is not None:
            with self._wake:
                self._wake.notify()

    # ------------------------------------------------------------ dispatch

    def flush(self) -> None:
        """Cut the pending queries into batch slots and run them. Queued
        queries past their deadline complete as timeouts; run batches
        beyond ``max_inflight`` are harvested (one step late). Thread-safe:
        the flush thread calls just this."""
        with self._flush_lock:
            slots, expired = self.batcher.drain(self._clock())
            for q in expired:
                self.dispatcher.expire(q)
            for slot in slots:
                self.dispatcher.dispatch(slot)

    def drain(self) -> None:
        """flush() and harvest every batch still in flight."""
        with self._flush_lock:
            self.flush()
            self.dispatcher.drain()

    def result(self, qid: int) -> QueryResult:
        """The result of a submitted query id, draining if necessary.

        With a flush thread, first waits one batching window on the
        dispatcher's ``results_ready`` condition (dispatch happens on the
        flush thread), then forces a drain so that a batch in flight with
        no successor still harvests: the call never hangs.
        """
        if qid not in self._results:
            with self._submit_lock:
                if qid >= self._next_qid:
                    raise KeyError(f"unknown query id {qid}")
            if self._flush_thread is not None:
                with self.dispatcher.results_ready:
                    if qid not in self._results:
                        self.dispatcher.results_ready.wait(
                            timeout=max(self._flush_interval, 1e-3))
            if qid not in self._results:
                # drain() flushes every queued query and harvests every
                # batch in flight, so any allocated qid has a result after
                self.drain()
        try:
            return self._results[qid]
        except KeyError:
            if self._closed:
                raise SessionClosed(
                    f"session closed; result for query {qid} was "
                    f"dropped") from None
            raise KeyError(f"unknown query id {qid}") from None

    # ----------------------------------------------------------- lifecycle

    def _flush_loop(self) -> None:
        """The flush thread: sleep on the condition variable, wake on submit
        or after one batching window, drain the queue. The periodic wake
        retires queued deadlines when no traffic comes."""
        while True:
            with self._wake:
                if self._stop:
                    break
                self._wake.wait(timeout=self._flush_interval)
                if self._stop:
                    break
            if self.batcher.depth():
                # one short accumulation window after the wake, so that a
                # burst of submits rides one wide batch instead of many
                # width-1 slots (capped so that close() never waits long)
                time.sleep(min(self._flush_interval, 0.005))
                self.flush()

    def stats(self) -> dict:
        """Counters and gauges snapshot (see ``ServingMetrics.snapshot``)."""
        return self.metrics.snapshot(queue_depth=self.batcher.depth(),
                                     inflight=self.dispatcher.inflight())

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop the flush thread, harvest everything queued and in flight,
        and drop the results map. Idempotent: a second ``close()`` is a
        no-op; only ``submit`` after close is an error (``SessionClosed``).
        The flush thread ends after the flush it may be running, whose
        sweeps always finish."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        if self._flush_thread is not None:
            with self._wake:
                self._stop = True
                self._wake.notify_all()
            self._flush_thread.join()
            self._flush_thread = None
        self.drain()
        with self.dispatcher.lock:
            self._results.clear()

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- facades

    def bfs(self, root: int, semiring: str = "tropical", *,
            need_parents: bool = False, packed: bool = False) -> QueryResult:
        """One BFS, served through the batch path (a width-1 slot)."""
        h = self.submit("bfs", root, semiring=semiring,
                        need_parents=need_parents, packed=packed)
        return h.result()

    def bfs_many(self, roots: Sequence[int], semiring: str = "tropical", *,
                 need_parents: bool = False, packed: bool = False) -> list:
        """BFS from every root as one submit wave: the batcher packs them
        into power-of-two batches, one SpMM sweep advancing each batch."""
        handles = [self.submit("bfs", int(r), semiring=semiring,
                               need_parents=need_parents, packed=packed)
                   for r in roots]
        self.drain()
        return [h.result() for h in handles]

    def sssp(self, roots: Union[int, Sequence[int]], *,
             delta: Optional[float] = None, need_parents: bool = False,
             batch: bool = False):
        """Delta-stepping SSSP. A scalar root returns one ``QueryResult``;
        a root sequence (or ``batch=True``) returns a list, batched through
        the min-plus SpMM path."""
        if np.isscalar(roots) and not batch:
            return self.submit("sssp", int(roots), delta=delta,
                               need_parents=need_parents).result()
        roots_seq = [int(roots)] if np.isscalar(roots) else [int(r) for r in roots]
        handles = [self.submit("sssp", r, delta=delta,
                               need_parents=need_parents) for r in roots_seq]
        self.drain()
        return [h.result() for h in handles]

    def cc(self, semiring: str = "selmax", *,
           packed: bool = False) -> QueryResult:
        """Connected components over the resident layout."""
        return self.submit("cc", semiring=semiring, packed=packed).result()

    def pagerank(self, *, damping: float = 0.85,
                 tol: float = 1e-6) -> QueryResult:
        """Damped PageRank over the resident layout; ``result.ranks`` sums
        to 1. Queries sharing (damping, tol) share one whole-graph run."""
        return self.submit("pagerank", damping=damping, tol=tol).result()

    def betweenness(self) -> QueryResult:
        """Brandes betweenness centrality (all sources, unnormalized);
        ``result.scores`` is the per-vertex BC vector."""
        return self.submit("betweenness").result()

    def khop(self, root: int, k: int, *, packed: bool = False) -> QueryResult:
        """k-hop filter: depth-capped boolean BFS from ``root``.
        ``result.distances`` holds hop counts (-1 outside the ball); the
        membership mask is ``result.distances >= 0``."""
        return self.submit("khop", root, k=k, packed=packed).result()

    def khop_many(self, roots: Sequence[int], k: int, *,
                  packed: bool = False) -> list:
        """k-hop from every root as one submit wave; same-depth queries
        batch into one depth-capped SpMM."""
        handles = [self.submit("khop", int(r), k=k, packed=packed)
                   for r in roots]
        self.drain()
        return [h.result() for h in handles]


def session(graph: GraphLike, **kwargs) -> GraphSession:
    """Build a ``GraphSession``, the package-level entry point:

    >>> import numpy as np
    >>> from repro_torch.serving import session
    >>> sess = session(np.array([[0, 1], [1, 2], [2, 3]]), device="cpu")
    >>> sess.bfs(0).distances.tolist()
    [0, 1, 2, 3]
    """
    return GraphSession(graph, **kwargs)


def _coerce_graph(graph: GraphLike, *, weights, C: int, L: int, device):
    """Edge list / CSR / tiled layout -> SlimSellTiled on ``device``. A host
    layout is moved there once; a layout already there is not copied. The
    device is resolved first, so that a call without a card raises before
    it builds anything."""
    device = resolve_device(device)
    if isinstance(graph, SlimSellTiled):
        if weights is not None:
            raise ValueError("weights must be baked into the tiled layout")
        return on_device(graph, device)
    if isinstance(graph, CSRGraph):
        if weights is not None:
            raise ValueError("weights must be baked into the CSRGraph")
        csr = graph
    else:
        edges = np.asarray(graph)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"edge array must be [m, 2], got {edges.shape}")
        n = int(edges.max()) + 1 if edges.size else 1
        csr = build_csr(edges.astype(np.int64), n, weights=weights)
    return on_device(build_slimsell(csr, C=C, L=L, sigma=csr.n), device)
