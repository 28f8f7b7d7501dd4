"""Shape-bucketed batching: turn a stream of heterogeneous queries into a
small set of dense, power-of-two-wide device batches.

One semiring SpMM sweep advances every column of its batch, so the
server's job is to keep batches wide and their shapes few:

* **Bucketing**: queries share a batch only if they share an execution
  signature, ``BucketKey = (algorithm, semiring, delta, packed, k,
  damping, tol)``. The graph and the engine config are session-wide, so
  they are not part of the key. The SSSP bucket width ``delta`` is (the
  columns of one min-plus SpMM batch share one bucket width), the
  SlimSell-B ``packed`` flag is (packed columns travel as bit planes), the
  k-hop depth ``k`` is (it is the batch's iteration cap), and PageRank's
  ``damping`` / ``tol`` are (every query of a width-1 whole-graph dispatch
  reads the same converged vector).
* **Power-of-two widths**: a bucket of k queries dispatches at width
  ``min(next_pow2(k), max_batch)``, padded by repeating the last real root
  (the engine's own padding convention; padded columns are dropped at
  harvest), so the set of batch shapes, and of cached handles, stays
  logarithmic.
* **Deadlines**: ``drain`` separates queries whose deadline passed while
  queued; they are returned for a typed-timeout completion instead of
  taking batch columns.

``Batcher`` holds only pending (not yet dispatched) state. A root already
pending in the same bucket is refused at ``add`` time: the batch would
serve one column twice, a caller bug the padding would otherwise hide.

The batcher is a bounded submission queue: every mutation (``add`` /
``drain`` / ``depth``) runs under one lock, so producer threads and a
flush thread interleave safely, and ``max_pending`` caps the accepted but
undrained queries, ``add`` raising the typed ``QueueFull`` at the cap.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class QueueFull(RuntimeError):
    """Typed backpressure: the bounded submission queue is at capacity.

    Raised by ``Batcher.add`` when ``max_pending`` queries are already
    queued. Catch it to retry after a flush.
    """


@dataclasses.dataclass
class Query:
    """One request in flight: what to run, from where, and by when.
    ``deadline_at`` is an absolute instant on the serving clock (None: no
    deadline); ``submitted_at`` feeds the latency metrics."""
    qid: int
    algorithm: str                 # one of options.ALGORITHMS
    semiring: str
    root: Optional[int]            # None for whole-graph queries
    #                                (cc / pagerank / betweenness)
    delta: Optional[float]         # sssp bucket width (resolved at submit)
    need_parents: bool
    deadline_at: Optional[float]
    submitted_at: float
    packed: bool = False           # SlimSell-B bit-packed boolean sweeps
    k: Optional[int] = None        # khop depth cap (resolved at submit)
    damping: Optional[float] = None  # pagerank teleport factor
    tol: Optional[float] = None      # pagerank L1 residual threshold


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """The execution signature queries must share to ride one batch."""
    algorithm: str
    semiring: str
    delta: Optional[float] = None
    packed: bool = False           # packed columns ride packed word planes
    k: Optional[int] = None        # khop depth: the batch's iteration cap
    damping: Optional[float] = None  # pagerank: the run's constants
    tol: Optional[float] = None


@dataclasses.dataclass
class BatchSlot:
    """One dispatchable batch: a bucket's queries plus its padded width."""
    key: BucketKey
    queries: List[Query]
    width: int                     # power-of-two columns dispatched

    @property
    def n_real(self) -> int:
        return len(self.queries)

    def roots(self) -> np.ndarray:
        """int32[width] root per column, padded by repeating the last real
        root (as ``multi_bfs._iter_batches`` does); harvest reads only the
        first ``n_real`` columns."""
        real = np.asarray([q.root for q in self.queries], np.int32)
        pad = self.width - real.size
        if pad:
            real = np.concatenate([real, np.repeat(real[-1:], pad)])
        return real


def next_pow2(k: int) -> int:
    """Smallest power of two >= k (k >= 1)."""
    if k < 1:
        raise ValueError(f"need a positive count, got {k}")
    return 1 << (k - 1).bit_length()


class Batcher:
    """Accumulates pending queries per bucket; ``drain`` cuts batch slots.

    max_batch: the widest slot ever dispatched (buckets holding more
    queries split into several slots). It need not be a power of two
    itself, but slot widths below it always are.
    max_pending: bound on accepted but undrained queries (None:
    unbounded); ``add`` raises ``QueueFull`` at the cap.
    """

    def __init__(self, max_batch: int = 64,
                 max_pending: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1 or None, "
                             f"got {max_pending}")
        self.max_batch = int(max_batch)
        self.max_pending = None if max_pending is None else int(max_pending)
        self._lock = threading.Lock()
        self._depth = 0
        self._pending: Dict[BucketKey, List[Query]] = {}
        self._roots: Dict[BucketKey, Set[int]] = {}

    def depth(self) -> int:
        """Queue depth: queries accepted but not yet drained into slots."""
        with self._lock:
            return self._depth

    def add(self, query: Query) -> BucketKey:
        """Queue one query (atomic: the capacity check, the duplicate-root
        check and the enqueue happen under one lock hold, so concurrent
        producers cannot both land the same root or overshoot
        ``max_pending``)."""
        key = BucketKey(query.algorithm, query.semiring, query.delta,
                        query.packed, query.k, query.damping, query.tol)
        with self._lock:
            if self.max_pending is not None and self._depth >= self.max_pending:
                raise QueueFull(
                    f"submission queue full ({self._depth} pending >= "
                    f"max_pending={self.max_pending}); flush, or use the "
                    f"session's on_full='shed' policy")
            roots = self._roots.setdefault(key, set())
            if query.root is not None:
                if query.root in roots:
                    raise ValueError(
                        f"root {query.root} is already pending in bucket "
                        f"{(key.algorithm, key.semiring)}; duplicate roots in "
                        "one batch would serve the same column twice")
                roots.add(query.root)
            self._pending.setdefault(key, []).append(query)
            self._depth += 1
        return key

    def drain(self, now: float) -> Tuple[List[BatchSlot], List[Query]]:
        """Cut every pending bucket into dispatchable slots.

        Returns ``(slots, expired)``: expired queries (deadline passed while
        queued) never take a column. Pending state is cleared atomically,
        so each accepted query lands in exactly one drain's slots (or
        expired list) even with producers racing the drain.
        """
        with self._lock:
            pending = self._pending
            self._pending = {}
            self._roots = {}
            self._depth = 0
        slots: List[BatchSlot] = []
        expired: List[Query] = []
        for key, queries in pending.items():
            live = []
            for q in queries:
                if q.deadline_at is not None and now >= q.deadline_at:
                    expired.append(q)
                else:
                    live.append(q)
            for i in range(0, len(live), self.max_batch):
                group = live[i:i + self.max_batch]
                # whole-graph queries (cc / pagerank / betweenness) share one
                # width-1 dispatch: every query in the bucket reads the same
                # whole-graph answer
                width = (1 if key.algorithm in ("cc", "pagerank",
                                                "betweenness")
                         else min(next_pow2(len(group)), self.max_batch))
                slots.append(BatchSlot(key=key, queries=group, width=width))
        return slots, expired
