"""Serving-layer observability: one mutable counter block per session.

What makes the serving layer operable lives here: how full the device
batches run (``batch_fill_ratio``, the number the shape-bucketed batcher
exists to maximize), whether the handle cache is reused
(``compile_cache_hits`` against ``_misses``: a miss per batch means the
bucket widths are churning), queue pressure (``queue_depth``), end-to-end
latency quantiles, and the amortization headline, engine sweeps per served
query.

``ServingMetrics`` is plain ints and a latency list behind one lock:
dispatch, harvest and callers may run on different threads, so every
mutation goes through ``inc()`` / ``record_latency()`` (one short critical
section each) and ``snapshot()`` copies the counters under the same lock.
Once a session is drained its counters reconcile as ``submitted ==
completed + timeouts + shed``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (``snapshot()``
    is the only caller)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


@dataclasses.dataclass
class ServingMetrics:
    """Counters and timers for one serving session.

    * ``submitted`` / ``completed`` / ``timeouts`` / ``shed``: the query
      lifecycle; every submitted query ends in exactly one of completed,
      timeouts or shed (the backpressure drop).
    * ``batches_dispatched``: device batches launched (one fixpoint run
      each).
    * ``columns_total`` / ``columns_real``: batch-slot columns launched
      against columns carrying a real query (the rest is power-of-two
      padding); their ratio is the batch fill ratio.
    * ``compile_cache_hits`` / ``compile_cache_misses``: ``FixpointHandle``
      lookups that found / created a handle for the bucket signature. A
      steady-state stream should be all hits.
    * ``sweeps_total``: engine fixpoint iterations over all batches (one
      sweep advances every column of its batch).
    * ``latencies_s``: per-query submit-to-harvest wall times.

    Mutate through ``inc(counter=delta, ...)``: direct attribute writes
    are not thread-safe.
    """
    submitted: int = 0
    completed: int = 0
    timeouts: int = 0
    shed: int = 0
    batches_dispatched: int = 0
    columns_total: int = 0
    columns_real: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    sweeps_total: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def inc(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to the named counters (one lock hold
        for the whole group, so a batch's dispatched / columns trio lands
        as one consistent event)."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self.latencies_s.append(float(seconds))

    def snapshot(self, *, queue_depth: int = 0, inflight: int = 0) -> dict:
        """One immutable stats payload: counters, ratios and quantiles.

        ``queue_depth`` and ``inflight`` are gauges owned by the session
        (pending queries not yet batched; batches launched but not yet
        harvested), passed in at snapshot time. The counter block is copied
        under the lock, so one snapshot is consistent even while another
        thread harvests.
        """
        with self._lock:
            c = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self) if f.name != "_lock"}
            lat = sorted(c.pop("latencies_s"))
        served = max(1, c["completed"])
        return {
            **c,
            "queue_depth": int(queue_depth),
            "inflight": int(inflight),
            "batch_fill_ratio": (c["columns_real"] / c["columns_total"]
                                 if c["columns_total"] else float("nan")),
            "sweeps_per_query": c["sweeps_total"] / served,
            "latency_mean_ms": (1e3 * sum(lat) / len(lat)) if lat
                               else float("nan"),
            "latency_p50_ms": 1e3 * _percentile(lat, 0.50),
            "latency_p99_ms": 1e3 * _percentile(lat, 0.99),
        }
