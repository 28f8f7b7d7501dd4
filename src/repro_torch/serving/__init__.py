"""Query serving on resident SlimSell layouts: sessions, a router over
several graphs, shape-bucketed batching, persistent fixpoint handles,
deferred harvest.

A ``GraphSession`` owns one layout on its device and one ``EngineConfig``
and takes a stream of BFS / SSSP / CC / PageRank / betweenness / k-hop
queries (``submit`` -> ``QueryHandle``); its ``Batcher`` buckets them by
execution signature into padded power-of-two batches, its ``Dispatcher``
runs each batch on a cached ``core.engine.FixpointHandle`` (or
synchronously through the front doors in hostloop mode, for betweenness
and for boolean CC) and harvests typed ``QueryResult``s one batch late,
and ``ServingMetrics`` counts fill, handle hits and misses, sweeps and
latencies (``stats()``). The session is thread-safe (an optional
``background=True`` flush thread, a bounded submission queue with typed
``QueueFull`` backpressure or ``status="shed"`` load shedding, an
idempotent ``close()``), and ``Router`` routes by name over several
resident sessions:

    from repro_torch.serving import Router, session
    sess = session(edges, device="cpu")   # None: the card
    sess.bfs(root)                        # one query, served batched
    hs = [sess.submit("bfs", r) for r in roots]
    sess.drain()                          # streamed: shape-bucketed batches
    [h.result() for h in hs]

    with Router(background=True, max_inflight=2, device="cpu") as router:
        router.add_graph("social", edges)
        router.add_graph("roads", road_edges, weights=w)
        router.bfs("social", root)
"""
from . import batcher, dispatch, metrics, router, session  # noqa: F401
from .batcher import (Batcher, BatchSlot, BucketKey, Query,  # noqa: F401
                      QueueFull)
from .dispatch import (DeadlineExpired, Dispatcher,  # noqa: F401
                       QueryResult, QueryShed)
from .metrics import ServingMetrics  # noqa: F401
from .router import Router, UnknownGraph  # noqa: F401
from .session import (GraphSession, QueryHandle, SessionClosed,  # noqa: F401
                      session)
