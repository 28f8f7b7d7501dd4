"""Query serving on a resident SlimSell layout: shape-bucketed batching,
persistent fixpoint handles, deferred harvest.

``Batcher`` buckets a stream of BFS / SSSP / CC / PageRank / betweenness /
k-hop queries by execution signature and cuts them into padded
power-of-two batches; ``Dispatcher`` runs each batch on a cached
``core.engine.FixpointHandle`` (or synchronously through the front doors
in hostloop mode, for betweenness and for boolean CC) and harvests typed
``QueryResult``s one batch late; ``ServingMetrics`` counts fill, handle
hits and misses, sweeps and latencies.

    from repro_torch.serving import Batcher, Dispatcher, Query, ServingMetrics
    disp = Dispatcher(tiled, EngineConfig(), ServingMetrics(),
                      max_inflight=2, device="cpu")
    batcher = Batcher(max_batch=64)
    for qid, r in enumerate(roots):
        batcher.add(Query(qid, "bfs", "tropical", r, None, False, None, 0.0))
    slots, expired = batcher.drain(now=0.0)
    for slot in slots:
        disp.dispatch(slot)
    disp.drain()
    disp.results[0].distances
"""
from . import batcher, dispatch, metrics  # noqa: F401
from .batcher import (Batcher, BatchSlot, BucketKey, Query,  # noqa: F401
                      QueueFull)
from .dispatch import (DeadlineExpired, Dispatcher,  # noqa: F401
                       QueryResult, QueryShed)
from .metrics import ServingMetrics  # noqa: F401
