"""SlimSell BFS in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``: the tiled SlimSell layout
(``core.formats``), semiring SpMV/SpMM sweeps (``core.spmv``, kernels in
``kernels/``), single-source and batched multi-source BFS (``core.bfs``,
``core.multi_bfs``), weighted single- and multi-source SSSP (``core.sssp``,
``core.multi_sssp``), connected components (``core.cc``), k-hop
neighbourhoods (``core.khop``: ``khop``, ``khop_many``), PageRank
(``core.pagerank``) and Brandes betweenness (``core.betweenness``), the
Graph500 BFS and SSSP harnesses
(``graph500``), the GNNs (``models.gnn``): GCN on the SlimSell
aggregation (the gcn-cora configuration in ``configs.gcn_cora``), GIN on
kernel 2's real SpMM (``configs.gin_tu``), EGNN and NequIP
(``configs.egnn``, ``configs.nequip``), their losses in ``configs.cells``
and the neighbour sampler (``graphs.sampler``), and
DLRM inference with the embedding-bag kernel (``models.dlrm``; the
dlrm-mlperf configuration in ``configs.dlrm_mlperf``), the decoder-only
language models, dense and MoE (``models.transformer`` over
``models.layers`` and ``models.moe``: ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` through a KV cache; smollm-135m,
phi3-mini-3.8b, internlm2-1.8b, llama4-scout and kimi-k2 in ``configs``,
whose registry is ``configs.ARCHS``; ``data.TokenPipeline``; the serving
and training drivers ``launch.serve`` and ``launch.train``), the sharding
layer on ``torch.distributed`` (``models.sharding``: ``AxisRules``, the
specs and the rank's blocks; ``ShardCtx``, under which the dense and
MoE-reference language models serve in heads, context and
sequence-sharded-cache modes and DLRM looks up row-sharded or hybrid
tables; ``launch.mesh``'s production meshes and ``remesh``), and the serving
layer (``serving``: ``GraphSession`` and ``Router`` over the ``Batcher``,
the ``Dispatcher`` on the engine's cached ``FixpointHandle``s and
``ServingMetrics``). The session is the front door the Graph500 harnesses
run through::

    import repro_torch
    sess = repro_torch.session(edges)  # the layout on the card
    sess.bfs(root)                     # BFS / SSSP / CC / ... on one path
    sess.stats()                       # throughput / latency / fill

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions of the kernels.
"""
from .core.betweenness import betweenness
from .core.bfs import bfs
from .core.cc import cc
from .core.formats import build_csr, build_slimsell
from .core.khop import khop, khop_many
from .core.multi_bfs import multi_source_bfs
from .core.multi_sssp import multi_source_sssp
from .core.options import EngineConfig
from .core.pagerank import pagerank
from .core.sssp import sssp
from .graph500 import run_graph500, run_graph500_sssp
from .models.dlrm import DLRMConfig, dlrm_forward, dlrm_init
from .models.gnn import (EGNNConfig, GCNConfig, GINConfig, NequIPConfig,
                         egnn_forward, egnn_init, gcn_forward, gcn_init,
                         gin_forward, gin_init, nequip_forward, nequip_init)
from .models.sharding import AxisRules
from .models.transformer import (LMConfig, ShardCtx, decode_step, forward,
                                 prefill)
from .serving import GraphSession, Router, session

__all__ = ["AxisRules", "DLRMConfig", "EGNNConfig", "EngineConfig", "GCNConfig",
           "GINConfig", "GraphSession", "LMConfig", "NequIPConfig", "Router",
           "betweenness", "bfs", "build_csr", "build_slimsell", "cc",
           "decode_step", "dlrm_forward", "dlrm_init", "egnn_forward",
           "egnn_init", "forward", "gcn_forward", "gcn_init", "gin_forward",
           "gin_init", "khop", "khop_many", "multi_source_bfs",
           "multi_source_sssp", "nequip_forward", "nequip_init", "pagerank",
           "prefill", "run_graph500", "run_graph500_sssp", "session",
           "ShardCtx", "sssp"]
