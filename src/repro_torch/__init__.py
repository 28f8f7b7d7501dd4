"""SlimSell BFS in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``: the tiled SlimSell layout
(``core.formats``), semiring SpMV/SpMM sweeps (``core.spmv``, kernels in
``kernels/``), single-source and batched multi-source BFS (``core.bfs``,
``core.multi_bfs``), weighted single- and multi-source SSSP (``core.sssp``,
``core.multi_sssp``), the Graph500 BFS and SSSP harnesses
(``graph500``), and GCN inference on the SlimSell aggregation
(``models.gnn``; the gcn-cora configuration in ``configs.gcn_cora``).
Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions of the kernels.
"""
from .core.bfs import bfs
from .core.formats import build_csr, build_slimsell
from .core.multi_bfs import multi_source_bfs
from .core.multi_sssp import multi_source_sssp
from .core.sssp import sssp
from .graph500 import run_graph500, run_graph500_sssp
from .models.gnn import GCNConfig, gcn_forward, gcn_init

__all__ = ["GCNConfig", "bfs", "build_csr", "build_slimsell", "gcn_forward",
           "gcn_init", "multi_source_bfs", "multi_source_sssp", "run_graph500",
           "run_graph500_sssp", "sssp"]
