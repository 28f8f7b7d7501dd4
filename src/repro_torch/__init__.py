"""SlimSell BFS in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``: the tiled SlimSell layout
(``core.formats``), semiring SpMV/SpMM sweeps (``core.spmv``, kernels in
``kernels/``), single-source and batched multi-source BFS (``core.bfs``,
``core.multi_bfs``) and the Graph500 harness (``graph500``). Entry points
run on the card unless the caller passes ``device="cpu"``, which runs the
plain PyTorch versions of the kernels.
"""
from .core.bfs import bfs
from .core.formats import build_csr, build_slimsell
from .core.multi_bfs import multi_source_bfs
from .graph500 import run_graph500

__all__ = ["bfs", "build_csr", "build_slimsell", "multi_source_bfs",
           "run_graph500"]
