"""Wrappers around the hand-written SlimSell kernels.

Each wrapper checks its inputs, allocates the output, and then either runs
the plain PyTorch version (a CPU tensor) or launches its CUDA kernel on the
current stream (a CUDA tensor). On CUDA there is no fallback: a kernel that
does not build or launch raises. ``Kernel.launches`` counts the launches,
so a run can show that its path went through the kernel.

``spmv(..., weights=)`` and ``spmm(..., weights=)`` are the stored-weight
(min-plus) sweeps of single- and multi-source SSSP: their kernels,
``slimsell_spmv_wts`` and ``slimsell_spmm_wts``, are entry points of the
SpMV and SpMM sources with launch counts of their own, so a run shows
SSSP's sweeps apart from BFS's. ``spmm(..., deg=)`` is the GCN
aggregation under ``real``: its kernel, ``slimsell_spmm_gcn``, works the
symmetric-normalised weight out of the degrees and has no backward, so on
CUDA it refuses an X that autograd would have to see through.

The packed kernels (SlimSell-B) sweep int32 words that hold 32 bits each
(``core.packing``): ``spmv_packed`` a frontier bitmap of ``ceil(n/32)``
words, ``spmm_packed`` the ``ceil(B/32)`` word planes of a batch.

The kernels take the SlimWork mask as the bool ``tile_mask`` itself and
write straight into vertex space through ``row_vertex``, so neither the
TPU wrapper's tile-id compaction nor its chunk-row scatter epilogue is
needed here. They read a chunk's slots only up to its length ``cl``. The
pull kernels take the not-final bits as a contiguous bool[n] / [n, B] in
vertex space and read ``row_mask[row_vertex]`` themselves, so the TPU
wrapper's gather of those bits into chunk-row space is not needed either.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import packing
from ..core.semiring import BOOLEAN_PACKED, Semiring
from ..core.spmv import (pull_mm_plain, pull_plain, spmm_packed_plain,
                         spmm_plain, spmv_packed_plain, spmv_plain)
from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


class Kernel:
    """One kernel's C entry point, loaded at its first launch, and the
    number of launches since the last ``reset_launches``. ``source`` names
    the ``csrc/<source>.cu`` that holds it (default: the entry's name)."""

    def __init__(self, name: str, argtypes: list, source: Optional[str] = None):
        self.name = name
        self.source = source or name
        self.launches = 0
        self._argtypes = argtypes
        self._fn = None
        self._error = None

    def _load(self):
        build.build([self.source])
        lib = ctypes.CDLL(str(build.library_path(self.source)))
        fn = getattr(lib, self.name)
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error = fn, err

    def launch(self, *args) -> None:
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} "
                               f"({self._error(code).decode()})")
        self.launches += 1


SPMV = Kernel("slimsell_spmv", [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
SPMV_WTS = Kernel("slimsell_spmv_wts",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                  source="slimsell_spmv")
SPMM = Kernel("slimsell_spmm",
              [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
SPMM_WTS = Kernel("slimsell_spmm_wts",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                  source="slimsell_spmm")
SPMM_GCN = Kernel("slimsell_spmm_gcn",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                  source="slimsell_spmm")
PULL = Kernel("slimsell_pull",
              [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
PULL_MM = Kernel("slimsell_pull_mm",
                 [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
SPMV_PACKED = Kernel("slimsell_spmv_packed",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
SPMM_PACKED = Kernel("slimsell_spmm_packed",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
KERNELS = (SPMV, SPMV_WTS, SPMM, SPMM_WTS, SPMM_GCN, PULL, PULL_MM,
           SPMV_PACKED, SPMM_PACKED)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def _check(sr: Semiring, tiled, x: torch.Tensor, ndim: int,
           tile_mask: Optional[torch.Tensor], rows: Optional[int] = None) -> None:
    """Shape, type and device of a sweep operand with ``rows`` rows
    (default n) and the mask."""
    rows = tiled.n if rows is None else rows
    if x.ndim != ndim or x.shape[0] != rows:
        shape = f"[{rows}]" if ndim == 1 else f"[{rows}, B]"
        raise ValueError(f"expected a frontier of shape {shape}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != sr.dtype:
        raise TypeError(f"{sr.name} sweeps {sr.dtype}, got {x.dtype}")
    if x.device != tiled.cols.device:
        raise ValueError(f"frontier on {x.device}, layout on {tiled.cols.device}")
    if tile_mask is not None and (tile_mask.dtype != torch.bool
                                  or tuple(tile_mask.shape) != (tiled.n_tiles,)
                                  or tile_mask.device != x.device):
        raise ValueError(f"tile_mask must be bool[{tiled.n_tiles}] on "
                         f"{x.device}, got {tile_mask.dtype}"
                         f"{tuple(tile_mask.shape)} on {tile_mask.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SlimSell sweep for device {x.device}")


def _implicit(sr: Semiring) -> None:
    """The implicit-edge-value sweeps do not take ``minplus``: its edge
    value is a stored weight, swept by ``spmv`` / ``spmm(..., weights=)``."""
    if sr.name == "minplus":
        raise ValueError("the minplus semiring needs stored weights "
                         "(weights=tiled.wts, push SpMV and SpMM only); for "
                         "the implicit-1 edge value use the tropical semiring")


def _check_weights(sr: Semiring, tiled, x: torch.Tensor,
                   weights: torch.Tensor) -> None:
    """Stored weights: min-plus only, float32 [T, C, L] beside the frontier."""
    if sr.name != "minplus":
        raise ValueError(f"stored weights are swept under minplus, got {sr.name}")
    if (weights.dtype != torch.float32
            or tuple(weights.shape) != tuple(tiled.cols.shape)
            or weights.device != x.device):
        raise ValueError(f"weights must be float32{tuple(tiled.cols.shape)} on "
                         f"{x.device}, got {weights.dtype}"
                         f"{tuple(weights.shape)} on {weights.device}")
    if x.device.type == "cuda" and not weights.is_contiguous():
        raise ValueError("weights must be contiguous")


def _check_deg(sr: Semiring, tiled, x: torch.Tensor, deg: torch.Tensor,
               weights: Optional[torch.Tensor]) -> None:
    """GCN degrees: real only, exclusive with stored weights, float32 [n]
    beside the operand."""
    if weights is not None:
        raise ValueError("pass stored weights= or the GCN degrees deg=, not both")
    if sr.name != "real":
        raise ValueError(f"the GCN weight is swept under real, got {sr.name}")
    if (deg.dtype != torch.float32 or tuple(deg.shape) != (tiled.n,)
            or deg.device != x.device):
        raise ValueError(f"deg must be float32[{tiled.n}] on {x.device}, got "
                         f"{deg.dtype}{tuple(deg.shape)} on {deg.device}")
    if x.device.type == "cuda" and not deg.is_contiguous():
        raise ValueError("deg must be contiguous")


def _check_rows(x: torch.Tensor, row_mask: torch.Tensor) -> None:
    if (row_mask.dtype != torch.bool or row_mask.shape != x.shape
            or row_mask.device != x.device):
        raise ValueError(f"row_mask must be bool{tuple(x.shape)} on {x.device}, "
                         f"got {row_mask.dtype}{tuple(row_mask.shape)} on "
                         f"{row_mask.device}")
    if x.device.type == "cuda" and not row_mask.is_contiguous():
        raise ValueError("row_mask must be contiguous")


def _lanes(tiled, B: int, staged: int = 1) -> int:
    """The batch-column tile of one block of the matrix kernels: whole
    warps, at most 1024 threads, and the ``staged`` C x L arrays of one
    tile (cols, and the weights or GCN column factors beside them) must
    fit the kernels' 48 KB of shared memory."""
    if staged * tiled.C * tiled.L * 4 > 48 * 1024:
        raise ValueError(f"{staged} C x L = {tiled.C} x {tiled.L} tile(s) do "
                         "not fit the matrix kernels' 48 KB of shared memory")
    return min(-(-B // 32) * 32, 128, (1024 // tiled.C) // 32 * 32)


def _cuda_operands(tiled, x: torch.Tensor, tile_mask: Optional[torch.Tensor]):
    for name in ("cols", "tile_ptr", "row_vertex", "cl"):
        t = getattr(tiled, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"layout field {name} must be contiguous int32")
    if not x.is_contiguous() or (tile_mask is not None
                                 and not tile_mask.is_contiguous()):
        raise ValueError("the frontier and tile_mask must be contiguous")
    if tiled.C > 32:
        raise ValueError(f"the kernels take chunks of at most 32 rows, got C={tiled.C}")
    mask = 0 if tile_mask is None else tile_mask.data_ptr()
    return (tiled.cols.data_ptr(), tiled.tile_ptr.data_ptr(),
            tiled.row_vertex.data_ptr(), tiled.cl.data_ptr(), mask)


def spmv(sr: Semiring, tiled, x: torch.Tensor, *,
         tile_mask: Optional[torch.Tensor] = None,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell SpMV: x [n] -> y [n] in vertex space. With ``weights``
    (float32 [T, C, L], under ``minplus``): y[v] = min over the kept slots
    of v's row of ``w + x[col]``, the stored-weight kernel."""
    _check(sr, tiled, x, 1, tile_mask)
    if weights is None:
        _implicit(sr)
    else:
        _check_weights(sr, tiled, x, weights)
    if x.device.type == "cpu":
        return spmv_plain(sr, tiled, x, tile_mask, weights)
    cols, *rest = _cuda_operands(tiled, x, tile_mask)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if weights is None:
            SPMV.launch(sr.code, cols, *rest, x.data_ptr(), y.data_ptr(),
                        tiled.n_chunks, tiled.C, tiled.L, stream)
        else:
            SPMV_WTS.launch(cols, weights.data_ptr(), *rest, x.data_ptr(),
                            y.data_ptr(), tiled.n_chunks, tiled.C, tiled.L,
                            stream)
    return y


def spmm(sr: Semiring, tiled, X: torch.Tensor, *,
         tile_mask: Optional[torch.Tensor] = None,
         weights: Optional[torch.Tensor] = None,
         deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell SpMM: X [n, B] -> Y [n, B] in vertex space, any B. With
    ``weights`` (float32 [T, C, L], under ``minplus``): Y[v, b] = min over
    the kept slots of v's row of ``w + X[col, b]``, the same weight for
    every column, the stored-weight kernel. With ``deg`` (float32 [n],
    under ``real``): Y[v, b] = sum over the kept slots of
    ``rsqrt(max(deg[v], 1)) * rsqrt(max(deg[col], 1)) * X[col, b]``, the
    GCN kernel, which has no backward."""
    _check(sr, tiled, X, 2, tile_mask)
    if deg is not None:
        _check_deg(sr, tiled, X, deg, weights)
    elif weights is None:
        _implicit(sr)
    else:
        _check_weights(sr, tiled, X, weights)
    if X.device.type == "cpu":
        return spmm_plain(sr, tiled, X, tile_mask, weights, deg)
    if deg is not None and torch.is_grad_enabled() and X.requires_grad:
        raise RuntimeError("the GCN SpMM kernel has no backward: run the "
                           "forward under torch.no_grad() or "
                           "torch.inference_mode()")
    cols, *rest = _cuda_operands(tiled, X, tile_mask)
    B = X.shape[1]
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if deg is not None:
            SPMM_GCN.launch(cols, deg.data_ptr(), *rest, X.data_ptr(),
                            Y.data_ptr(), tiled.n_chunks, tiled.C, tiled.L,
                            B, _lanes(tiled, B, staged=2), stream)
        elif weights is None:
            SPMM.launch(sr.code, cols, *rest, X.data_ptr(), Y.data_ptr(),
                        tiled.n_chunks, tiled.C, tiled.L, B, _lanes(tiled, B),
                        stream)
        else:
            SPMM_WTS.launch(cols, weights.data_ptr(), *rest, X.data_ptr(),
                            Y.data_ptr(), tiled.n_chunks, tiled.C, tiled.L,
                            B, _lanes(tiled, B, staged=2), stream)
    return Y


def pull(sr: Semiring, tiled, x: torch.Tensor, row_mask: torch.Tensor, *,
         tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell pull sweep: x [n], row_mask bool[n] -> y [n] in vertex
    space, first-hit semantics (``core.spmv``)."""
    _check(sr, tiled, x, 1, tile_mask)
    _implicit(sr)
    _check_rows(x, row_mask)
    if x.device.type == "cpu":
        return pull_plain(sr, tiled, x, row_mask, tile_mask)
    ptrs = _cuda_operands(tiled, x, tile_mask)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        PULL.launch(sr.code, *ptrs, row_mask.data_ptr(), x.data_ptr(),
                    y.data_ptr(), tiled.n_chunks, tiled.C, tiled.L, stream)
    return y


def pull_mm(sr: Semiring, tiled, X: torch.Tensor, row_mask: torch.Tensor, *,
            tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched SlimSell pull sweep: X [n, B], row_mask bool[n, B] ->
    Y [n, B] in vertex space, the early exit per (row, column)."""
    _check(sr, tiled, X, 2, tile_mask)
    _implicit(sr)
    _check_rows(X, row_mask)
    if X.device.type == "cpu":
        return pull_mm_plain(sr, tiled, X, row_mask, tile_mask)
    ptrs = _cuda_operands(tiled, X, tile_mask)
    B = X.shape[1]
    lanes = _lanes(tiled, B)
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        PULL_MM.launch(sr.code, *ptrs, row_mask.data_ptr(), X.data_ptr(),
                       Y.data_ptr(), tiled.n_chunks, tiled.C, tiled.L, B,
                       lanes, stream)
    return Y


def spmv_packed(tiled, x_words: torch.Tensor, *,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell-B SpMV: the packed frontier bitmap int32[ceil(n/32)] ->
    the packed reach bitmap of the same shape."""
    _check(BOOLEAN_PACKED, tiled, x_words, 1, tile_mask,
           rows=packing.packed_words(tiled.n))
    if x_words.device.type == "cpu":
        return spmv_packed_plain(tiled, x_words, tile_mask)
    ptrs = _cuda_operands(tiled, x_words, tile_mask)
    y = torch.zeros_like(x_words)  # the kernel ORs the reached bits in
    with torch.cuda.device(x_words.device):
        stream = torch.cuda.current_stream(x_words.device).cuda_stream
        SPMV_PACKED.launch(*ptrs, x_words.data_ptr(), y.data_ptr(),
                           tiled.n_chunks, tiled.C, tiled.L, stream)
    return y


def spmm_packed(tiled, X_words: torch.Tensor, *,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell-B packed-plane SpMM: X int32[n, ceil(B/32)] (32 roots per
    word) -> Y int32[n, ceil(B/32)] in vertex space."""
    _check(BOOLEAN_PACKED, tiled, X_words, 2, tile_mask)
    if X_words.device.type == "cpu":
        return spmm_packed_plain(tiled, X_words, tile_mask)
    ptrs = _cuda_operands(tiled, X_words, tile_mask)
    Y = torch.empty_like(X_words)
    with torch.cuda.device(X_words.device):
        stream = torch.cuda.current_stream(X_words.device).cuda_stream
        SPMM_PACKED.launch(*ptrs, X_words.data_ptr(), Y.data_ptr(),
                           tiled.n_chunks, tiled.C, tiled.L, X_words.shape[1],
                           stream)
    return Y
