"""Wrappers around the hand-written SlimSell kernels.

Each wrapper checks its inputs, allocates the output, and then either runs
the plain PyTorch version (a CPU tensor) or launches its CUDA kernel on the
current stream (a CUDA tensor). On CUDA there is no fallback: a kernel that
does not build or launch raises. ``Kernel.launches`` counts the launches,
so a run can show that its path went through the kernel. Any thread may
launch: a kernel's first launch builds and loads its library under
``build.LOCK``, once, and the counts change under a lock of their own.

``spmv(..., weights=)`` and ``spmm(..., weights=)`` are the stored-weight
(min-plus) sweeps of single- and multi-source SSSP: their kernels,
``slimsell_spmv_wts`` and ``slimsell_spmm_wts``, are entry points of the
SpMV and SpMM sources with launch counts of their own, so a run shows
SSSP's sweeps apart from BFS's. ``spmm(..., deg=)`` is the GCN
aggregation under ``real``: its kernel, ``slimsell_spmm_gcn``, works the
symmetric-normalised weight out of the degrees and has no backward, so on
CUDA it refuses an X that autograd would have to see through; a training
step reaches it through ``kernels.autograd.gcn_aggregate``, whose backward
is the same sweep.

The packed kernels (SlimSell-B) sweep int32 words that hold 32 bits each
(``core.packing``): ``spmv_packed`` a frontier bitmap of ``ceil(n/32)``
words, ``spmm_packed`` the ``ceil(B/32)`` word planes of a batch.

``embedding_bag_grouped`` is DLRM's sparse lookup, the one kernel here
that is not a SlimSell sweep: over each of T tables, the sum (or mean) of
the table rows each bag of ids names, -1 padding a bag, all of a
forward's tables in one launch. ``embedding_bag`` is one table, the same
launch with T = 1. Their plain versions are ``kernels.ref``'s
``embedding_bag_ref`` and ``embedding_bag_grouped_ref``.

No sweep kernel gives one block a whole chunk. The SpMM kernels take
``spmm_work``: each chunk's tiles cut into pieces of at most
``piece_tiles(L)`` tiles, one block each; the kernel folds the pieces of
a split chunk in order. Every other sweep kernel takes ``spmv_work``:
pieces of at most ``spmv_piece_tiles(L)`` tiles, each with the lanes a
row its length needs (``spmv_lanes``), sorted by that width so that a
warp takes several short rows. The SpMV kernels and the packed SpMM fold
a split chunk's pieces in piece order (the semiring add, or the OR);
the packed SpMV needs no fold, its pieces ORing their rows' bits into the
zeroed bitmap with atomics. The single-source pull walks its tiles a few
at a time by the same widths and exits a row at its first hitting tile;
the batched pull ignores the widths. Both pulls fold a split chunk by
taking, for each row (and column), the first piece's hit in piece order,
not the semiring add of the pieces. Each list is built at a layout's
first launch of its kernels and kept on the layout (``tiled.spmm_work``,
``tiled.spmv_work``).

A shard of the distributed partition (``engine.ShardTiled``) is a layout
too: its operand has ``tiled.n_x`` rows (its column range, localized
column ids), its result n rows in vertex space, and the wrappers start
the rows its chunks do not hold at the semiring zero (``_out``).

Each wrapper that launches a kernel registers its launch contract
(``@kernel_contract``, ``analysis.registry``): its work list, built by the
builder it calls over the registry's demo layouts, which
``python -m repro_torch.analysis.contracts`` proves in bounds, covering
and race-free. ``SEMIRING_PROBE`` is no sweep: ``analysis.laws`` launches
it to hold the CUDA semiring table to ``core.semiring`` on the card.

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
import threading
from typing import Optional, Sequence

import torch

from ..analysis.registry import (KernelCase, demo_layouts, demo_tables,
                                 kernel_contract)
from ..core import packing
from ..core.options import check_choice
from ..core.semiring import BOOLEAN_PACKED, Semiring
from ..core.spmv import (pull_mm_plain, pull_plain, spmm_packed_plain,
                         spmm_plain, spmv_packed_plain, spmv_plain)
from . import build
from .ref import BAG_MODES, embedding_bag_grouped_ref, embedding_bag_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# guards every Kernel.launches update, reset and read
_COUNT_LOCK = threading.Lock()


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
        self._error = err
        self._fn = fn  # last: a thread that sees it sees the error entry

    def launch(self, *args) -> None:
        if self._fn is None:
            with build.LOCK:
                if self._fn is None:
                    self._load()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} "
                               f"({self._error(code).decode()})")
        with _COUNT_LOCK:
            self.launches += 1


SPMV = Kernel("slimsell_spmv",
              [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P])
SPMV_WTS = Kernel("slimsell_spmv_wts",
                  [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P],
                  source="slimsell_spmv")
SPMM = Kernel("slimsell_spmm",
              [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
               _P])
SPMM_WTS = Kernel("slimsell_spmm_wts",
                  [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                   _I, _P], source="slimsell_spmm")
SPMM_GCN = Kernel("slimsell_spmm_gcn",
                  [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                   _I, _I, _I, _P], source="slimsell_spmm")
PULL = Kernel("slimsell_pull",
              [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P])
PULL_MM = Kernel("slimsell_pull_mm",
                 [_I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                  _P])
SPMV_PACKED = Kernel("slimsell_spmv_packed",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P])
SPMM_PACKED = Kernel("slimsell_spmm_packed",
                     [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P])
EMBEDDING_BAG_GROUPED = Kernel("embedding_bag_grouped",
                               [_P, _P, _I, _P, _L, _L, _L, _P, _L, _L, _I, _I,
                                _I, _I, _P], source="embedding_bag")
# the CUDA semiring table evaluated on the card: no sweep, the analysis
# layer's check that it agrees with core.semiring (analysis.laws)
SEMIRING_PROBE = Kernel("semiring_probe", [_I, _P, _I, _P, _P, _P, _P, _P])
KERNELS = (SPMV, SPMV_WTS, SPMM, SPMM_WTS, SPMM_GCN, PULL, PULL_MM,
           SPMV_PACKED, SPMM_PACKED, EMBEDDING_BAG_GROUPED, SEMIRING_PROBE)
# the most tables of one embedding-bag launch (their pointers and row
# counts are the launch's parameters, csrc/embedding_bag.cu)
MAX_TABLES = 128


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return {k.name: k.launches for k in KERNELS}


def _check(sr: Semiring, tiled, x: torch.Tensor, ndim: int,
           tile_mask: Optional[torch.Tensor], rows: Optional[int] = None) -> None:
    """Shape, type and device of a sweep operand with ``rows`` rows
    (default ``tiled.n_x``: n, or a shard's column range) and the mask."""
    rows = tiled.n_x if rows is None else rows
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


def _check_rows(tiled, x: torch.Tensor, row_mask: torch.Tensor) -> None:
    """The not-final bits: bool in vertex space, [n] or [n, B] (a shard's
    operand has fewer rows, its output n)."""
    shape = (tiled.n,) + tuple(x.shape[1:])
    if (row_mask.dtype != torch.bool or tuple(row_mask.shape) != shape
            or row_mask.device != x.device):
        raise ValueError(f"row_mask must be bool{shape} on {x.device}, "
                         f"got {row_mask.dtype}{tuple(row_mask.shape)} on "
                         f"{row_mask.device}")
    if x.device.type == "cuda" and not row_mask.is_contiguous():
        raise ValueError("row_mask must be contiguous")


def _out(sr: Semiring, tiled, x: torch.Tensor) -> torch.Tensor:
    """A sweep's output in vertex space, [n] or [n, B]. The kernels write
    every row of the layout's chunks; where the chunks do not hold every
    vertex (a shard of the distributed partition holds its row range) the
    other rows start at the semiring zero, which the all-reduce then
    combines."""
    shape = (tiled.n,) + tuple(x.shape[1:])
    if tiled.owns_all_rows:
        return x.new_empty(shape)
    return x.new_full(shape, sr.zero)


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


# The most slots of one row that a warp of the SpMM walks in one piece: a
# chunk's tiles below cl are cut into pieces of PIECE_SLOTS // L tiles (at
# least one), each piece one block (csrc/slimsell_spmm.cu). 256 slots are
# 32 steps of a warp at B = 16 and 128 at B = 64; at scale 20 the heaviest
# chunk's 310 tiles become 155 pieces.
PIECE_SLOTS = 256


def piece_tiles(L: int) -> int:
    """Tiles of one SpMM piece at tile width L."""
    return max(1, PIECE_SLOTS // L)


def spmm_work(tile_ptr: torch.Tensor, cl: torch.Tensor, L: int,
              per_piece: int):
    """The SpMM's work list, on the CPU: ``(pieces, folds, slots)``.

    ``pieces`` int32 [P, 4]: (chunk, first tile, end tile, partial slot)
    in chunk order, each chunk's tiles below its length ``cl`` cut into
    consecutive pieces of at most ``per_piece`` tiles; a chunk with no
    tile below ``cl`` has one empty piece (it writes the semiring zero).
    The slot is -1 for a chunk of one piece, which writes Y itself; the
    pieces of a chunk of several take consecutive partial slots.
    ``folds`` int32 [F, 4]: (chunk, first slot, number of slots, 0) of
    each chunk of several pieces. ``slots`` is the number of partial
    slots."""
    tp = tile_ptr.detach().cpu().long()
    live = -(-cl.detach().cpu().long() // L)                 # tiles below cl
    n_pieces = (-(-live // per_piece)).clamp_min(1)
    chunk = torch.repeat_interleave(torch.arange(live.numel()), n_pieces)
    start = torch.cumsum(n_pieces, 0) - n_pieces
    j = torch.arange(chunk.numel()) - start[chunk]          # rank in the chunk
    first = tp[chunk] + j * per_piece
    end = tp[chunk] + torch.minimum((j + 1) * per_piece, live[chunk])
    split = n_pieces[chunk] > 1
    slot = torch.where(split, torch.cumsum(split.long(), 0) - 1, -1)
    pieces = torch.stack([chunk, first, end, slot], 1).to(torch.int32)
    heads = split & (j == 0)
    folds = torch.stack([chunk[heads], slot[heads], n_pieces[chunk[heads]],
                         torch.zeros_like(slot[heads])], 1).to(torch.int32)
    return pieces, folds, int(split.sum())


def _work_on_device(tiled, field: str, make):
    """A kernel's work list of a device layout, built by ``make()`` at the
    first launch and kept on the layout (``tiled.<field>``) beside the
    ``tile_ptr`` and ``cl`` it was built from; built anew if either has
    been replaced."""
    memo = getattr(tiled, field)
    if memo is None or memo[0] is not tiled.tile_ptr or memo[1] is not tiled.cl:
        memo = (tiled.tile_ptr, tiled.cl, make())
        setattr(tiled, field, memo)
    return memo[2]


def _spmm_work_on_device(tiled):
    """``spmm_work`` of a device layout, on the device."""
    def make():
        pieces, folds, slots = spmm_work(tiled.tile_ptr, tiled.cl, tiled.L,
                                         piece_tiles(tiled.L))
        dev = tiled.tile_ptr.device
        return pieces.to(dev), folds.to(dev), slots
    return _work_on_device(tiled, "spmm_work", make)


# The most slots of one row that a warp of the SpMV walks in one piece: a
# lane takes SPMV_GROUP slots a step (two 16-byte loads of cols; kGroup in
# csrc/slimsell_spmv.cu, which walks every slot whatever width a row was
# given, so another value here costs only speed), a row at most 32 lanes,
# so a piece of 1024 slots is at most 4 steps of a warp; at scale 20 the
# heaviest chunk's 310 tiles become 39 pieces.
SPMV_PIECE_SLOTS = 1024
SPMV_GROUP = 8
# lanes a row, one width class each (csrc/slimsell_spmv.cu)
SPMV_LANES = (1, 2, 4, 8, 16, 32)


def spmv_piece_tiles(L: int) -> int:
    """Tiles of one SpMV piece at tile width L."""
    return max(1, SPMV_PIECE_SLOTS // L)


def spmv_lanes(n_slots: torch.Tensor) -> torch.Tensor:
    """The lanes a row of ``n_slots`` slots gets: the least power of two
    whose ``SPMV_GROUP`` slots a lane cover it, from 1 to 32."""
    groups = -(-n_slots.long() // SPMV_GROUP)
    lanes = torch.ones_like(groups)
    for w in SPMV_LANES[1:]:
        lanes = torch.where(groups > w // 2, w, lanes)
    return lanes


def spmv_work(tile_ptr: torch.Tensor, cl: torch.Tensor, L: int,
              per_piece: int):
    """The SpMV's work list, on the CPU: ``(items, class_items, folds,
    slots)``.

    The pieces are ``spmm_work``'s at ``per_piece`` tiles. ``items`` int32
    [P, 4]: (chunk, first tile, row slots, partial slot) of each piece,
    the row slots being the slots of its rows below the chunk's length
    ``cl`` (0 for the empty piece of a chunk with none), sorted stably by
    the lanes a row they get (``spmv_lanes``); ``class_items`` the number
    of items of each width of ``SPMV_LANES``. ``folds`` and ``slots`` are
    ``spmm_work``'s: the kernel folds a split chunk's partial rows in
    piece order."""
    pieces, folds, slots = spmm_work(tile_ptr, cl, L, per_piece)
    tp = tile_ptr.detach().cpu().long()
    chunk, first, end = (pieces[:, j].long() for j in range(3))
    row_slots = torch.minimum(cl.detach().cpu().long()[chunk]
                              - (first - tp[chunk]) * L, (end - first) * L)
    lanes = spmv_lanes(row_slots)
    order = torch.argsort(lanes, stable=True)
    items = torch.stack([chunk, first, row_slots, pieces[:, 3].long()],
                        1)[order].to(torch.int32)
    class_items = [int((lanes == w).sum()) for w in SPMV_LANES]
    return items, class_items, folds, slots


def _spmv_work_on_device(tiled):
    """``spmv_work`` of a device layout: the items and folds on the device,
    the class counts as the C array the entry points read."""
    def make():
        items, class_items, folds, slots = spmv_work(
            tiled.tile_ptr, tiled.cl, tiled.L, spmv_piece_tiles(tiled.L))
        dev = tiled.tile_ptr.device
        return (items.to(dev), (_I * len(class_items))(*class_items),
                folds.to(dev), slots)
    return _work_on_device(tiled, "spmv_work", make)


# ------------------------------------------------------------ contract cases
# Each wrapper's contract (analysis.registry): its work list built by the
# builder it calls, over the demo layouts, at 2 tiles a piece (which
# splits their long chunks) and at the wrapper's own piece size.


def _sweep_cases(kind: str):
    """The cases of a wrapper that reads ``spmm_work`` ("spmm") or
    ``spmv_work`` ("spmv")."""
    build_list, own = ((spmm_work, piece_tiles) if kind == "spmm"
                       else (spmv_work, spmv_piece_tiles))

    def cases():
        return [KernelCase(name=f"{name} per_piece={per_piece}", kind=kind,
                           work=build_list(lay.tile_ptr, lay.cl, lay.L,
                                           per_piece),
                           layout=lay, per_piece=per_piece)
                for name, lay in demo_layouts().items()
                for per_piece in (2, own(lay.L))]
    return cases


def _table_cases():
    """Kernel 7's launch parameters (``_table_args``) for the demo tables:
    all of them in one launch, and one alone (``embedding_bag``)."""
    tables = demo_tables()
    return [KernelCase(name=f"{len(ts)} tables", kind="tables",
                       work=_table_args(ts, ts[0].device), tables=ts)
            for ts in (tables, tables[1:2])]


@kernel_contract(_sweep_cases("spmv"))
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
    cols, _, row_vertex, _, mask = _cuda_operands(tiled, x, tile_mask)
    items, classes, folds, slots = _spmv_work_on_device(tiled)
    y = _out(sr, tiled, x)
    partial = x.new_empty(slots * tiled.C) if folds.shape[0] else None
    work = (row_vertex, mask, items.data_ptr(), classes, folds.data_ptr(),
            folds.shape[0], 0 if partial is None else partial.data_ptr(),
            x.data_ptr(), y.data_ptr(), tiled.C, tiled.L)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if weights is None:
            SPMV.launch(sr.code, cols, *work, stream)
        else:
            SPMV_WTS.launch(cols, weights.data_ptr(), *work, stream)
    return y


@kernel_contract(_sweep_cases("spmm"))
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
    GCN kernel, which has no backward (under autograd:
    ``kernels.autograd.gcn_aggregate``)."""
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
                           "torch.inference_mode(), or train through "
                           "kernels.autograd.gcn_aggregate")
    cols, tile_ptr, row_vertex, cl, mask = _cuda_operands(tiled, X, tile_mask)
    pieces, folds, slots = _spmm_work_on_device(tiled)
    B = X.shape[1]
    Y = _out(sr, tiled, X)
    partial = X.new_empty(slots * tiled.C * B) if folds.shape[0] else None
    work = (pieces.data_ptr(), pieces.shape[0], folds.data_ptr(),
            folds.shape[0], 0 if partial is None else partial.data_ptr(),
            X.data_ptr(), Y.data_ptr(), tiled.C, tiled.L, B)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if deg is not None:
            dinv = torch.empty(tiled.n, dtype=torch.float32, device=X.device)
            SPMM_GCN.launch(cols, deg.data_ptr(), dinv.data_ptr(), tiled.n,
                            tile_ptr, row_vertex, cl, mask, *work, stream)
        elif weights is None:
            SPMM.launch(sr.code, cols, tile_ptr, row_vertex, cl, mask, *work,
                        stream)
        else:
            SPMM_WTS.launch(cols, weights.data_ptr(), tile_ptr, row_vertex, cl,
                            mask, *work, stream)
    return Y


@kernel_contract(_sweep_cases("spmv"))
def pull(sr: Semiring, tiled, x: torch.Tensor, row_mask: torch.Tensor, *,
         tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell pull sweep: x [n], row_mask bool[n] -> y [n] in vertex
    space, first-hit semantics (``core.spmv``)."""
    _check(sr, tiled, x, 1, tile_mask)
    _implicit(sr)
    _check_rows(tiled, x, row_mask)
    if x.device.type == "cpu":
        return pull_plain(sr, tiled, x, row_mask, tile_mask)
    cols, _, row_vertex, _, mask = _cuda_operands(tiled, x, tile_mask)
    items, classes, folds, slots = _spmv_work_on_device(tiled)
    y = _out(sr, tiled, x)
    partial = x.new_empty(slots * tiled.C) if folds.shape[0] else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        PULL.launch(sr.code, cols, row_vertex, mask, row_mask.data_ptr(),
                    items.data_ptr(), classes, folds.data_ptr(),
                    folds.shape[0],
                    0 if partial is None else partial.data_ptr(),
                    x.data_ptr(), y.data_ptr(), tiled.C, tiled.L, stream)
    return y


@kernel_contract(_sweep_cases("spmv"))
def pull_mm(sr: Semiring, tiled, X: torch.Tensor, row_mask: torch.Tensor, *,
            tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched SlimSell pull sweep: X [n, B], row_mask bool[n, B] ->
    Y [n, B] in vertex space, the early exit per (row, column)."""
    _check(sr, tiled, X, 2, tile_mask)
    _implicit(sr)
    _check_rows(tiled, X, row_mask)
    if X.device.type == "cpu":
        return pull_mm_plain(sr, tiled, X, row_mask, tile_mask)
    cols, _, row_vertex, _, mask = _cuda_operands(tiled, X, tile_mask)
    items, _, folds, slots = _spmv_work_on_device(tiled)
    B = X.shape[1]
    Y = _out(sr, tiled, X)
    partial = X.new_empty(slots * tiled.C * B) if folds.shape[0] else None
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        PULL_MM.launch(sr.code, cols, row_vertex, mask, row_mask.data_ptr(),
                       items.data_ptr(), items.shape[0], folds.data_ptr(),
                       folds.shape[0],
                       0 if partial is None else partial.data_ptr(),
                       X.data_ptr(), Y.data_ptr(), tiled.C, tiled.L, B, stream)
    return Y


@kernel_contract(_sweep_cases("spmv"))
def spmv_packed(tiled, x_words: torch.Tensor, *,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell-B SpMV: the packed frontier bitmap int32[ceil(n/32)] ->
    the packed reach bitmap of the same shape."""
    _check(BOOLEAN_PACKED, tiled, x_words, 1, tile_mask,
           rows=packing.packed_words(tiled.n))
    if x_words.device.type == "cpu":
        return spmv_packed_plain(tiled, x_words, tile_mask)
    cols, _, row_vertex, _, mask = _cuda_operands(tiled, x_words, tile_mask)
    items, classes, _, _ = _spmv_work_on_device(tiled)
    y = torch.zeros_like(x_words)  # the kernel ORs the reached bits in
    with torch.cuda.device(x_words.device):
        stream = torch.cuda.current_stream(x_words.device).cuda_stream
        SPMV_PACKED.launch(cols, row_vertex, mask, items.data_ptr(), classes,
                           x_words.data_ptr(), y.data_ptr(), tiled.C,
                           tiled.L, stream)
    return y


@kernel_contract(_sweep_cases("spmv"))
def spmm_packed(tiled, X_words: torch.Tensor, *,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell-B packed-plane SpMM: X int32[n, ceil(B/32)] (32 roots per
    word) -> Y int32[n, ceil(B/32)] in vertex space."""
    _check(BOOLEAN_PACKED, tiled, X_words, 2, tile_mask)
    if X_words.device.type == "cpu":
        return spmm_packed_plain(tiled, X_words, tile_mask)
    cols, _, row_vertex, _, mask = _cuda_operands(tiled, X_words, tile_mask)
    items, classes, folds, slots = _spmv_work_on_device(tiled)
    Wb = X_words.shape[1]
    Y = _out(BOOLEAN_PACKED, tiled, X_words)
    partial = X_words.new_empty(slots * tiled.C * Wb) if folds.shape[0] \
        else None
    with torch.cuda.device(X_words.device):
        stream = torch.cuda.current_stream(X_words.device).cuda_stream
        SPMM_PACKED.launch(cols, row_vertex, mask, items.data_ptr(), classes,
                           folds.data_ptr(), folds.shape[0],
                           0 if partial is None else partial.data_ptr(),
                           X_words.data_ptr(), Y.data_ptr(), tiled.C, tiled.L,
                           Wb, stream)
    return Y


@kernel_contract(_table_cases)
def embedding_bag(table: torch.Tensor, bags: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Embedding bag: table float32 [V, d], bags int32 [B, K] (-1 pads) ->
    [B, d], the sum (or mean) of the rows each bag names, in slot order
    (``kernels.ref.embedding_bag_ref``). An id at or past V is outside the
    contract: the kernel never reads it and makes its bag NaN, as the plain
    version does. On CUDA the table must be contiguous; ``bags`` may be any
    strided view (one field of a [B, F, K] id tensor), read in place
    without a copy. The kernel has no backward, so on CUDA a table that
    requires grad is refused while grad mode is on (under autograd:
    ``kernels.autograd.bag_lookup``)."""
    check_choice("embedding_bag mode", mode, BAG_MODES)
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_bag takes a float32 table, got {table.dtype}")
    if bags.dtype != torch.int32:
        raise TypeError(f"embedding_bag takes int32 bags, got {bags.dtype}")
    if table.ndim != 2 or bags.ndim != 2:
        raise ValueError(f"expected table [V, d] and bags [B, K], got "
                         f"{tuple(table.shape)} and {tuple(bags.shape)}")
    if bags.device != table.device:
        raise ValueError(f"bags on {bags.device}, table on {table.device}")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, bags, mode)
    if table.device.type != "cuda":
        raise ValueError(f"no embedding bag for device {table.device}")
    return embedding_bag_grouped([table], bags.unsqueeze(1), mode)[:, 0]


def _table_args(tables: Sequence[torch.Tensor], dev: torch.device):
    """Check the tables in one pass: float32 [V_t, d] of one d on ``dev``,
    contiguous on CUDA. Returns their data pointers and row counts."""
    d = tables[0].shape[-1]
    ptrs, rows = [], []
    for t in tables:
        if t.dtype != torch.float32:
            raise TypeError(f"embedding_bag takes float32 tables, got {t.dtype}")
        shape = t.shape
        if len(shape) != 2 or shape[1] != d or t.device != dev:
            raise ValueError(f"every table must be [V, {d}] on {dev}, got "
                             f"{tuple(shape)} on {t.device}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError("the tables must be contiguous")
        ptrs.append(t.data_ptr())
        rows.append(shape[0])
    return ptrs, rows


@kernel_contract(_table_cases)
def embedding_bag_grouped(tables: Sequence[torch.Tensor], bags: torch.Tensor,
                          mode: str = "sum", *,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All T tables' embedding bags in one launch: tables T x float32
    [V_t, d] (one d), bags int32 [B, T, K] (-1 pads; field t reads table
    t) -> [B, T, d], each ``out[:, t]`` equal bit for bit to
    ``embedding_bag(tables[t], bags[:, t], mode)``. ``bags`` may be any
    strided view, read in place; ``out`` (float32 [B, T, d], contiguous
    along d, any strides for B and T) receives the result, for example the
    [B, 1 + T, d] slice that DLRM's interaction stacks. A CPU input runs
    the plain version (``kernels.ref.embedding_bag_grouped_ref``); on CUDA
    at most ``MAX_TABLES`` tables, contiguous and, with no backward, not
    requiring grad while grad mode is on. The tables are checked at every
    call."""
    check_choice("embedding_bag mode", mode, BAG_MODES)
    T = len(tables)
    if T == 0:
        raise ValueError("embedding_bag_grouped needs at least one table")
    if bags.dtype != torch.int32:
        raise TypeError(f"embedding_bag takes int32 bags, got {bags.dtype}")
    if bags.ndim != 3 or bags.shape[1] != T:
        raise ValueError(f"expected bags [B, {T}, K] for {T} tables, got "
                         f"{tuple(bags.shape)}")
    dev, d = bags.device, tables[0].shape[-1]
    B, K = bags.shape[0], bags.shape[2]
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (B, T, d)
                            or out.device != dev or out.stride(2) != 1):
        raise ValueError(f"out must be float32[{B}, {T}, {d}] on {dev}, "
                         f"contiguous along d")
    ptrs, rows = _table_args(tables, dev)
    if dev.type == "cpu":
        return embedding_bag_grouped_ref(tables, bags, mode, out)
    if dev.type != "cuda":
        raise ValueError(f"no embedding bag for device {dev}")
    if T > MAX_TABLES:
        raise ValueError(f"one launch takes at most {MAX_TABLES} tables, got {T}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise RuntimeError("the embedding-bag kernel has no backward: run the "
                           "forward under torch.no_grad() or "
                           "torch.inference_mode(), or train through "
                           "kernels.autograd.bag_lookup")
    if out is None:
        out = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    if B == 0 or d == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        EMBEDDING_BAG_GROUPED.launch(
            (_P * T)(*ptrs), (_L * T)(*rows), T, bags.data_ptr(),
            *bags.stride(), out.data_ptr(), out.stride(0), out.stride(1), B, K,
            d, int(mode == "mean"), stream)
    return out
