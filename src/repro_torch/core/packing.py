"""SlimSell-B bit-packing: 32 reachability bits per 32-bit word.

The boolean semiring carries one bit of payload per vertex, yet the lane
path spends a 32-bit lane on it. The packed form keeps frontier and
visited bitmaps as ``ceil(n/32)`` words: bit ``v & 31`` of word ``v >> 5``
is vertex ``v``. A batch of B roots packs along its column axis into
``ceil(B/32)`` word planes. This module is the one home of that geometry:
pack / unpack (torch and numpy twins), the bit gather, the word-wise OR
reductions and the tail-word mask.

**Words are int32 tensors holding the uint32 bit patterns.** torch's
uint32 support is incomplete (many operations are not implemented for
it), so every word lives in int32 storage: the all-ones word is -1 and
bit 31 is the sign bit. Three consequences:

* ``>>`` on int32 shifts arithmetically; ``(w >> b) & 1`` still reads bit
  ``b``, and no mask here is built with a right shift.
* Packing sums ``bit << i`` in int64 and narrows the 32-bit pattern back
  to int32 (``_narrow``); an int32 sum would overflow at bit 31.
* torch has no OR reduction and no ``scatter_reduce("or")``: ``or_reduce``
  folds halves with ``|``, and ``segment_or`` takes one max-scatter per
  bit.

Host arrays (the ``*_np`` twins) use the same int32 storage; a uint32 view
(``.view(np.uint32)``) gives the JAX package's words bit for bit.

Tail-word rule: the last word of an n-bit bitmap has ``n % 32`` live bits
(when nonzero); the padding bits above them are zero everywhere.
``pack_bits`` makes them zero, the sweeps only OR packed words together or
set the bits of real vertices, and ``check_tail_zero_host`` checks it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: bits per packed word
PACK_BITS = 32

#: the all-ones word in int32 storage: packed-boolean ``one`` and the
#: implicit packed edge value (the AND identity)
FULL_WORD = -1

_SHIFT = 5   # log2(PACK_BITS): v >> 5 is v's word
_MASK = 31   # PACK_BITS - 1:   v & 31 is v's bit
_SPAN = 1 << PACK_BITS  # 2**32: one word's patterns


def packed_words(n_bits: int) -> int:
    """Words needed for an ``n_bits``-bit bitmap: ceil(n / 32)."""
    return -(-int(n_bits) // PACK_BITS)


def word_of(v):
    """Word index of vertex ``v`` (tensor, array or int >= 0): ``v >> 5``."""
    return v >> _SHIFT


def bit_of(v):
    """Bit position of vertex ``v`` within its word: ``v & 31``."""
    return v & _MASK


def tail_mask(n_bits: int) -> int:
    """The live bits of the *last* word of an ``n_bits``-bit bitmap, as an
    int32 pattern (all-ones, -1, when ``n_bits`` is a multiple of 32)."""
    r = int(n_bits) % PACK_BITS
    return FULL_WORD if r == 0 else (1 << r) - 1


def padding_mask(n_bits: int) -> np.ndarray:
    """int32[W] per-word mask of the live bits: all-ones except the tail
    word. ``words & ~padding_mask`` must be zero everywhere."""
    W = packed_words(n_bits)
    m = np.full(W, FULL_WORD, np.int32)
    if W:
        m[-1] = tail_mask(n_bits)
    return m


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32-bit pattern."""
    return torch.where(x >= _SPAN // 2, x - _SPAN, x).to(torch.int32)


# ------------------------------------------------------------- pack / unpack


def _bit_axis_shape(ndim: int, axis: int) -> tuple:
    """Broadcast shape of a [32] vector placed right after ``axis``."""
    return (1,) * (axis + 1) + (PACK_BITS,) + (1,) * (ndim - axis - 1)


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a bool tensor along ``axis`` into int32 words.

    ``bits[..., n]`` -> ``int32[..., ceil(n/32)]``; bit ``i & 31`` of word
    ``i >> 5`` is ``bits[..., i]``. Padding bits beyond ``n`` are zero.
    """
    axis = axis % bits.ndim
    n = bits.shape[axis]
    W = packed_words(n)
    pad = [0, 0] * (bits.ndim - axis - 1) + [0, W * PACK_BITS - n]
    b = torch.nn.functional.pad(bits.to(torch.int64), pad)
    b = b.reshape(b.shape[:axis] + (W, PACK_BITS) + b.shape[axis + 1:])
    weights = torch.ones(PACK_BITS, dtype=torch.int64, device=bits.device) \
        << torch.arange(PACK_BITS, device=bits.device)
    return _narrow((b * weights.reshape(_bit_axis_shape(bits.ndim, axis)))
                   .sum(dim=axis + 1))


def unpack_bits(words: torch.Tensor, n_bits: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``int32[..., W]`` -> ``bool[..., n]``
    along ``axis`` (padding bits are dropped)."""
    axis = axis % words.ndim
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(axis + 1)
            >> shifts.reshape(_bit_axis_shape(words.ndim, axis))) & 1
    bits = bits.flatten(axis, axis + 1).to(torch.bool)
    return bits.narrow(axis, 0, int(n_bits))


def pack_bits_np(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """Host (numpy) twin of :func:`pack_bits`; int32 words."""
    bits = np.asarray(bits, bool)
    axis = axis % bits.ndim
    n = bits.shape[axis]
    W = packed_words(n)
    pad = [(0, 0)] * bits.ndim
    pad[axis] = (0, W * PACK_BITS - n)
    b = np.pad(bits, pad).astype(np.uint32)
    b = b.reshape(b.shape[:axis] + (W, PACK_BITS) + b.shape[axis + 1:])
    weights = np.uint32(1) << np.arange(PACK_BITS, dtype=np.uint32)
    words = (b * weights.reshape(_bit_axis_shape(bits.ndim, axis))).sum(
        axis=axis + 1, dtype=np.uint32)
    return words.view(np.int32)


def unpack_bits_np(words: np.ndarray, n_bits: int,
                   axis: int = -1) -> np.ndarray:
    """Host (numpy) twin of :func:`unpack_bits`; takes int32 or uint32
    words."""
    words = np.ascontiguousarray(words)
    words = words.view(np.uint32) if words.dtype == np.int32 \
        else words.astype(np.uint32)
    axis = axis % words.ndim
    shifts = np.arange(PACK_BITS, dtype=np.uint32)
    bits = (np.expand_dims(words, axis + 1)
            >> shifts.reshape(_bit_axis_shape(words.ndim, axis))) & np.uint32(1)
    shape = words.shape[:axis] + (words.shape[axis] * PACK_BITS,) \
        + words.shape[axis + 1:]
    bits = bits.reshape(shape).astype(bool)
    index = [slice(None)] * bits.ndim
    index[axis] = slice(0, int(n_bits))
    return bits[tuple(index)]


def gather_bits(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Single bits of a packed bitmap: int32 0/1 shaped like ``idx``, element
    ``i`` being bit ``idx[i] & 31`` of ``words[idx[i] >> 5]``; the packed
    twin of the frontier gather ``x[col]`` (callers clamp padding indices
    to a safe vertex first)."""
    idx = idx.to(torch.int32)
    w = words.index_select(0, word_of(idx).reshape(-1)).reshape(idx.shape)
    return (w >> bit_of(idx)) & 1


# ------------------------------------------------------- word-wise reductions


def or_reduce(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Bitwise-OR fold over ``axes`` (each of length >= 1): halves are ORed
    together until one slice is left, so an axis of k costs log2(k)
    passes."""
    for axis in sorted((a % x.ndim for a in axes), reverse=True):
        while x.shape[axis] > 1:
            k = x.shape[axis]
            h = k // 2
            folded = x.narrow(axis, 0, h) | x.narrow(axis, h, h)
            x = torch.cat([folded, x.narrow(axis, 2 * h, k - 2 * h)], axis) \
                if k % 2 else folded
        x = x.squeeze(axis)
    return x


def or_reduce_last(x: torch.Tensor) -> torch.Tensor:
    """Bitwise-OR fold over the last axis."""
    return or_reduce(x, (x.ndim - 1,))


def segment_or(data: torch.Tensor, segment_ids: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Bitwise-OR segment combine: ``out[s]`` is the OR of ``data[i]`` over
    ``segment_ids[i] == s`` (empty segments give 0, OR's identity).

    A max-scatter of whole words would be wrong (max(0b01, 0b10) drops a
    bit), so each of the 32 bits takes its own max-scatter of 0/1 values,
    summed in int64 and narrowed back to int32 words.
    """
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    ids = ids.expand_as(data).contiguous()
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.int64, device=data.device)
    for b in range(PACK_BITS):
        bit = ((data >> b) & 1).to(torch.int64)
        seg = torch.zeros_like(out).scatter_reduce_(0, ids, bit, "amax",
                                                    include_self=True)
        out += seg << b
    return _narrow(out)


def por(x: torch.Tensor, grid, axes: Sequence[str]) -> torch.Tensor:
    """Cross-rank bitwise OR of packed words over the grid's ``axes`` (the
    packed twin of the semiring all-reduce, ``distributed.Grid.pall``).
    NCCL has no OR reduction, so each axis in turn is an all-gather and an
    OR fold of the gathered leading axis: exact, and the words travel
    packed."""
    for axis in axes:
        x = or_reduce(grid.all_gather(x, (axis,)), (0,))
    return x


def check_tail_zero_host(words: np.ndarray, n_bits: int) -> bool:
    """Host check of the tail-word invariant: every padding bit above
    ``n_bits`` is zero. The packed word axis must be the LAST axis."""
    words = np.asarray(words).astype(np.int64) & (_SPAN - 1)
    live = padding_mask(n_bits).astype(np.int64) & (_SPAN - 1)
    return bool((words & ~live).max(initial=0) == 0)
