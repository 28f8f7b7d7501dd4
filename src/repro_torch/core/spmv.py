"""Semiring SpMV/SpMM over the tiled SlimSell layout: the sweep primitives.

* ``slimsell_spmv`` — one frontier expansion (top-down / push) of BFS.
* ``slimsell_spmm`` — the matrix-RHS form: batched multi-source BFS, the
  frontier an [n, B] matrix.

Both take the implicit edge value (``val`` is never stored): an edge
contributes ``mul(edge_value, x[col])`` and a padding slot (col == -1) the
semiring ``zero`` (paper §III-B). A ``tile_mask`` (bool[T], SlimWork)
drops masked tiles: they contribute ``zero``.

The device of the tensors picks the implementation: a CUDA tensor goes to
the hand-written kernel through ``kernels.ops``, a CPU tensor to the plain
PyTorch version in this module (``spmm_plain``), which is also the
reference the kernels are checked against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .semiring import Semiring

# bytes one slice of the plain version's [t, C, L(, B)] gather may take
_GATHER_BYTES = 1 << 30


def tile_contributions(sr: Semiring, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """[t, C, L] (x [n]) or [t, C, L, B] (x [n, B]) contributions of each
    column slot: ``mul(edge_value, x[col])``, ``zero`` on padding."""
    pad = cols < 0
    g = x.index_select(0, cols.clamp_min(0).reshape(-1)).reshape(
        tuple(cols.shape) + tuple(x.shape[1:]))
    if x.ndim == 2:
        pad = pad[..., None]
    return torch.where(pad, torch.tensor(sr.zero, dtype=x.dtype,
                                         device=x.device), sr.edge(g))


def _combine_and_scatter(sr: Semiring, tiled, y_blocks: torch.Tensor) -> torch.Tensor:
    """Chunk-row space [n_chunks, C(, B)] -> vertex space [n(, B)]; padding
    rows (row_vertex -1) land in a dropped bucket n."""
    rv = tiled.row_vertex.reshape(-1).long()
    ids = torch.where(rv < 0, tiled.n, rv)
    flat = y_blocks.reshape((-1,) + tuple(y_blocks.shape[2:]))
    if flat.ndim == 2:
        ids = ids[:, None].expand_as(flat)
    y = torch.full((tiled.n + 1,) + tuple(flat.shape[1:]), sr.zero,
                   dtype=flat.dtype, device=flat.device)
    y.scatter_reduce_(0, ids, flat, sr.scatter_reduce, include_self=True)
    return y[: tiled.n]


def spmm_plain(sr: Semiring, tiled, x: torch.Tensor,
               tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch sweep for x [n] or [n, B]: gather, reduce over L,
    combine the tiles of each chunk (SlimChunk), scatter to vertex space.

    Tiles are processed in slices so the [t, C, L(, B)] gather stays near
    ``_GATHER_BYTES``.
    """
    T, C, L = tiled.cols.shape
    width = x.shape[1] if x.ndim == 2 else 1
    step = max(1, _GATHER_BYTES // (C * L * width * x.element_size()))
    zero = torch.tensor(sr.zero, dtype=x.dtype, device=x.device)
    y_blocks = torch.full((tiled.n_chunks, C) + tuple(x.shape[1:]), sr.zero,
                          dtype=x.dtype, device=x.device)
    for t0 in range(0, T, step):
        red = sr.reduce(tile_contributions(sr, tiled.cols[t0:t0 + step], x),
                        dim=2)                                  # [t, C(, B)]
        if tile_mask is not None:
            m = tile_mask[t0:t0 + step].reshape((-1,) + (1,) * (red.ndim - 1))
            red = torch.where(m, red, zero)
        idx = tiled.row_block[t0:t0 + step].long().reshape(
            (-1,) + (1,) * (red.ndim - 1)).expand_as(red)
        y_blocks.scatter_reduce_(0, idx, red, sr.scatter_reduce,
                                 include_self=True)
    return _combine_and_scatter(sr, tiled, y_blocks)


def spmv_plain(sr: Semiring, tiled, x: torch.Tensor,
               tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch SpMV: the SpMM over a one-column RHS."""
    return spmm_plain(sr, tiled, x[:, None], tile_mask)[:, 0]


def slimsell_spmv(sr: Semiring, tiled, x: torch.Tensor, *,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A (x) over semiring ``sr``; x [n] -> y [n] in vertex space."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.spmv(sr, tiled, x, tile_mask=tile_mask)


def slimsell_spmm(sr: Semiring, tiled, X: torch.Tensor, *,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y = A (X) over semiring ``sr``; X [n, B] -> Y [n, B] in vertex space.
    ``tile_mask`` applies SlimWork to the whole batch at once."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.spmm(sr, tiled, X, tile_mask=tile_mask)
