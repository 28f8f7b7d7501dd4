"""Semiring SpMV/SpMM over the tiled SlimSell layout: the sweep primitives.

* ``slimsell_spmv`` — one frontier expansion (top-down / push) of BFS.
* ``slimsell_spmm`` — the matrix-RHS form: batched multi-source BFS, the
  frontier an [n, B] matrix.
* ``slimsell_pull`` / ``slimsell_pull_mm`` — the bottom-up (pull) sweeps
  of direction-optimizing BFS over the not-final rows, with a per-row
  (per (row, column)) early exit.
* ``slimsell_spmv_packed`` and ``slimsell_spmm`` under ``boolean_packed``
  — the SlimSell-B sweeps over packed words (``core.packing``): a
  frontier bitmap of ``ceil(n/32)`` words, or ``ceil(B/32)`` word planes
  of a batch.

Both take the implicit edge value (``val`` is never stored): an edge
contributes ``mul(edge_value, x[col])`` and a padding slot (col == -1) the
semiring ``zero`` (paper §III-B). A ``tile_mask`` (bool[T], SlimWork)
drops masked tiles: they contribute ``zero``.

``slimsell_spmv(..., weights=)`` is the stored-weight sweep (SlimSell-W):
``weights`` is a float32 [T, C, L] array aligned with ``cols``
(``SlimSellTiled.wts`` or a view of it) and an edge contributes
``mul(w, x[col])``, ``w + x[col]`` under ``minplus``: one relaxation of
SSSP. ``slimsell_spmm(..., weights=)`` is its matrix form, the weight
broadcast over the B columns: one relaxation of B roots at once. A padding slot still contributes ``zero``, whatever its weight.
``minplus`` needs the weights; the pull sweeps take none.

``slimsell_spmm(..., deg=)`` is the GCN aggregation (SlimSell-W with a
*derived* weight): under ``real`` an edge (v, u) contributes
``rsqrt(max(deg[v], 1)) * rsqrt(max(deg[u], 1)) * X[u, :]``, the weight
worked out from the degree vector (``gcn_edge_weight``) and never stored.

The device of the tensors picks the implementation: a CUDA tensor goes to
the hand-written kernel through ``kernels.ops``, a CPU tensor to the plain
PyTorch version in this module (``spmm_plain``), which is also the
reference the kernels are checked against on the card.

**The pull sweeps' function.** A chunk's kept tiles are visited in tile
order. For each vertex v with ``row_mask[v]`` set, y[v] is the reduction
over L of the **first** kept tile of v's chunk whose reduction is not the
semiring zero; y[v] is zero when ``row_mask[v]`` is false or no tile hits.
This is the TPU pull kernel's early exit (``repro/kernels/slimsell_pull.py``)
stated exactly, not the full reduction: on BFS's level-homogeneous
frontiers it gives the same distances, and under sel-max a valid (possibly
different) parent.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import packing
from .semiring import BOOLEAN, Semiring

# bytes one slice of the plain version's [t, C, L(, B)] gather may take
_GATHER_BYTES = 1 << 30


def gcn_edge_weight(deg: torch.Tensor, dtype: torch.dtype = torch.float32):
    """The symmetric-normalised GCN weight, derived from degrees: a callable
    of ``(rv_tile, safe_cols)`` (the row vertex of each slot's row, -1 on a
    padding row, and the slot's column with padding clamped to 0) giving
    ``rsqrt(max(deg, 1)[row]) * rsqrt(max(deg, 1)[col])``, in that order,
    computed in ``dtype`` (float32, as the JAX package does)."""
    d = deg.to(dtype).clamp_min(1.0)

    def w(rv_tile: torch.Tensor, safe_cols: torch.Tensor) -> torch.Tensor:
        return torch.rsqrt(d[rv_tile.clamp_min(0).long()]) \
            * torch.rsqrt(d[safe_cols.long()])
    return w


def tile_contributions(sr: Semiring, cols: torch.Tensor, x: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[t, C, L] (x [n]) or [t, C, L, B] (x [n, B]) contributions of each
    column slot: ``mul(edge_value, x[col])``, or ``mul(w, x[col])`` with
    stored ``weights`` [t, C, L] (the same for every column of x); ``zero``
    on padding."""
    pad = cols < 0
    g = x.index_select(0, cols.clamp_min(0).reshape(-1)).reshape(
        tuple(cols.shape) + tuple(x.shape[1:]))
    if x.ndim == 2:
        pad = pad[..., None]
    if weights is None:
        contrib = sr.edge(g)
    else:
        contrib = sr.mul(weights if x.ndim == 1 else weights[..., None], g)
    return torch.where(pad, torch.tensor(sr.zero, dtype=x.dtype,
                                         device=x.device), contrib)


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
               tile_mask: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch sweep for x [n] or [n, B]: gather, reduce over L,
    combine the tiles of each chunk (SlimChunk), scatter to vertex space.
    ``weights`` [T, C, L] are the stored edge values; with ``deg`` [n] the
    edge value is the GCN weight derived from it (``gcn_edge_weight``, in
    x's dtype), slice by slice; else the implicit one.

    Tiles are processed in slices so the [t, C, L(, B)] gather stays near
    ``_GATHER_BYTES``.
    """
    if weights is not None and deg is not None:
        raise ValueError("pass stored weights= or the GCN degrees deg=, not both")
    derived = None if deg is None else gcn_edge_weight(deg, x.dtype)
    T, C, L = tiled.cols.shape
    width = x.shape[1] if x.ndim == 2 else 1
    step = max(1, _GATHER_BYTES // (C * L * width * x.element_size()))
    zero = torch.tensor(sr.zero, dtype=x.dtype, device=x.device)
    y_blocks = torch.full((tiled.n_chunks, C) + tuple(x.shape[1:]), sr.zero,
                          dtype=x.dtype, device=x.device)
    for t0 in range(0, T, step):
        cols = tiled.cols[t0:t0 + step]
        w = None if weights is None else weights[t0:t0 + step]
        if derived is not None:
            rv = tiled.row_vertex.index_select(
                0, tiled.row_block[t0:t0 + step].long())[:, :, None]
            w = derived(rv, cols.clamp_min(0))                  # [t, C, L]
        red = sr.reduce(tile_contributions(sr, cols, x, w), dim=2)  # [t, C(, B)]
        if tile_mask is not None:
            m = tile_mask[t0:t0 + step].reshape((-1,) + (1,) * (red.ndim - 1))
            red = torch.where(m, red, zero)
        idx = tiled.row_block[t0:t0 + step].long().reshape(
            (-1,) + (1,) * (red.ndim - 1)).expand_as(red)
        y_blocks.scatter_reduce_(0, idx, red, sr.scatter_reduce,
                                 include_self=True)
    return _combine_and_scatter(sr, tiled, y_blocks)


def spmv_plain(sr: Semiring, tiled, x: torch.Tensor,
               tile_mask: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch SpMV: the SpMM over a one-column RHS."""
    return spmm_plain(sr, tiled, x[:, None], tile_mask, weights)[:, 0]


def pull_first_hits(sr: Semiring, tiled, X: torch.Tensor,
                    row_mask: torch.Tensor,
                    tile_mask: Optional[torch.Tensor] = None):
    """The plain batched pull for X [n, B] and row_mask bool[n, B]:
    returns ``(Y, rank)`` in vertex space, ``rank`` int32[n, B] the rank
    within its chunk of the tile each (v, b) took its value from (-1: not
    pending, or no kept tile hit).

    Loops over a tile's rank within its chunk; each step handles, in
    slices of about ``_GATHER_BYTES``, the chunks that have a tile of that
    rank, keep it, and still have a pending (row, column).
    """
    n_chunks, C = tiled.n_chunks, tiled.C
    B = X.shape[1]
    zero = torch.tensor(sr.zero, dtype=X.dtype, device=X.device)
    rv = tiled.row_vertex.long().reshape(-1)
    pad = rv < 0
    pending = row_mask.index_select(0, rv.clamp_min(0)).reshape(n_chunks, C, B)
    pending &= ~pad.reshape(n_chunks, C, 1)
    y_blocks = torch.full((n_chunks, C, B), sr.zero, dtype=X.dtype,
                          device=X.device)
    rank = torch.full((n_chunks, C, B), -1, dtype=torch.int32,
                      device=X.device)
    ptr = tiled.tile_ptr.long()
    n_tiles = ptr[1:] - ptr[:-1]
    max_rank = int(n_tiles.max()) if n_chunks else 0
    step = max(1, _GATHER_BYTES // (C * tiled.L * B * X.element_size()))
    for j in range(max_rank):
        live = (n_tiles > j) & pending.flatten(1).any(dim=1)
        chunks = live.nonzero().squeeze(1)
        tiles = ptr[chunks] + j
        if tile_mask is not None:
            kept = tile_mask[tiles]
            chunks, tiles = chunks[kept], tiles[kept]
        for s0 in range(0, chunks.numel(), step):
            ch, t = chunks[s0:s0 + step], tiles[s0:s0 + step]
            red = sr.reduce(tile_contributions(sr, tiled.cols[t], X), dim=2)
            hit = pending[ch] & (red != zero)                   # [k, C, B]
            y_blocks[ch] = torch.where(hit, red, y_blocks[ch])
            rank[ch] = torch.where(hit, j, rank[ch])
            pending[ch] = pending[ch] & ~hit
    ids = torch.where(pad, tiled.n, rv)
    Y = torch.full((tiled.n + 1, B), sr.zero, dtype=X.dtype, device=X.device)
    Y[ids] = y_blocks.reshape(-1, B)
    R = torch.full((tiled.n + 1, B), -1, dtype=torch.int32, device=X.device)
    R[ids] = rank.reshape(-1, B)
    return Y[: tiled.n], R[: tiled.n]


def pull_mm_plain(sr: Semiring, tiled, X: torch.Tensor,
                  row_mask: torch.Tensor,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch batched pull sweep: X, row_mask [n, B] -> Y [n, B]."""
    return pull_first_hits(sr, tiled, X, row_mask, tile_mask)[0]


def pull_plain(sr: Semiring, tiled, x: torch.Tensor, row_mask: torch.Tensor,
               tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch pull sweep: the batched one over one column."""
    return pull_mm_plain(sr, tiled, x[:, None], row_mask[:, None],
                         tile_mask)[:, 0]


def spmv_packed_plain(tiled, x_words: torch.Tensor,
                      tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain packed SpMV: int32[ceil(n/32)] frontier bitmap -> packed
    reach bitmap of the same shape. Gathers the word holding each
    column's bit and extracts the bit, ORs over L (a max of 0/1), combines
    the tiles of each chunk, scatters to vertex space and packs again."""
    T, C, L = tiled.cols.shape
    step = max(1, _GATHER_BYTES // (C * L * 4))
    y_blocks = torch.zeros((tiled.n_chunks, C), dtype=torch.int32,
                           device=x_words.device)
    for t0 in range(0, T, step):
        cols = tiled.cols[t0:t0 + step]
        bit = packing.gather_bits(x_words, cols.clamp_min(0))   # [t, C, L]
        red = torch.where(cols < 0, 0, bit).amax(dim=2)         # [t, C]
        if tile_mask is not None:
            red = torch.where(tile_mask[t0:t0 + step, None], red, 0)
        idx = tiled.row_block[t0:t0 + step].long()[:, None].expand_as(red)
        y_blocks.scatter_reduce_(0, idx, red, "amax", include_self=True)
    return packing.pack_bits(_combine_and_scatter(BOOLEAN, tiled, y_blocks) > 0)


def spmm_packed_plain(tiled, X_words: torch.Tensor,
                      tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain packed-plane SpMM: X int32[n, Wb] (32 roots per word) ->
    Y int32[n, Wb]. The word-wise OR of ``X[col, :]`` over L and over the
    chunk's kept tiles (the all-ones edge word ANDs to a no-op); each
    vertex owns one chunk row, which lands straight in Y."""
    T, C, L = tiled.cols.shape
    Wb = X_words.shape[1]
    step = max(1, _GATHER_BYTES // (C * L * Wb * 4))
    y_blocks = torch.zeros((tiled.n_chunks, C, Wb), dtype=torch.int32,
                           device=X_words.device)
    for t0 in range(0, T, step):
        cols = tiled.cols[t0:t0 + step]
        g = X_words.index_select(0, cols.clamp_min(0).reshape(-1)).reshape(
            tuple(cols.shape) + (Wb,))
        red = packing.or_reduce(torch.where(cols[..., None] < 0, 0, g), (2,))
        if tile_mask is not None:
            red = torch.where(tile_mask[t0:t0 + step, None, None], red, 0)
        y_blocks |= packing.segment_or(red, tiled.row_block[t0:t0 + step],
                                       tiled.n_chunks)
    rv = tiled.row_vertex.reshape(-1).long()
    Y = torch.zeros((tiled.n + 1, Wb), dtype=torch.int32, device=X_words.device)
    Y[torch.where(rv < 0, tiled.n, rv)] = y_blocks.reshape(-1, Wb)
    return Y[: tiled.n]


def slimsell_spmv(sr: Semiring, tiled, x: torch.Tensor, *,
                  weights: Optional[torch.Tensor] = None,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A (x) over semiring ``sr``; x [n] -> y [n] in vertex space.
    ``weights`` [T, C, L]: the stored per-slot edge values, the min-plus
    SSSP operand (``minplus`` raises without them)."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.spmv(sr, tiled, x, tile_mask=tile_mask, weights=weights)


def slimsell_spmm(sr: Semiring, tiled, X: torch.Tensor, *,
                  deg: Optional[torch.Tensor] = None,
                  weights: Optional[torch.Tensor] = None,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y = A (X) over semiring ``sr``; X [n, B] -> Y [n, B] in vertex space.
    ``tile_mask`` applies SlimWork to the whole batch at once. ``weights``
    [T, C, L]: the stored per-slot edge values, the same for every column,
    the batched min-plus SSSP operand (``minplus`` raises without them, any
    other semiring with them). ``deg`` float32 [n], under ``real`` only: the
    GCN aggregation, each edge weighted by ``gcn_edge_weight(deg)``. Under
    the "or" semiring (``boolean_packed``) X holds packed word planes
    [n, ceil(B/32)] and the sweep takes the word-wise packed kernel."""
    from ..kernels import ops  # deferred: the kernels import this module
    if sr.reduction == "or" and weights is None and deg is None:
        return ops.spmm_packed(tiled, X, tile_mask=tile_mask)
    return ops.spmm(sr, tiled, X, tile_mask=tile_mask, weights=weights,
                    deg=deg)


def slimsell_spmv_packed(tiled, x_words: torch.Tensor, *,
                         tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SlimSell-B single-source sweep: packed frontier in, packed result
    out. ``x_words`` is int32[ceil(n/32)], bit ``v`` set iff vertex ``v``
    is in the frontier; returns the packed reach bitmap
    ``y[v] = OR_u A[v,u] & x[u]`` of the same shape, its tail padding bits
    zero."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.spmv_packed(tiled, x_words, tile_mask=tile_mask)


def slimsell_pull(sr: Semiring, tiled, x: torch.Tensor, *,
                  row_mask: torch.Tensor,
                  tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bottom-up sweep: x [n], row_mask bool[n] (the not-final rows) ->
    y [n]; first-hit semantics (module docstring), zero off ``row_mask``."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.pull(sr, tiled, x, row_mask, tile_mask=tile_mask)


def slimsell_pull_mm(sr: Semiring, tiled, X: torch.Tensor, *,
                     row_mask: torch.Tensor,
                     tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched bottom-up sweep: X [n, B], row_mask bool[n, B] -> Y [n, B];
    the early exit is per (row, column)."""
    from ..kernels import ops  # deferred: the kernels import this module
    return ops.pull_mm(sr, tiled, X, row_mask, tile_mask=tile_mask)
