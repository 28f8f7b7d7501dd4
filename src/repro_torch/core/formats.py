"""Graph representations: CSR and the tiled SlimSell layout (paper §II-D, §III-B).

Host-side (numpy) builders; the compute layout handed to PyTorch is the
*SlimChunk-regularized* SlimSell:

  cols:       int32[n_tiles, C, L]   column indices, -1 marks padding
  row_block:  int32[n_tiles]         owning chunk of each tile
  row_vertex: int32[n_chunks, C]     original vertex id of each chunk-row (-1 pad)
  tile_ptr:   int32[n_chunks + 1]    chunk c owns tiles tile_ptr[c]:tile_ptr[c+1]

Every chunk (C rows, padded to its longest row) is split vertically into
tiles of L columns (paper §III-D SlimChunk). ``val`` is never stored: the
edge value is derived from ``cols`` (paper §III-B). The tiles of one chunk
are contiguous, so ``tile_ptr`` lets one GPU thread block walk a whole chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .packing import packed_words


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no explicit device this raises; it never
    falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                               "the plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------------------------- CSR


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR of an (optionally undirected) graph. nnz = indices.size.

    ``weights`` is None for the unweighted BFS workloads, float32[nnz]
    aligned with ``indices`` for weighted ones.
    """
    n: int
    m_undirected: int          # number of undirected edges (nnz == 2m if undirected)
    indptr: np.ndarray         # int64[n+1]
    indices: np.ndarray        # int32[nnz]
    weights: Optional[np.ndarray] = None  # float32[nnz] edge weights (optional)

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def deg(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def build_csr(edges: np.ndarray, n: int, *, undirected: bool = True,
              dedup: bool = True,
              weights: Optional[np.ndarray] = None) -> CSRGraph:
    """Build CSR from an edge array [E, 2]; drops self loops, dedups.

    Undirected doubling mirrors a weight onto the reverse edge; dedup keeps
    the minimum weight of a duplicated (u, v) pair.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if weights.shape[0] != edges.shape[0]:
            raise ValueError(f"{weights.shape[0]} weights for "
                             f"{edges.shape[0]} edges")
        weights = weights[edges[:, 0] != edges[:, 1]]
    edges = edges[edges[:, 0] != edges[:, 1]]
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        if weights is not None:
            weights = np.concatenate([weights, weights])
    if dedup and edges.size:
        key = edges[:, 0] * n + edges[:, 1]
        if weights is None:
            key = np.unique(key)
        else:
            order = np.argsort(key, kind="stable")
            key_s, w_s = key[order], weights[order]
            key, starts = np.unique(key_s, return_index=True)
            weights = np.minimum.reduceat(w_s, starts)
        edges = np.stack([key // n, key % n], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0])) if edges.size else np.array([], np.int64)
    edges = edges[order]
    if weights is not None:
        weights = weights[order].astype(np.float32)
    counts = np.bincount(edges[:, 0], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    m_u = edges.shape[0] // 2 if undirected else edges.shape[0]
    return CSRGraph(n=n, m_undirected=int(m_u), indptr=indptr,
                    indices=edges[:, 1].astype(np.int32), weights=weights)


# ------------------------------------------------------------ Sell-C-σ ordering


def sellcs_order(deg: np.ndarray, sigma: int, *, descending: bool = True) -> np.ndarray:
    """Row permutation: sort by degree within windows of sigma rows (paper σ).

    Returns perm so that perm[i] = original vertex occupying sorted-row i.
    """
    n = deg.shape[0]
    sigma = max(1, min(int(sigma), n))
    perm = np.arange(n, dtype=np.int64)
    key = -deg if descending else deg
    for start in range(0, n, sigma):
        stop = min(start + sigma, n)
        window = np.argsort(key[start:stop], kind="stable")
        perm[start:stop] = window + start
    return perm


# ------------------------------------------------------- SlimSell tiled layout


# fields that become tensors in ``to_torch``, with their device dtypes
_TENSOR_FIELDS = {
    "cols": torch.int32, "row_block": torch.int32, "row_vertex": torch.int32,
    "tile_ptr": torch.int32, "cl": torch.int32, "deg": torch.int32,
    "inc_src": torch.int32, "inc_tile": torch.int32, "inc_ptr": torch.int64,
    "wts": torch.float32,
}


@dataclasses.dataclass
class SlimSellTiled:
    """SlimChunk-regularized SlimSell; arrays are host numpy until ``to_torch``.

    ``inc_src``/``inc_tile`` are the *push index*: the deduplicated
    (column vertex, tile) incidence pairs, sorted by vertex, from which the
    push direction selects the tiles a frontier touches. ``inc_ptr`` is the
    CSR-style offset vector over those pairs. ``wts`` is the weighted
    variant's per-slot edge weight, present only when the CSR has weights.
    ``device`` is None for the host layout and the tensors' device after
    ``to_torch``.
    """
    n: int
    m_undirected: int
    C: int
    L: int
    sigma: int
    n_chunks: int
    n_tiles: int
    cols: np.ndarray        # int32[n_tiles, C, L]; -1 == padding
    row_block: np.ndarray   # int32[n_tiles]
    row_vertex: np.ndarray  # int32[n_chunks, C]; -1 == padding row
    tile_ptr: np.ndarray    # int32[n_chunks + 1]
    cl: np.ndarray          # int32[n_chunks]  chunk lengths (pre-tiling)
    deg: np.ndarray         # int64[n]
    inc_src: Optional[np.ndarray] = None   # int32[K]
    inc_tile: Optional[np.ndarray] = None  # int32[K]
    inc_ptr: Optional[np.ndarray] = None   # int64[n+1]
    wts: Optional[np.ndarray] = None       # float32[n_tiles, C, L]
    device: Optional[torch.device] = None
    # the SpMM and SpMV kernels' work lists on the device, each with the
    # tile_ptr and cl it was built from (kernels.ops, at the layout's first
    # launch of those kernels)
    spmm_work: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                   compare=False)
    spmv_work: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                   compare=False)
    # whether the adjacency is symmetric (``is_symmetric``), with the cols,
    # row_block and row_vertex it was worked out from
    symmetric: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    @property
    def n_x(self) -> int:
        """Rows of a sweep's operand: every vertex (a shard of the
        distributed partition takes only its column range)."""
        return self.n

    @property
    def owns_all_rows(self) -> bool:
        """Every vertex is a row of some chunk, so a sweep writes every row
        of its output (a shard's chunks hold only its row range)."""
        return True

    def to_torch(self, device=None) -> "SlimSellTiled":
        """The host layout as tensors on ``device`` (default: the card;
        raises when there is none)."""
        return layout_to_torch(self, device)


def layout_to_torch(layout, device=None):
    """A host layout (``SlimSellTiled``, or a shard of the distributed
    partition) with each array field of ``_TENSOR_FIELDS`` it has as a
    tensor on ``device`` (default: the card; raises when there is none)."""
    if layout.device is not None:
        raise ValueError(f"the layout is already on {layout.device}")
    dev = resolve_device(device)
    moved = {name: None if getattr(layout, name) is None else
             torch.from_numpy(np.ascontiguousarray(getattr(layout, name))).to(
                 device=dev, dtype=dtype)
             for name, dtype in _TENSOR_FIELDS.items() if hasattr(layout, name)}
    return dataclasses.replace(layout, device=dev, **moved)


def is_symmetric(tiled) -> bool:
    """Whether the layout's adjacency is symmetric: for every edge (v, u),
    a slot of v's row holding u, there is an edge (u, v), as often. Then the
    GCN-normalised operator ``rsqrt(deg[v]) rsqrt(deg[u])`` is symmetric
    too, whatever ``deg`` holds, and the backward of the GCN aggregation is
    the same sweep (``kernels.autograd.gcn_aggregate``). ``build_csr``'s
    undirected default gives such a layout; a directed one does not. Worked
    out from the layout's own arrays (slots holding a column, in rows of a
    vertex) once and kept on the layout (``tiled.symmetric``, beside the
    arrays it was worked out from); a layout whose operand is not its
    vertex set (a shard of the 2D partition) is never symmetric."""
    arrays = (tiled.cols, tiled.row_block, tiled.row_vertex)
    memo = getattr(tiled, "symmetric", None)
    if memo is not None and all(a is b for a, b in zip(memo[:3], arrays)):
        return memo[3]
    if tiled.n_x != tiled.n:
        result = False
    else:
        cols = torch.as_tensor(tiled.cols)
        rows = torch.as_tensor(tiled.row_vertex).index_select(
            0, torch.as_tensor(tiled.row_block).long())         # [T, C]
        rows = rows[:, :, None].expand(cols.shape)
        keep = (cols >= 0) & (rows >= 0)
        v, u = rows[keep].long(), cols[keep].long()
        n = int(tiled.n)
        result = bool(torch.equal(torch.sort(v * n + u).values,
                                  torch.sort(u * n + v).values))
    if hasattr(tiled, "symmetric"):
        tiled.symmetric = (*arrays, result)
    return result


def layout_signature(tiled: SlimSellTiled) -> tuple:
    """Stable hashable identity of a built layout's shapes: two layouts
    with equal signatures give the engine the same shapes (tile grid,
    chunk count, push index and weights present or not). It hashes
    shapes, not contents. The last element is the SlimSell-B word count
    ``ceil(n/32)`` of the packed frontier and visited bitmaps."""
    return (int(tiled.n), int(tiled.m_undirected), int(tiled.C),
            int(tiled.L), int(tiled.sigma), int(tiled.n_chunks),
            int(tiled.n_tiles), tiled.inc_src is not None,
            tiled.wts is not None, packed_words(tiled.n))


def chunk_tile_ptr(row_block: np.ndarray, n_chunks: int) -> np.ndarray:
    """int32[n_chunks + 1] tile offsets of each chunk; needs ``row_block``
    sorted, which holds because a chunk's tiles are contiguous."""
    rb = np.asarray(row_block)
    if rb.size and np.any(np.diff(rb) < 0):
        raise ValueError("row_block must be non-decreasing (tiles of a chunk "
                         "are contiguous)")
    return np.searchsorted(rb, np.arange(n_chunks + 1)).astype(np.int32)


def build_push_index(cols: np.ndarray,
                     tile_chunk: int = 1 << 16) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicated (column vertex, tile) pairs of a cols array, vertex-sorted.

    Processed in slices of ``tile_chunk`` tiles so transient memory stays a
    small multiple of one slice; the final vertex-major order comes from
    one stable sort over the K pairs.
    """
    n_tiles = cols.shape[0]
    srcs, tiles = [], []
    for t0 in range(0, n_tiles, tile_chunk):
        blk = cols[t0:t0 + tile_chunk]
        flat = blk.reshape(blk.shape[0], -1).astype(np.int64)
        t_idx = np.repeat(np.arange(flat.shape[0], dtype=np.int64),
                          flat.shape[1])
        flat = flat.reshape(-1)
        ok = flat >= 0
        key = np.unique(t_idx[ok] * (flat.max(initial=0) + 1) + flat[ok]) \
            if ok.any() else np.empty(0, np.int64)
        base = flat.max(initial=0) + 1
        tiles.append((key // base + t0).astype(np.int32))
        srcs.append((key % base).astype(np.int32))
    inc_src = np.concatenate(srcs) if srcs else np.empty(0, np.int32)
    inc_tile = np.concatenate(tiles) if tiles else np.empty(0, np.int32)
    order = np.argsort(inc_src, kind="stable")
    return inc_src[order], inc_tile[order]


def _sorted_chunk_lengths(deg: np.ndarray, C: int, sigma: int):
    """(perm, cl): the Sell-C-sigma row order and each chunk's length, the
    longest row of its C rows after the sigma-scoped sort (int64)."""
    n = deg.shape[0]
    perm = sellcs_order(deg, sigma)
    n_chunks = math.ceil(n / C)
    pdeg = np.zeros(n_chunks * C, dtype=np.int64)
    pdeg[:n] = deg[perm]
    return perm, pdeg.reshape(n_chunks, C).max(axis=1)


def build_slimsell(csr: CSRGraph, *, C: int = 8, L: int = 128,
                   sigma: Optional[int] = None) -> SlimSellTiled:
    """Construct the tiled SlimSell layout from CSR (paper §III-B + §III-D).

    If ``csr.weights`` is set the layout also carries the per-slot weights.
    """
    n, deg = csr.n, csr.deg
    weighted = csr.weights is not None
    sigma = n if sigma is None else max(1, min(int(sigma), n))
    perm, cl = _sorted_chunk_lengths(deg, C, sigma)
    cl = cl.astype(np.int32)
    n_chunks = cl.size

    tiles_per_chunk = np.maximum(1, np.ceil(cl / L).astype(np.int64))
    n_tiles = int(tiles_per_chunk.sum())
    cols = np.full((n_tiles, C, L), -1, dtype=np.int32)
    wts = np.zeros((n_tiles, C, L), dtype=np.float32) if weighted else None
    row_block = np.zeros(n_tiles, dtype=np.int32)
    row_vertex = np.full((n_chunks, C), -1, dtype=np.int32)

    tile_start = np.zeros(n_chunks + 1, dtype=np.int64)
    np.cumsum(tiles_per_chunk, out=tile_start[1:])

    for c in range(n_chunks):
        t0 = tile_start[c]
        row_block[t0:tile_start[c + 1]] = c
        width = int(tiles_per_chunk[c]) * L
        buf = np.full((C, width), -1, dtype=np.int32)
        buf_w = np.zeros((C, width), dtype=np.float32) if weighted else None
        for r in range(C):
            row = c * C + r
            if row >= n:
                continue
            v = perm[row]
            row_vertex[c, r] = v
            nbr = csr.indices[csr.indptr[v]:csr.indptr[v + 1]]
            buf[r, :nbr.size] = nbr
            if weighted:
                buf_w[r, :nbr.size] = csr.weights[csr.indptr[v]:csr.indptr[v + 1]]
        cols[t0:tile_start[c + 1]] = buf.reshape(C, -1, L).transpose(1, 0, 2)
        if weighted:
            wts[t0:tile_start[c + 1]] = buf_w.reshape(C, -1, L).transpose(1, 0, 2)

    inc_src, inc_tile = build_push_index(cols)
    inc_ptr = np.searchsorted(inc_src, np.arange(n + 1)).astype(np.int64)
    return SlimSellTiled(
        n=n, m_undirected=csr.m_undirected, C=C, L=L, sigma=sigma,
        n_chunks=n_chunks, n_tiles=n_tiles, cols=cols, row_block=row_block,
        row_vertex=row_vertex, tile_ptr=tile_start.astype(np.int32), cl=cl,
        deg=deg, inc_src=inc_src, inc_tile=inc_tile, inc_ptr=inc_ptr, wts=wts,
    )


# ----------------------------------------------------------- storage accounting


@dataclasses.dataclass(frozen=True)
class StorageSummary:
    """Sizes in 32-bit cells (paper Table III)."""
    n: int
    m: int
    nnz: int
    padding_flat: int    # P with paper-exact (per-chunk) padding
    padding_tiled: int   # P with L-granular SlimChunk tiling
    csr: int
    al: int
    sell_c_sigma: int
    slimsell: int
    slimsell_tiled: int

    @property
    def slimsell_vs_sellcs(self) -> float:
        return self.slimsell / self.sell_c_sigma

    @property
    def slimsell_vs_al(self) -> float:
        return self.slimsell / self.al


def storage_summary(csr: CSRGraph, *, C: int = 8, L: int = 128,
                    sigma: Optional[int] = None) -> StorageSummary:
    """The storage of CSR, an adjacency list, Sell-C-sigma and SlimSell
    (flat and tiled) for one graph, in 32-bit cells (paper Table III)."""
    n, nnz = csr.n, csr.nnz
    sigma = n if sigma is None else max(1, min(int(sigma), n))
    _, cl = _sorted_chunk_lengths(csr.deg, C, sigma)
    n_chunks = cl.size
    flat_cells = int((cl * C).sum())
    tiled_cells = int((np.maximum(1, np.ceil(cl / L)) * L * C).sum())
    return StorageSummary(
        n=n, m=csr.m_undirected, nnz=nnz, padding_flat=flat_cells - nnz,
        padding_tiled=tiled_cells - nnz,
        csr=2 * nnz + n,
        al=nnz + n,
        sell_c_sigma=2 * flat_cells + 2 * n_chunks,
        slimsell=flat_cells + 2 * n_chunks,
        slimsell_tiled=tiled_cells + 2 * n_chunks,
    )
