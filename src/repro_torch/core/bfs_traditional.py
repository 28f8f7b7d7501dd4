"""Traditional (queue-based) BFS — the paper's Trad-BFS comparison target.

Vectorized top-down frontier expansion over CSR (the numpy analogue of the
optimized OpenMP Graph500 code [30] the paper benchmarks against), plus the
direction-optimizing variant [Beamer et al.] the paper cites as orthogonal.
Also serves as the correctness oracle the Graph500 harness validates against.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRGraph


def _expand(csr: CSRGraph, frontier: np.ndarray):
    starts = csr.indptr[frontier]
    counts = csr.indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return (np.empty(0, np.int64),) * 2
    # gather all neighbor ranges without a Python loop
    offs = np.repeat(starts + counts, counts)
    flat = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts), counts) + offs
    nbrs = csr.indices[flat].astype(np.int64)
    src = np.repeat(frontier, counts)
    return nbrs, src


def bfs_traditional(csr: CSRGraph, root: int, *, direction_optimizing: bool = False):
    """Returns (distances int32[n] with -1 unreachable, parents int32[n])."""
    n = csr.n
    d = np.full(n, -1, np.int32)
    p = np.full(n, -1, np.int32)
    d[root], p[root] = 0, root
    frontier = np.asarray([root], np.int64)
    level = 0
    nnz = csr.nnz
    while frontier.size:
        level += 1
        if direction_optimizing and frontier.size * 16 > n:
            # bottom-up: every unvisited vertex scans its neighbors
            unvisited = np.nonzero(d < 0)[0]
            nbrs, src = _expand(csr, unvisited)       # src = unvisited vertex
            hit = d[nbrs] == level - 1
            first = np.unique(src[hit], return_index=True)
            new, idx = first
            d[new] = level
            p[new] = nbrs[hit][idx]
            frontier = new
        else:
            nbrs, src = _expand(csr, frontier)
            fresh = d[nbrs] < 0
            nbrs, src = nbrs[fresh], src[fresh]
            new, idx = np.unique(nbrs, return_index=True)
            d[new] = level
            p[new] = src[idx]
            frontier = new
    return d, p
