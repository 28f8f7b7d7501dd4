"""Push-direction tile selection (paper §III-C SlimWork, top-down BFS).

The push direction sweeps only the tiles that hold at least one frontier
column, found through the precomputed (column vertex, tile) push index
``tiled.inc_src``/``inc_tile``. The functions take bits of shape [n] or
[n, B]; a batch shares one tile set (the SpMM advances every column on
each tile).
"""
from __future__ import annotations

import torch


def frontier_bits(sr_name: str, state, k: int) -> torch.Tensor:
    """bool[n] (or [n, B]): vertices discovered at distance k-1 — the
    frontier about to be expanded by iteration ``k``.

    real/boolean keep an explicit frontier indicator in ``f``; selmax keeps
    frontier ids in ``x``; tropical carries all distances in ``f``, so the
    frontier is the level set ``f == k-1``.
    """
    if sr_name == "tropical":
        return state["f"] == float(k - 1)
    if sr_name in ("real", "boolean"):
        return state["f"] > 0
    return state["x"] > 0


def push_tile_mask(tiled, fbits: torch.Tensor) -> torch.Tensor:
    """bool[T]: tiles containing ≥1 frontier column, via the push index."""
    if fbits.ndim > 1:
        fbits = fbits.any(dim=-1)
    hit = fbits.index_select(0, tiled.inc_src).to(torch.int32)
    count = torch.zeros(tiled.n_tiles, dtype=torch.int32, device=fbits.device)
    return count.index_add_(0, tiled.inc_tile, hit) > 0
