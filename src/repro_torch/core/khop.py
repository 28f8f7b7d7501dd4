"""k-hop neighbourhoods on the SlimSell engine.

A k-hop query is a boolean BFS whose fixpoint loop is capped at depth k:
the engine iterates while ``cont and k <= max_iters``, so every BFS spec
stops at depth k when given ``max_iters=k``. This module runs ``core.bfs``
and ``core.multi_bfs`` (lane and packed, single-source and batched) with
that cap and turns the capped distances into a membership mask. At k = 0
the loop never runs, and the ball is the root alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .bfs import bfs
from .multi_bfs import multi_source_bfs
from .options import EngineConfig


@dataclasses.dataclass
class KHopResult:
    mask: np.ndarray        # bool[n] (or [B, n] batched): within k hops
    distances: np.ndarray   # int32, same shape; -1 beyond depth k
    iterations: np.ndarray  # sweeps run (scalar int, or int[n_batches])

    @property
    def count(self):
        """Vertices within k hops (per root when batched)."""
        return self.mask.sum(axis=-1)


def _resolve_k(k: Optional[int], n: int) -> int:
    if k is None:
        return n  # "within n hops" is reachability
    k = int(k)
    if k < 0:
        raise ValueError(f"khop: k must be >= 0 (or None for 'any'), got {k}")
    return k


def khop(tiled, root: int, k: Optional[int], *, packed: bool = False,
         slimwork: bool = True, config: Optional[EngineConfig] = None,
         device=None) -> KHopResult:
    """Vertices within ``k`` hops of ``root`` (``k=None``: reachability).

    A boolean BFS cut at depth ``k``: ``mask[v]`` iff a path of at most
    ``k`` edges reaches ``v``; ``distances`` keeps the hop count of the
    members and -1 outside the ball. Any direction of the config;
    ``packed=True`` runs SlimSell-B (push only) with the same result.
    device: where to run; None means the card (raises when there is none).
    """
    cap = _resolve_k(k, tiled.n)
    res = bfs(tiled, root, "boolean", packed=packed, slimwork=slimwork,
              max_iters=cap, config=config, device=device)
    d = res.distances
    return KHopResult(mask=d >= 0, distances=d,
                      iterations=np.asarray(res.iterations))


def khop_many(tiled, roots: Sequence[int], k: Optional[int], *,
              packed: bool = False, batch_size: Optional[int] = None,
              slimwork: bool = True, config: Optional[EngineConfig] = None,
              device=None) -> KHopResult:
    """Batched k-hop: one [n, B] boolean SpMM sweep a depth level for all
    ``roots`` at once (packed: 32 root columns a word plane); row i is
    ``khop(tiled, roots[i], k)``."""
    cap = _resolve_k(k, tiled.n)
    res = multi_source_bfs(tiled, roots, "boolean", packed=packed,
                           batch_size=batch_size, slimwork=slimwork,
                           max_iters=cap, config=config, device=device)
    d = res.distances
    return KHopResult(mask=d >= 0, distances=d,
                      iterations=np.asarray(res.iterations))
