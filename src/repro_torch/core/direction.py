"""Direction-optimizing traversal: Beamer's push/pull heuristic, algebraically.

The two directions are two ways of selecting which tiles a semiring sweep
touches:

* **push** (top-down): the tiles holding at least one frontier column,
  found through the precomputed (column vertex, tile) push index
  ``tiled.inc_src``/``inc_tile``. Work ∝ edges out of the frontier.
* **pull** (bottom-up): the tiles of chunks with at least one not-final
  row (SlimWork's own criterion), swept by ``slimsell_pull`` with per-row
  masking and a per-row early exit. Work ∝ edges of the unexplored rows.

``choose_direction`` is the classic alpha/beta switch, evaluated each
iteration from the degree vector:

  push -> pull  when  m_frontier > m_unexplored / alpha       (frontier heavy)
  pull -> push  when  |frontier| < n / beta
                and   m_frontier <= m_unexplored / alpha      (tail guard)

The tail guard departs from Beamer's pull->push rule because the push
granularity is the SlimSell tile: a tiny scattered frontier can still touch
many tiles while the pull sweep is down to the last unexplored chunks.

The functions take bits of shape [n] or [n, B] (a trailing batch axis
gives per-column statistics and directions); ``choose_direction_host`` is
the scalar twin the hostloop engine calls with numpy sums.
"""
from __future__ import annotations

import torch

PUSH = 0
PULL = 1

# Beamer et al.'s published defaults (SC'12 §4); tuned for Graph500 Kronecker.
ALPHA = 14.0
BETA = 24.0


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
    """bool[T]: tiles containing ≥1 frontier column, via the push index.

    A pair whose tile id is T is padding (a shard of the distributed
    partition pads its pairs to the widest shard's count with tile id T,
    as the JAX package's segment ops drop): it lands in a slot past the
    mask, which is cut off."""
    if fbits.ndim > 1:
        fbits = fbits.any(dim=-1)
    hit = fbits.index_select(0, tiled.inc_src).to(torch.int32)
    count = torch.zeros(tiled.n_tiles + 1, dtype=torch.int32,
                        device=fbits.device)
    return count.index_add_(0, tiled.inc_tile, hit)[:tiled.n_tiles] > 0


def edge_counts(deg: torch.Tensor, fbits: torch.Tensor, nf: torch.Tensor):
    """(m_frontier, m_unexplored, |frontier|) as float32, per column if the
    bits are [n, B]; ``deg`` is the (undirected-doubled) int32 degree vector.

    The sums are taken exactly in int64 and only then cast to float32, so
    the result does not depend on the order of summation. A float32 sum
    over the degrees, as the JAX package takes it, rounds once m passes
    2^24 (scale 20 has m ≈ 32 M), and another order on the card could then
    flip a borderline switch; below 2^24 both are exact and agree bit for
    bit. The comparisons in ``choose_direction`` stay in float32.
    """
    d = deg[:, None] if fbits.ndim > 1 else deg
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    mf = torch.where(fbits, d, zero).sum(dim=0, dtype=torch.int64)
    mu = torch.where(nf, d, zero).sum(dim=0, dtype=torch.int64)
    nnz_f = fbits.sum(dim=0, dtype=torch.int64)
    return mf.float(), mu.float(), nnz_f.float()


def choose_direction(current: torch.Tensor, mf, mu, nnz_f, n: int, *,
                     alpha: float = ALPHA, beta: float = BETA) -> torch.Tensor:
    """Next direction(s), int32, given the current one(s) and the frontier
    statistics (float32 tensors of the same shape)."""
    to_pull = mf > mu / alpha
    to_push = (nnz_f < n / beta) & ~to_pull
    # "pull next?" as a bool is the direction, PULL being 1 and PUSH 0
    return torch.where(current == PUSH, to_pull, ~to_push).to(torch.int32)


def choose_direction_host(current: int, mf: float, mu: float, nnz_f: float,
                          n: int, *, alpha: float = ALPHA,
                          beta: float = BETA) -> int:
    """Host-scalar twin of ``choose_direction`` for the hostloop engine."""
    to_pull = mf > mu / alpha
    if current == PUSH:
        return PULL if to_pull else PUSH
    return PUSH if (nnz_f < n / beta and not to_pull) else PULL
