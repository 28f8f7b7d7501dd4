"""Betweenness centrality (Brandes) on the SlimSell engine.

Brandes' algorithm is two sweep phases per source, both of them real
semiring SpMMs over the layout the BFS family already uses:

* **forward**: a batched real-semiring multi-source BFS ([n, B], one
  column per source) that keeps the accumulated *path counts*:
  ``sigma[v]`` = the number of shortest s->v paths (the real sweep sums
  exactly the recurrence ``sigma[v] = sum_{u in pred(v)} sigma[u]``),
  beside the depth stamp ``d[v]``.
* **backward**: dependency back-propagation over the recorded levels.
  Each column walks its levels from the deepest toward the source; one
  real SpMM a level pushes ``(1 + delta[w]) / sigma[w]`` from level ``l``,
  and the rows at level ``l-1`` take ``delta[v] += sigma[v] * y[v]``. An
  adjacent vertex is a DAG successor iff its depth is exactly one more,
  so the level masks select the DAG's edges without building it. Each
  column carries its own level counter and goes inert at 0, so a batch of
  mixed eccentricities stays exact.

Path counts ride in float32: exact while every partial sum stays below
2^24, rounded above. The depths do not depend on the order of the adds
(``y > 0`` holds for any order of a sum of positive counts). The
backward division takes a denominator of 1 off its level mask, so no
inf or NaN is made even where the value is discarded. The dependencies
are folded on the host in float64 (``brandes_accumulate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import engine as eng
from .bfs import on_device
from .multi_bfs import _init_state_multi, _iter_batches
from .options import EngineConfig, check_choice


@dataclasses.dataclass
class BetweennessResult:
    scores: np.ndarray   # float64[n]; unnormalised (or nx-normalised) BC
    n_sources: int
    iterations: int      # forward + backward sweeps over all batches


# ------------------------------------------------------------- forward spec


def _fwd_init(n: int, roots: torch.Tensor, device) -> dict:
    state = _init_state_multi("real", n, roots, device)   # d / f / visited
    state["sigma"] = state["f"]                            # 1 at each root
    return state


def _fwd_update(state: dict, y: torch.Tensor, k: int):
    new = (y > 0) & ~state["visited"]
    d = torch.where(new, k, state["d"])
    sigma = torch.where(new, y, state["sigma"])   # y = sum of the preds' sigma
    f = torch.where(new, y, 0.0)
    return ({"d": d, "f": f, "sigma": sigma,
             "visited": state["visited"] | new}, new.any())


BRANDES_FORWARD_SPEC = eng.FixpointSpec(
    name="betweenness/forward",
    sr_name="real",
    batched=True,
    init_state=_fwd_init,
    frontier=lambda state, k: state["f"],
    source_bits=lambda state, k: state["f"] > 0,
    not_final=lambda state: ~state["visited"],
    update=_fwd_update,
    host_bits=lambda state, k, need_sb, need_nf:
        ((state["f"] > 0).cpu().numpy() if need_sb else None,
         (~state["visited"]).cpu().numpy() if need_nf else None),
)


# ------------------------------------------------------------ backward spec


def _bwd_frontier_mask(d: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """bool[n, B]: the rows at each column's current level (inert columns
    off)."""
    return (d == level[None, :]) & (level >= 1)[None, :]


def brandes_backward_spec(d: torch.Tensor,
                          sigma: torch.Tensor) -> eng.FixpointSpec:
    """The backward sweep over one batch's forward result: ``d`` int32[n, B]
    and ``sigma`` float32[n, B] are held here and copied into the state;
    the run's arg is each column's deepest level, ``d.max(dim=0)``."""

    def init_state(n, levels0, device):
        return {"delta": torch.zeros(d.shape, dtype=torch.float32,
                                     device=device),
                "level": levels0.to(device=device, dtype=torch.int32),
                "d": d, "sigma": sigma}

    def frontier(state, k):
        on = _bwd_frontier_mask(state["d"], state["level"])
        safe_sigma = torch.where(on, state["sigma"], 1.0)
        return torch.where(on, (1.0 + state["delta"]) / safe_sigma, 0.0)

    def update(state, y, k):
        level = state["level"]
        active = level >= 1
        # DAG predecessors of the emitting level: adjacent and exactly one
        # level shallower (``active`` keeps the d == -1 rows from matching
        # level - 1 once a column has gone inert)
        tgt = active[None, :] & (state["d"] == (level - 1)[None, :])
        delta = state["delta"] + torch.where(tgt, state["sigma"] * y, 0.0)
        level = torch.where(active, level - 1, level)
        return dict(state, delta=delta, level=level), (level >= 1).any()

    def host_bits(state, k, need_sb, need_nf):
        if not need_sb:
            return None, None
        return _bwd_frontier_mask(state["d"], state["level"]).cpu().numpy(), \
            None

    return eng.FixpointSpec(
        name="betweenness/backward",
        sr_name="real",
        batched=True,
        init_state=init_state,
        frontier=frontier,
        source_bits=lambda state, k: _bwd_frontier_mask(state["d"],
                                                        state["level"]),
        not_final=lambda state: state["d"] >= 0,
        update=update,
        host_bits=host_bits,
    )


# ------------------------------------------------------------- accumulation


def brandes_accumulate(delta, roots: np.ndarray,
                       n_real: Optional[int] = None) -> np.ndarray:
    """Fold one batch's dependency matrix into a BC partial sum.

    ``delta[:, b]`` is the dependency of every vertex on source
    ``roots[b]`` (a tensor on any device, or an array); Brandes excludes
    the source itself, so its row is zeroed per column before summing, in
    float64 on the host. ``n_real`` drops the padded trailing columns
    (batch padding repeats the last root, which would count it twice).
    """
    if isinstance(delta, torch.Tensor):
        delta = delta.cpu().numpy()
    delta = np.asarray(delta, np.float64)
    roots = np.asarray(roots)
    if n_real is not None:
        delta = delta[:, :n_real]
        roots = roots[:n_real]
    delta = delta.copy()
    delta[roots, np.arange(roots.shape[0])] = 0.0
    return delta.sum(axis=1)


# ----------------------------------------------------------------- public API


def betweenness(tiled, sources: Optional[Sequence[int]] = None, *,
                normalized: bool = False, batch_size: Optional[int] = None,
                slimwork: bool = True, max_iters: Optional[int] = None,
                config: Optional[EngineConfig] = None,
                device=None) -> BetweennessResult:
    """Brandes betweenness centrality through batched real SpMM sweeps.

    sources: the vertices to run Brandes from (None: all, the exact BC).
    A subset gives the partial-source estimate, equal to a reference
    Brandes restricted to the same sources; a repeated source counts
    again.
    normalized: scale by ``2 / ((n-1)(n-2))`` (networkx's undirected
    convention; 0 for n <= 2); unnormalised scores count unordered vertex
    pairs, halved for the undirected doubling.
    batch_size: sources per [n, B] batch (None: all in one batch).
    max_iters: the sweep cap of each forward and backward run (default
    n + 1).
    config: the engine knobs; both sweeps are push only.
    device: where to run; None means the card (raises when there is none).
    """
    config = config if config is not None else EngineConfig()
    check_choice("direction", config.direction, ("push",),
                 hint="Brandes sweeps are push-only (pull early-exit could "
                      "truncate the path-count sums)")
    if slimwork and tiled.inc_src is None:
        raise ValueError("SlimWork masks need the push index; rebuild the "
                         "layout with formats.build_slimsell")
    n = tiled.n
    if n > (1 << 24):
        raise ValueError("betweenness carries path counts in float32 (exact "
                         f"up to 2^24); n={n} would round")
    roots = np.arange(n, dtype=np.int64) if sources is None \
        else np.asarray(list(sources), np.int64)
    if roots.size == 0:
        raise ValueError("betweenness: sources must be non-empty")
    if roots.min() < 0 or roots.max() >= n:
        raise ValueError(f"betweenness: sources out of range for n={n}")
    tiled = on_device(tiled, device)
    cap = int(max_iters) if max_iters is not None else n + 1
    run = eng.run_fused if config.mode == "fused" else eng.run_hostloop
    bc = np.zeros(n, np.float64)
    iters = 0
    with config.applied():
        for _, batch, batch_p in _iter_batches(roots, batch_size):
            fwd = run(BRANDES_FORWARD_SPEC, tiled, torch.from_numpy(batch_p),
                      slimwork=slimwork, max_iters=cap)
            d, sigma = fwd.state["d"], fwd.state["sigma"]
            iters += fwd.iterations
            del fwd   # f and visited are not needed past the forward run
            levels0 = d.amax(dim=0)   # each column's eccentricity
            bwd = run(brandes_backward_spec(d, sigma), tiled, levels0,
                      slimwork=slimwork, max_iters=cap)
            bc += brandes_accumulate(bwd.state["delta"], batch_p,
                                     n_real=batch.size)
            iters += bwd.iterations
    bc /= 2.0   # undirected: each unordered pair counted from both ends
    if normalized:
        bc *= 2.0 / ((n - 1) * (n - 2)) if n > 2 else 0.0
    return BetweennessResult(scores=bc, n_sources=int(roots.size),
                             iterations=int(iters))
