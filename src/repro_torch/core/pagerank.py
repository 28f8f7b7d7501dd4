"""PageRank on the SlimSell engine: damped real-semiring power iteration.

The first spec whose state is not monotone. BFS, SSSP and CC converge
because their state only tightens, so "nothing changed" certifies the
fixpoint. PageRank rewrites the whole rank vector each sweep,

    r' = (1 - a)/n  +  a * (A_colstoch @ r  +  dangling_mass/n),

so convergence comes from the L1 residual ``sum |r' - r|`` (continue
while it is above ``tol``), and a run that never gets there still ends at
the engine's ``k <= max_iters`` guard.

The column-stochastic product rides the unweighted layout: the sweep's
payload is pre-scaled per source, ``x[u] = r[u] / deg[u]``, and the real
semiring SpMV sums exactly that product. Dangling vertices (degree 0)
spread their rank uniformly through a scalar term, as
``networkx.pagerank`` does. Each sweep's residual goes into a ring of
``engine.WORK_LOG`` entries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import engine as eng
from .bfs import on_device
from .engine import WORK_LOG
from .options import EngineConfig, check_choice

#: the serving path's sweep cap: a=0.85 shrinks the L1 error by ~a a sweep,
#: so 256 sweeps reach ~1e-18, far past float32's resolution
PAGERANK_MAX_ITERS = 256


@dataclasses.dataclass
class PageRankResult:
    ranks: np.ndarray        # float32[n]; sums to 1
    iterations: int
    residuals: np.ndarray    # float32[iterations]; L1 residual per sweep
    converged: bool          # final residual <= tol (vs stopped at max_iters)


def pagerank_views(deg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inv_deg, dangling)`` of a degree vector: ``inv_deg[u] = 1/deg[u]``
    (0 for a dangling vertex) scales the payload into the column-stochastic
    product; ``dangling`` marks the degree-0 vertices. The divisor is kept
    at 1 or more, so no inf is made even where it is not used."""
    deg = deg.to(torch.float32)
    dangling = deg <= 0
    inv_deg = torch.where(dangling, 0.0, 1.0 / deg.clamp_min(1.0))
    return inv_deg, dangling


def pagerank_spec(n: int, damping: float, tol: float, inv_deg: torch.Tensor,
                  dangling: torch.Tensor) -> eng.FixpointSpec:
    """PageRank as a fixpoint spec: real semiring, push only, every vertex
    a source and not final in every sweep. The per-run constants (damping
    ``a`` and ``tol`` as float32, the two views of the degrees) are held
    here."""
    device = inv_deg.device
    a = torch.tensor(damping, dtype=torch.float32, device=device)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=device)
    every = torch.ones(n, dtype=torch.bool, device=device)

    def init_state(n_, arg, device_):
        return {"r": torch.full((n,), 1.0 / n, dtype=torch.float32,
                                device=device_),
                "resid": torch.tensor(float("inf"), device=device_),
                "resid_log": torch.zeros(WORK_LOG, dtype=torch.float32,
                                         device=device_)}

    def update(state, y, k):
        r = state["r"]
        dangling_mass = torch.where(dangling, r, 0.0).sum()
        r_new = (1.0 - a) / n + a * (y + dangling_mass / n)
        resid = (r_new - r).abs().sum()
        resid_log = state["resid_log"].clone()
        resid_log[min(k - 1, WORK_LOG - 1)] = resid
        return ({"r": r_new, "resid": resid, "resid_log": resid_log},
                resid > tol_t)

    return eng.FixpointSpec(
        name="pagerank",
        sr_name="real",
        init_state=init_state,
        frontier=lambda state, k: state["r"] * inv_deg,
        # the iteration is dense: every vertex re-emits its rank each sweep
        source_bits=lambda state, k: every,
        not_final=lambda state: every,
        update=update,
        host_bits=lambda state, k, need_sb, need_nf: (np.ones(n, bool), None),
    )


def pagerank(tiled, *, damping: float = 0.85, tol: float = 1e-6,
             slimwork: bool = True, max_iters: Optional[int] = None,
             config: Optional[EngineConfig] = None,
             device=None) -> PageRankResult:
    """Damped PageRank over the SlimSell layout; ``ranks`` sums to 1.

    damping: the factor ``a`` in (0, 1); ``(1-a)/n`` is the uniform restart.
    tol: stop when the L1 residual ``sum |r' - r|`` is at most ``tol``;
    otherwise the engine stops at ``max_iters`` (default
    ``PAGERANK_MAX_ITERS``) with ``converged=False``.
    config: the engine knobs; the sweep is push only and dense (SlimWork
    masks keep every tile that holds an edge).
    device: where to run; None means the card (raises when there is none).
    """
    config = config if config is not None else EngineConfig()
    check_choice("direction", config.direction, ("push",),
                 hint="the PageRank sweep is push-only")
    if not 0.0 < damping < 1.0:
        raise ValueError(f"pagerank: damping must be in (0, 1), got {damping}")
    if not tol > 0.0:
        raise ValueError(f"pagerank: tol must be > 0, got {tol}")
    if slimwork and tiled.inc_src is None:
        raise ValueError("SlimWork masks need the push index; rebuild the "
                         "layout with formats.build_slimsell")
    tiled = on_device(tiled, device)
    cap = int(max_iters) if max_iters is not None else PAGERANK_MAX_ITERS
    inv_deg, dangling = pagerank_views(tiled.deg)
    spec = pagerank_spec(tiled.n, damping, tol, inv_deg, dangling)
    with config.applied():
        if config.mode == "fused":
            res = eng.run_fused(spec, tiled, 0, slimwork=slimwork, max_iters=cap)
        else:
            res = eng.run_hostloop(spec, tiled, 0, slimwork=slimwork,
                                   max_iters=cap)
    resid = float(res.state["resid"])
    return PageRankResult(
        ranks=res.state["r"].cpu().numpy(), iterations=res.iterations,
        residuals=res.state["resid_log"].cpu().numpy()[:res.iterations],
        converged=bool(resid <= tol))
