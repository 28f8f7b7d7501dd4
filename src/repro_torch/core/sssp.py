"""Delta-stepping SSSP over the min-plus semiring on weighted SlimSell.

The port of ``repro/core/sssp.py``. One relaxation sweep is one min-plus
SpMV over the stored per-slot weights (SlimSell-W, ``SlimSellTiled.wts``),

    y[v] = min_u ( w(v, u) + x[u] ),    x[u] = dist[u] on the source set,

and ``dist' = min(dist, y)`` is a batch of edge relaxations. On the card
the sweep is the stored-weight kernel (``kernels.ops.spmv(weights=)``).

Meyer & Sanders' delta-stepping, as one ``core.engine`` fixpoint: vertices
are bucketed by ``floor(dist / delta)`` and buckets settle in order; the
state carries a **phase**: ``_LIGHT`` relaxes the light edges (w <= delta)
of the bucket's frontier until no improvement lands back in bucket b,
``_HEAVY`` fires the settled bucket's heavy edges (w > delta) once and
jumps to the next non-empty bucket. One engine iteration is one sweep.

The light/heavy split is two views of ``wts`` with the other class's slots
set to +inf, the min-plus zero, built once per call. The JAX package picks
the view with a ``lax.cond`` on the device phase; here the phase lives on
the host: the update brings over the one bit that decides it (light: did
an improvement land in bucket b; heavy: is any bucket left), and that copy
is also the loop's continue flag, so a sweep costs one copy to the host,
as a BFS iteration does. SlimWork sweeps only the tiles holding a source
column, through the push index.

``delta=inf`` is Bellman-Ford (one bucket); ``delta -> 0`` approaches
Dijkstra's settling order. Weights must be non-negative.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from . import engine as eng
from . import semiring as sm
from .bfs import on_device
from .options import EngineConfig, check_choice
from .spmv import _combine_and_scatter

_LIGHT, _HEAVY = 0, 1


@dataclasses.dataclass
class SSSPResult:
    distances: np.ndarray          # float32[n]; +inf unreachable
    parents: Optional[np.ndarray]  # int32[n]; parent in SP tree; root -> root
    sweeps: int                    # total relaxation SpMVs (light + heavy)
    buckets: int                   # delta buckets processed
    delta: float                   # bucket width actually used
    work_log: Optional[np.ndarray] = None  # active tiles per sweep


# --------------------------------------------------------------- weight prep


def _require_weighted(tiled):
    if tiled.wts is None:
        raise ValueError(
            "sssp needs a weighted layout; build it from a CSR with weights "
            "(e.g. generators.with_random_weights) via formats.build_slimsell")


def _weight_stats(tiled) -> tuple[float, float]:
    """(min, mean) over the real (non-padding) slots, cached on the layout
    (``run_graph500_sssp`` calls ``sssp`` once per root on one layout).

    The mean is summed in float64 and rounded to float32, so the card and
    the CPU give the same value."""
    cached = getattr(tiled, "_weight_stats_cache", None)
    if cached is not None:
        return cached
    valid = tiled.cols >= 0
    w = tiled.wts
    wmin = torch.where(valid, w, float("inf")).min()
    wsum = torch.where(valid, w, 0.0).sum(dtype=torch.float64)
    cnt = max(int(valid.sum()), 1)
    stats = (float(wmin), float(np.float32(float(wsum) / cnt)))
    tiled._weight_stats_cache = stats
    return stats


def default_delta(tiled) -> float:
    """Mean edge weight: the standard bucket-width starting point.

    It agrees with the JAX package's ``default_delta`` to about 1e-6
    relative, not bit for bit: the JAX package sums the float32 weights in
    XLA's order, the port in float64. A delta that differs in the last bit
    can move a distance across a bucket boundary and so change the sweep
    and bucket counts; a comparison of counts passes the delta explicitly.
    """
    _, mean = _weight_stats(tiled)
    return max(float(mean), 1e-6)


def _resolve_delta(tiled, delta: Optional[float]) -> float:
    """Non-negative weights, positive bucket width, mean-edge-weight
    default. Returns the delta actually used."""
    wmin, _ = _weight_stats(tiled)
    if wmin < 0:
        raise ValueError(f"delta-stepping needs non-negative weights; "
                         f"min weight is {wmin}")
    if delta is None:
        delta = default_delta(tiled)
    delta = float(delta)
    if not delta > 0:
        raise ValueError(f"delta must be positive, got {delta}")
    return delta


# ----------------------------------------------------------------------- spec


def _begin_bucket(dist: torch.Tensor, settled: torch.Tensor,
                  delta: torch.Tensor):
    """(bucket index, its members, any live?): the jump to the next
    non-empty bucket. The bucket math is float32, so the minimum's bucket
    always holds the minimum; an unreached row gives floor(inf/delta) =
    inf, or nan under delta = inf, which compares False."""
    live = ~settled & torch.isfinite(dist)
    b = torch.floor(torch.where(live, dist, float("inf")).min() / delta)
    active = live & (torch.floor(dist / delta) == b)
    return b, active, live.any()


def _sssp_update(delta: torch.Tensor, state: dict, y: torch.Tensor, k: int):
    """One relaxation merge and the phase machine.

    light: re-enter the within-bucket fixpoint with the improvements that
    landed back in bucket b; once none do, switch to the heavy phase.
    heavy: the bucket is settled after its one heavy sweep; commit it and
    jump to the next non-empty bucket (done when none is left).
    Either way one bit comes to the host, and it decides the next phase.
    """
    nd = torch.minimum(state["dist"], y)
    improved = nd < state["dist"]
    if state["phase"] == _LIGHT:
        active = improved & (torch.floor(nd / delta) == state["b"])
        has_more = bool(active.any())  # the sweep's one copy to the host
        return {"dist": nd, "settled": state["settled"],
                "removed": state["removed"] | state["active"],
                "active": active, "phase": _LIGHT if has_more else _HEAVY,
                "b": state["b"], "buckets": state["buckets"]}, True
    settled = state["settled"] | state["removed"]
    b, active, live = _begin_bucket(nd, settled, delta)
    return {"dist": nd, "settled": settled,
            "removed": torch.zeros_like(settled), "active": active,
            "phase": _LIGHT, "b": b, "buckets": state["buckets"] + 1}, \
        bool(live)  # the sweep's one copy to the host


def _sources(state: dict) -> torch.Tensor:
    """The sweep's source set: the bucket's light-fixpoint frontier in the
    light phase; everything the bucket processed for the heavy sweep."""
    return state["active"] if state["phase"] == _LIGHT else state["removed"]


def weight_views(wts: torch.Tensor, delta: float):
    """(light, heavy): the views of ``wts`` with the slots of the other
    class (w <= delta is light) set to +inf, the min-plus zero; the
    comparison is in float32, as the JAX package's."""
    delta_t = torch.tensor(delta, dtype=torch.float32, device=wts.device)
    inf = float("inf")
    return (torch.where(wts <= delta_t, wts, inf),
            torch.where(wts > delta_t, wts, inf))


def sssp_spec(tiled, delta: float) -> eng.FixpointSpec:
    """Delta-stepping as a fixpoint spec over one weighted layout. The
    light and heavy views of ``wts`` ([T, C, L] each) are built here, once
    per call."""
    wts = tiled.wts
    inf = torch.tensor(float("inf"), device=wts.device)
    delta_t = torch.tensor(delta, dtype=torch.float32, device=wts.device)
    light, heavy = weight_views(wts, delta)

    def init_state(n, root, device):
        dist = torch.full((n,), float("inf"), device=device)
        dist[root] = 0.0
        settled = torch.zeros(n, dtype=torch.bool, device=device)
        b, active, _ = _begin_bucket(dist, settled, delta_t)
        return {"dist": dist, "settled": settled,
                "removed": torch.zeros_like(settled), "active": active,
                "phase": _LIGHT, "b": b, "buckets": 0}

    def host_bits(state, k, need_sb, need_nf):
        # push-only: the hostloop asks for the source bits alone
        return _sources(state).cpu().numpy(), None

    return eng.FixpointSpec(
        name="sssp",
        sr_name="minplus",
        init_state=init_state,
        frontier=lambda state, k: torch.where(_sources(state), state["dist"],
                                              inf),
        source_bits=lambda state, k: _sources(state),
        update=lambda state, y, k: _sssp_update(delta_t, state, y, k),
        host_bits=host_bits,
        weights=lambda state: light if state["phase"] == _LIGHT else heavy,
    )


# -------------------------------------------------------- parents (weighted DP)


def sssp_parents(tiled, dist: torch.Tensor, root: int, *, rtol: float = 1e-6,
                 atol: float = 1e-6) -> torch.Tensor:
    """Weighted DP transform: for each v pick a neighbor u whose relaxation
    is tight, ``|dist[u] + w(v, u) - dist[v]| <= atol + rtol * |dist[v]|``
    (one sel-max sweep; the largest score wins).

    Positive-weight parents are preferred over zero-weight ones (a ``+ n``
    score bonus), so parent chains strictly decrease ``dist`` whenever any
    strictly-closer tight parent exists. The score (id + 1, bonus + n) is
    a float32, exact up to 2^24, so n is capped at 2^23. Returns int32[n]
    with p[root] = root, -1 where v is unreachable.
    """
    n = tiled.n
    if n > (1 << 23):
        raise ValueError("sssp_parents carries (vertex id + n) scores in "
                         "float32 (exact up to 2^24), so n is capped at "
                         f"2^23; got n={n}")
    cols, wts = tiled.cols, tiled.wts
    pad = cols < 0
    safe = cols.clamp_min(0)
    d_nbr = dist.index_select(0, safe.reshape(-1)).reshape(cols.shape) + wts
    rv_tile = tiled.row_vertex.index_select(0, tiled.row_block)       # [T, C]
    d_row = dist.index_select(0, rv_tile.clamp_min(0).reshape(-1)).reshape(
        rv_tile.shape)[:, :, None]
    tight = (~pad) & torch.isfinite(d_row) \
        & ((d_nbr - d_row).abs() <= atol + rtol * d_row.abs())
    score = torch.where(tight, (safe + 1).to(torch.float32)
                        + torch.where(wts > 0, float(n), 0.0), 0.0)
    tile_red = score.amax(dim=-1)                                     # [T, C]
    y_blocks = torch.zeros((tiled.n_chunks, tiled.C), device=cols.device)
    idx = tiled.row_block.long()[:, None].expand_as(tile_red).contiguous()
    y_blocks.scatter_reduce_(0, idx, tile_red, "amax", include_self=True)
    p1 = _combine_and_scatter(sm.SELMAX, tiled, y_blocks)
    p1 = torch.where(p1 > n, p1 - n, p1)  # strip the positive-weight bonus
    p = p1.to(torch.int32) - 1
    p[root] = root
    return p


# ------------------------------------------------------------- host oracle


def dijkstra_reference(csr, root: int) -> np.ndarray:
    """Host Dijkstra over CSR (binary heap), the validation oracle:
    float64 accumulation, returned as float32, +inf where unreachable."""
    if csr.weights is None:
        raise ValueError("dijkstra_reference needs a weighted CSR")
    dist = np.full(csr.n, np.inf, np.float64)
    dist[root] = 0.0
    heap = [(0.0, int(root))]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        s, e = csr.indptr[v], csr.indptr[v + 1]
        for u, w in zip(csr.indices[s:e], csr.weights[s:e]):
            nd = d + float(w)
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, int(u)))
    return dist.astype(np.float32)


# ----------------------------------------------------------------- public API


def sssp(tiled, root: int, *, delta: Optional[float] = None,
         need_parents: bool = False, slimwork: bool = True,
         max_iters: Optional[int] = None, log_work: bool = False,
         config: Optional[EngineConfig] = None, device=None) -> SSSPResult:
    """Single-source shortest paths from ``root`` by delta-stepping.

    delta: bucket width (None -> mean edge weight; ``inf`` -> Bellman-Ford).
    config: the engine knobs; mode "fused" (state on the device, one copy
    to the host per sweep) or "hostloop" (SlimWork tile masks in numpy).
    Delta-stepping is push-only, so the config's direction must be "push".
    max_iters: the sweep cap, 4n + 16 by default.
    device: where to run; None means the card (raises when there is none).
    Returns float32 distances (+inf where unreachable) and, when asked,
    the shortest-path-tree parents from the weighted DP sweep.
    """
    config = config if config is not None else EngineConfig()
    check_choice("direction", config.direction, ("push",),
                 hint="delta-stepping relaxations are push-only")
    _require_weighted(tiled)
    if slimwork and tiled.inc_src is None:
        raise ValueError("SlimWork source masks need the push index; rebuild "
                         "the layout with formats.build_slimsell")
    tiled = on_device(tiled, device)
    delta = _resolve_delta(tiled, delta)
    n = tiled.n
    max_iters = int(max_iters) if max_iters is not None else 4 * n + 16
    root = int(root)
    if not 0 <= root < n:
        raise ValueError(f"root {root} out of range for n={n}")
    spec = sssp_spec(tiled, delta)
    with config.applied():
        if config.mode == "fused":
            res = eng.run_fused(spec, tiled, root, slimwork=slimwork,
                                max_iters=max_iters, log_work=log_work)
        else:
            res = eng.run_hostloop(spec, tiled, root, slimwork=slimwork,
                                   max_iters=max_iters)
    dist = res.state["dist"]
    parents = None
    if need_parents:
        parents = sssp_parents(tiled, dist, root).cpu().numpy()
    return SSSPResult(distances=dist.cpu().numpy(), parents=parents,
                      sweeps=res.iterations, buckets=res.state["buckets"],
                      delta=delta,
                      work_log=res.work_log if log_work else None)
