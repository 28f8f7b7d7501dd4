"""Batched multi-source delta-stepping SSSP: many roots as one min-plus SpMM.

The port of ``repro/core/multi_sssp.py``. The Graph500 SSSP kernel searches
64 keys over one graph. Batching B roots turns the distance vector [n] into
a distance matrix [n, B] and every relaxation into a weighted min-plus SpMM
over SlimSell-W,

    Y[v, r] = min_u ( w(v, u) + X[u, r] ),

so one sweep reads the adjacency and the weight slots once and relaxes B
shortest-path trees. On the card the sweep is the stored-weight SpMM kernel
(``kernels.ops.spmm(weights=)``), which takes any B.

Delta buckets are per column: each root carries its own phase (light
fixpoint or heavy settle), bucket index, bucket and sweep counts and done
flag, as [B] tensors on the device, and the per-column source sets union
into one shared SlimWork tile mask. A sweep brings one value to the host,
the continue flag ``any(~done)``.

**One sweep operand for mixed phases.** Columns sit in different phases at
once, and one SpMM carries one weight operand, so the batch sweeps the
full ``wts`` and the per-column phase machines gate only the source sets.
This reproduces the per-root schedule exactly:

* a heavy edge (w > delta) relaxed early from a bucket-b source lands at
  ``dist + w > (b+1)*delta``, past bucket b, so it never enters the current
  bucket's active set and never changes the light fixpoint's sweep count;
* committing such an improvement early is harmless: it is a valid path
  length, merged with min, and the heavy sweep relaxes again from the
  bucket's final values, so the distances at every bucket jump are those
  of the light/heavy-view engine;
* light edges from the settled bucket are already at their fixpoint when
  the heavy phase fires, so the full-weight heavy sweep gives exactly the
  heavy-view improvements.

Hence row i of ``multi_source_sssp`` (distances, sweeps, buckets) equals
``sssp(tiled, roots[i])``: batching changes the schedule, never the answer.
A finished column's source set is empty and its counters freeze; the batch
ends when every column is done.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import engine as eng
from .bfs import on_device
from .multi_bfs import _columns_to_host, _iter_batches
from .options import EngineConfig, check_choice
from .sssp import (_HEAVY, _LIGHT, _require_weighted, _resolve_delta,
                   sssp_parents)


@dataclasses.dataclass
class MultiSSSPResult:
    """What ``multi_source_sssp`` returns: one row per root, vertex space.

    Row i equals ``sssp(tiled, roots[i]).distances``, and the per-root
    ``sweeps`` and ``buckets`` match too.
    """
    distances: np.ndarray          # float32[n_roots, n]; +inf unreachable
    parents: Optional[np.ndarray]  # int32[n_roots, n]; root -> root
    sweeps: np.ndarray             # int32[n_roots] relaxation sweeps per root
    buckets: np.ndarray            # int32[n_roots] delta buckets per root
    iterations: np.ndarray         # int32[n_batches] engine trips per batch
    delta: float                   # bucket width actually used
    roots: np.ndarray              # int32[n_roots]
    work_log: Optional[np.ndarray] = None  # int32[n_batches, WORK_LOG]


# ----------------------------------------------------------------------- spec


def _begin_bucket_cols(dist: torch.Tensor, settled: torch.Tensor,
                       delta: torch.Tensor):
    """Per-column ``sssp._begin_bucket``: (bucket index [B], members
    [n, B], any live? [B]), the jump to each column's next non-empty
    bucket."""
    live = ~settled & torch.isfinite(dist)                        # [n, B]
    b = torch.floor(torch.where(live, dist, float("inf")).amin(dim=0) / delta)
    active = live & (torch.floor(dist / delta) == b[None, :])
    return b, active, live.any(dim=0)


def _sources(state: dict) -> torch.Tensor:
    """Per-column source sets [n, B]: the bucket's light-fixpoint frontier
    for columns in the light phase, everything the bucket processed for
    columns firing their heavy sweep, nothing for finished columns."""
    src = torch.where((state["phase"] == _LIGHT)[None, :], state["active"],
                      state["removed"])
    return src & ~state["done"][None, :]


def _update(delta: torch.Tensor, state: dict, y: torch.Tensor):
    """One batched relaxation merge and B phase machines.

    Both the light and the heavy outcome are worked out ([n, B] masks) and
    chosen per column, the batched twin of ``sssp._sssp_update``; finished
    columns keep their state, so their counters stay those of the per-root
    runs. Returns the device flag "a column is not done".
    """
    is_light = state["phase"] == _LIGHT                           # [B]
    done = state["done"]                                          # [B]
    nd = torch.where(done[None, :], state["dist"],
                     torch.minimum(state["dist"], y))
    improved = nd < state["dist"]

    # light: re-enter the within-bucket fixpoint with the improvements that
    # landed back in bucket b; once none do, switch to the heavy phase
    removed_l = state["removed"] | state["active"]
    active_l = improved & (torch.floor(nd / delta) == state["b"][None, :])
    phase_l = torch.where(active_l.any(dim=0), _LIGHT, _HEAVY).to(torch.int32)

    # heavy: commit the settled bucket, jump to the next non-empty one
    settled_h = state["settled"] | state["removed"]
    b_h, active_h, live_h = _begin_bucket_cols(nd, settled_h, delta)

    def sel(light_val, heavy_val, old):
        """Per-column light / heavy choice, frozen where the column is done."""
        m, d = (is_light, done) if old.ndim == 1 \
            else (is_light[None, :], done[None, :])
        return torch.where(d, old, torch.where(m, light_val, heavy_val))

    new = {
        "dist": nd,
        "settled": sel(state["settled"], settled_h, state["settled"]),
        "removed": sel(removed_l, torch.zeros_like(state["removed"]),
                       state["removed"]),
        "active": sel(active_l, active_h, state["active"]),
        "phase": sel(phase_l, torch.full_like(state["phase"], _LIGHT),
                     state["phase"]),
        "b": sel(state["b"], b_h, state["b"]),
        "buckets": sel(state["buckets"], state["buckets"] + 1,
                       state["buckets"]),
        "sweeps": torch.where(done, state["sweeps"], state["sweeps"] + 1),
    }
    new["done"] = done | (~is_light & ~live_h)
    return new, (~new["done"]).any()


def multi_sssp_spec(tiled, delta: float) -> eng.FixpointSpec:
    """Batched delta-stepping as a fixpoint spec over one weighted layout:
    every sweep takes the full ``tiled.wts`` (no per-column views), and the
    [B] phase machines stay on the device."""
    wts = tiled.wts
    delta_t = torch.tensor(delta, dtype=torch.float32, device=wts.device)

    def init_state(n, roots, device):
        roots = roots.to(device=device, dtype=torch.long)
        B = roots.shape[0]
        cols = torch.arange(B, device=device)
        dist = torch.full((n, B), float("inf"), device=device)
        dist[roots, cols] = 0.0
        settled = torch.zeros((n, B), dtype=torch.bool, device=device)
        b, active, live = _begin_bucket_cols(dist, settled, delta_t)
        zeros = torch.zeros(B, dtype=torch.int32, device=device)
        return {"dist": dist, "settled": settled,
                "removed": torch.zeros_like(settled), "active": active,
                "phase": torch.full_like(zeros, _LIGHT), "b": b,
                "buckets": zeros, "sweeps": zeros.clone(), "done": ~live}

    def host_bits(state, k, need_sb, need_nf):
        # push-only: the per-column source matrix [n, B]; the hostloop
        # unions it over the columns into one tile set
        return _sources(state).cpu().numpy(), None

    return eng.FixpointSpec(
        name="multi_sssp",
        sr_name="minplus",
        batched=True,
        init_state=init_state,
        frontier=lambda state, k: torch.where(_sources(state), state["dist"],
                                              float("inf")),
        source_bits=lambda state, k: _sources(state),
        update=lambda state, y, k: _update(delta_t, state, y),
        host_bits=host_bits,
        weights=lambda state: wts,
    )


# ----------------------------------------------------------------- public API


def multi_source_sssp(tiled, roots: Sequence[int], *,
                      delta: Optional[float] = None,
                      need_parents: bool = False, slimwork: bool = True,
                      batch_size: Optional[int] = None,
                      max_iters: Optional[int] = None,
                      log_work: bool = False,
                      config: Optional[EngineConfig] = None,
                      device=None) -> MultiSSSPResult:
    """Delta-stepping SSSP from every root in ``roots``; one min-plus SpMM
    loop per batch.

    delta: bucket width shared by every column (None -> mean edge weight;
    ``inf`` -> batched Bellman-Ford).
    config: the engine knobs; mode "fused" (state and phase machines on the
    device, one copy to the host per sweep) or "hostloop" (the union
    SlimWork tile mask in numpy). Delta-stepping is push-only, so the
    config's direction must be "push".
    batch_size: roots per batch (None -> all roots in one batch); the last
    partial batch is padded by repeating its last root, and the padded
    columns are dropped.
    max_iters: the sweep cap per batch, 4n + 16 by default.
    device: where to run; None means the card (raises when there is none).
    Returns per-root float32 distances (+inf unreachable), per-root sweep
    and bucket counts equal to the per-root ``sssp``'s and, when asked, the
    shortest-path-tree parents from the weighted DP sweep, one root at a
    time.
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
    roots = np.asarray(roots, np.int32).reshape(-1)
    if roots.size == 0:
        raise ValueError("multi_source_sssp needs at least one root")
    n = tiled.n
    if not ((0 <= roots) & (roots < n)).all():
        bad = roots[(roots < 0) | (roots >= n)][0]
        raise ValueError(f"root {bad} out of range for n={n}")
    max_iters = int(max_iters) if max_iters is not None else 4 * n + 16
    spec = multi_sssp_spec(tiled, delta)

    d_out = np.empty((roots.size, n), np.float32)
    p_out = np.empty((roots.size, n), np.int32) if need_parents else None
    sweeps = np.empty(roots.size, np.int32)
    buckets = np.empty(roots.size, np.int32)
    iters, work_rows = [], []
    for start, batch, batch_p in _iter_batches(roots, batch_size):
        with config.applied():
            if config.mode == "fused":
                res = eng.run_fused(spec, tiled, torch.from_numpy(batch_p),
                                    slimwork=slimwork, max_iters=max_iters,
                                    log_work=log_work)
            else:
                res = eng.run_hostloop(spec, tiled, torch.from_numpy(batch_p),
                                       slimwork=slimwork, max_iters=max_iters)
        state = res.state
        end = start + batch.size
        d_out[start:end] = _columns_to_host(state["dist"], batch.size)
        sweeps[start:end] = state["sweeps"][: batch.size].cpu().numpy()
        buckets[start:end] = state["buckets"][: batch.size].cpu().numpy()
        if need_parents:
            # one DP sweep per root: a [T, C, L, B] pass would not fit
            for b in range(batch.size):
                p_out[start + b] = sssp_parents(
                    tiled, state["dist"][:, b].contiguous(),
                    int(batch[b])).cpu().numpy()
        iters.append(res.iterations)
        if log_work:
            work_rows.append(res.work_log)
    wl = None
    if log_work:
        # fused rows are WORK_LOG long, hostloop rows one entry per sweep:
        # pad to the longest so the batches stack
        width = max(w.size for w in work_rows)
        wl = np.zeros((len(work_rows), width), np.int32)
        for i, w in enumerate(work_rows):
            wl[i, : w.size] = w
    return MultiSSSPResult(
        distances=d_out, parents=p_out, sweeps=sweeps, buckets=buckets,
        iterations=np.asarray(iters, np.int32), delta=delta, roots=roots,
        work_log=wl)
