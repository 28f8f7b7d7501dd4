"""The algebraic fixpoint engine (paper §III): one semiring sweep per step.

An algorithm is a small spec (``FixpointSpec``): initial state, how to read
the sweep operand, the push source bits and the not-final rows off the
state, and a state merge that also decides convergence. Two strategies
drive a spec to its fixpoint:

* ``run_fused`` keeps the state, masks and the direction choice on the
  device and reads from it once per iteration: the convergence flag, and
  under ``direction="auto"`` in the same copy the direction the next
  iteration takes (single-source specs; a batch keeps its per-column
  directions on the device and always sweeps the SpMM over one union mask).
  A spec whose update needs a decision on the host (delta-stepping's
  phase) makes that one copy itself and returns the flag as a Python bool,
  which the loop then reads without another copy.
* ``run_hostloop`` brings the spec's bits to the host each iteration
  (``host_bits``), builds the SlimWork tile mask and makes the direction
  choice in numpy, and hands the bool mask (T bytes) back to the ordinary
  sweep, whose kernels skip the masked tiles.

``step`` is one iteration of either. Loop semantics match the JAX
package's: iterate while ``cont and k <= max_iters`` from ``k = 1``;
``iterations = k - 1`` at exit; ``work_log[k-1]`` is the number of active
tiles of iteration ``k``; ``dirs_log[k-1]`` its direction (0 push, 1 pull).

Spec callables (B = batch width for ``batched`` specs):

  ================= ======================================================
  ``init_state``    (n, arg, device) -> state dict of [n] / [n, B] tensors
  ``frontier``      (state, k) -> sweep operand [n] / [n, B]
  ``source_bits``   (state, k) -> bool[n] / [n, B] push sources
  ``not_final``     (state) -> bool[n] / [n, B] rows that can still change
  ``update``        (state, y, k) -> (state, continue? as a bool tensor,
                    or a Python bool the update already brought over)
  ``host_bits``     (state, k, need_sb, need_nf) -> numpy (sb, nf), each
                    None unless asked for
  ``weights``       (state) -> the stored per-slot weights [T, C, L] the
                    next sweep multiplies in, or None for the implicit
                    edge value; read without a copy to the host, so a spec
                    that switches between views keeps its switch there
  ================= ======================================================

A spec with ``weights`` sweeps push only, single source: the stored-weight
sweep is ``slimsell_spmv(..., weights=)``. The hostloop hands the kernel
the whole weight array with the bool tile mask, as it does ``cols``: the
kernel skips the masked tiles, so no weight subset is gathered.

A spec over the "or" semiring (``boolean_packed``, SlimSell-B) sweeps
packed int32 words (``core.packing``): a single-source one a frontier
bitmap of ``ceil(n/32)`` words through ``slimsell_spmv_packed``, a batched
one word planes [n, ceil(B/32)] through ``slimsell_spmm``. Its
``source_bits`` are unpacked [n] / [n, B] bits as for any spec. Packed
sweeps are push-only: ``_sweep`` raises on a pull sweep of one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import direction as dm
from . import semiring as sm
from .options import DIRECTIONS, check_choice
from .spmv import (slimsell_pull, slimsell_pull_mm, slimsell_spmm,
                   slimsell_spmv, slimsell_spmv_packed)

WORK_LOG = 512  # max logged iterations


@dataclasses.dataclass(frozen=True, eq=False)
class FixpointSpec:
    """One algorithm as data."""
    name: str
    sr_name: str
    init_state: Callable[..., dict]
    frontier: Callable[..., torch.Tensor]
    update: Callable[..., tuple]
    source_bits: Callable[..., torch.Tensor]
    not_final: Optional[Callable[..., torch.Tensor]] = None
    host_bits: Optional[Callable[..., tuple]] = None
    weights: Optional[Callable[..., Optional[torch.Tensor]]] = None
    batched: bool = False


@dataclasses.dataclass
class EngineResult:
    """What the engine returns, before algorithm-specific post-processing."""
    state: dict
    iterations: int
    work_log: Optional[np.ndarray] = None       # active tiles per iteration
    dirs_log: Optional[np.ndarray] = None       # 0=push 1=pull per iteration
    pull_cols_log: Optional[np.ndarray] = None  # batched: pull columns/iter


# ------------------------------------------------------------------- helpers


def _chunk_active_from(nf: torch.Tensor, row_vertex: torch.Tensor) -> torch.Tensor:
    """bool[n_chunks] from not-final bits bool[n] (SlimWork §III-C; the pull
    direction's tile criterion). Padding rows are never active."""
    per_row = nf.index_select(0, row_vertex.clamp_min(0).reshape(-1))
    per_row = per_row.reshape(row_vertex.shape) & (row_vertex >= 0)
    return per_row.any(dim=1)


def _pull_tile_mask(tiled, nf_rows: torch.Tensor) -> torch.Tensor:
    """bool[T]: the tiles of the chunks holding a not-final row."""
    return _chunk_active_from(nf_rows, tiled.row_vertex).index_select(
        0, tiled.row_block)


def _sweep(spec: FixpointSpec, tiled, x: torch.Tensor,
           tile_mask: Optional[torch.Tensor],
           rows: Optional[torch.Tensor] = None,
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep: push without ``rows``, pull over the not-final ``rows``
    with them; the matrix form for batched specs, the packed sweeps under
    the "or" semiring (``slimsell_spmm`` routes the batched one), the
    stored-weight SpMV with ``weights``."""
    sr = sm.get(spec.sr_name)
    if weights is not None:
        if rows is not None or spec.batched:
            raise ValueError(f"{spec.name}: stored-weight sweeps are "
                             "single-source push")
        return slimsell_spmv(sr, tiled, x, weights=weights,
                             tile_mask=tile_mask)
    if sr.reduction == "or":
        if rows is not None:
            raise ValueError(f"{spec.name}: packed sweeps are push-only")
        if not spec.batched:
            return slimsell_spmv_packed(tiled, x, tile_mask=tile_mask)
    if rows is not None:
        if spec.batched:
            return slimsell_pull_mm(sr, tiled, x, row_mask=rows,
                                    tile_mask=tile_mask)
        return slimsell_pull(sr, tiled, x, row_mask=rows, tile_mask=tile_mask)
    if spec.batched:
        return slimsell_spmm(sr, tiled, x, tile_mask=tile_mask)
    return slimsell_spmv(sr, tiled, x, tile_mask=tile_mask)


def step(spec: FixpointSpec, tiled, state: dict, k: int, *,
         slimwork: bool = True, pull: bool = False,
         sb: Optional[torch.Tensor] = None,
         nf: Optional[torch.Tensor] = None):
    """Iteration ``k`` from ``state``: tile mask, sweep, update.

    Push masks the tiles holding a source column, pull the chunks holding
    a not-final row (a batch's union over its columns). ``sb`` / ``nf`` are
    the source and not-final bits when the caller has them already.
    Returns ``(state, cont, used)``: the new state, the device bool
    "something changed", and the number of tiles swept (a device int32
    under SlimWork, else all tiles).
    """
    mask = None
    used = tiled.n_tiles
    if pull:
        nf = spec.not_final(state) if nf is None else nf
        if slimwork:
            mask = _pull_tile_mask(tiled, nf.any(dim=-1) if nf.ndim > 1 else nf)
    elif slimwork:
        sb = spec.source_bits(state, k) if sb is None else sb
        mask = dm.push_tile_mask(tiled, sb)
    if mask is not None:
        used = mask.sum(dtype=torch.int32)
    y = _sweep(spec, tiled, spec.frontier(state, k), mask, nf if pull else None,
               _weights(spec, state))
    state, cont = spec.update(state, y, k)
    return state, cont, used


def _weights(spec: FixpointSpec, state: dict) -> Optional[torch.Tensor]:
    return spec.weights(state) if spec.weights is not None else None


def _auto_choice(spec: FixpointSpec, tiled, state: dict, k: int,
                 current: torch.Tensor):
    """The bits of iteration ``k`` and its direction(s) under "auto",
    chosen on the device from the current one(s)."""
    sb = spec.source_bits(state, k)
    nf = spec.not_final(state)
    mf, mu, nnz_f = dm.edge_counts(tiled.deg, sb, nf)
    return sb, nf, dm.choose_direction(current, mf, mu, nnz_f, tiled.n)


def _check_direction(spec: FixpointSpec, direction: str) -> None:
    check_choice("direction", direction, DIRECTIONS)
    if spec.weights is not None and direction != "push":
        raise ValueError(f"{spec.name}: stored-weight sweeps are push-only, "
                         f"got direction={direction!r}")


# -------------------------------------------------------------------- fused


def run_fused(spec: FixpointSpec, tiled, arg, *, slimwork: bool = True,
              max_iters: int, log_work: bool = False,
              direction: str = "push") -> EngineResult:
    """Run a spec to its fixpoint from ``spec.init_state(n, arg)``.

    Logs follow the JAX package: single-source results keep the first
    ``iterations`` entries of ``work_log`` and ``dirs_log`` (``dirs_log``
    is also filled without ``log_work`` unless the direction is "auto");
    batched ones keep the fixed ``WORK_LOG`` length of ``work_log`` and
    ``pull_cols_log`` (the caller stacks them across batches). Work entries
    are 0 without SlimWork.
    """
    _check_direction(spec, direction)
    device = tiled.cols.device
    state = spec.init_state(tiled.n, arg, device)
    work = torch.zeros(WORK_LOG if log_work else 1, dtype=torch.int32,
                       device=device)
    if spec.batched:
        return _run_fused_batched(spec, tiled, state, work, slimwork=slimwork,
                                  max_iters=max_iters, log_work=log_work,
                                  direction=direction)
    dirs = np.full(WORK_LOG if log_work else 1, -1, np.int32)
    d = dm.PULL if direction == "pull" else dm.PUSH
    sb = nf = None
    if direction == "auto":
        sb, nf, d_t = _auto_choice(spec, tiled, state, 1,
                                   torch.tensor(dm.PUSH, dtype=torch.int32,
                                                device=device))
        d = int(d_t)  # the first iteration's direction, before the loop
    k, cont = 1, True
    while cont and k <= max_iters:
        state, cont_t, used = step(spec, tiled, state, k, slimwork=slimwork,
                                   pull=d == dm.PULL, sb=sb, nf=nf)
        if log_work:
            if slimwork:
                work[min(k - 1, WORK_LOG - 1)] = used
            dirs[min(k - 1, WORK_LOG - 1)] = d
        if direction == "auto":
            # the next iteration's bits and direction, worked out now so
            # that one copy brings the flag and the direction to the host
            sb, nf, d_t = _auto_choice(spec, tiled, state, k + 1, d_t)
            cont, d = torch.stack([cont_t.to(torch.int32), d_t]).tolist()
        else:
            # the one device sync per iteration (none if the update made it)
            cont = bool(cont_t)
        k += 1
    iters = k - 1
    wl = dl = None
    if log_work:
        wl = work.cpu().numpy()[:iters]
        dl = dirs[:iters]
    elif direction != "auto":
        dl = np.full(iters, d, np.int32)
    return EngineResult(state=state, iterations=iters, work_log=wl,
                        dirs_log=dl)


def _run_fused_batched(spec: FixpointSpec, tiled, state: dict,
                       work: torch.Tensor, *, slimwork: bool, max_iters: int,
                       log_work: bool, direction: str) -> EngineResult:
    """The batched loop: push and pull sweep the whole batch one way;
    "auto" keeps a direction per column on the device and sweeps the SpMM
    over the union of the push mask of its push columns and the pull mask
    of its pull columns, as the JAX package does."""
    device = tiled.cols.device
    B = state["d"].shape[1]  # a packed frontier is ceil(B/32) words wide
    dcur = torch.full((B,), dm.PULL if direction == "pull" else dm.PUSH,
                      dtype=torch.int32, device=device)
    plog = torch.zeros_like(work)
    k, cont = 1, True
    while cont and k <= max_iters:
        if direction == "auto":
            sb, nf, dcur = _auto_choice(spec, tiled, state, k, dcur)
            mask = None
            used = tiled.n_tiles
            if slimwork:
                push_rows = (sb & (dcur == dm.PUSH)).any(dim=1)
                pull_rows = (nf & (dcur == dm.PULL)).any(dim=1)
                mask = dm.push_tile_mask(tiled, push_rows) \
                    | _pull_tile_mask(tiled, pull_rows)
                used = mask.sum(dtype=torch.int32)
            y = _sweep(spec, tiled, spec.frontier(state, k), mask)
            state, cont_t = spec.update(state, y, k)
        else:
            state, cont_t, used = step(spec, tiled, state, k,
                                       slimwork=slimwork,
                                       pull=direction == "pull")
        if log_work:
            idx = min(k - 1, WORK_LOG - 1)
            if slimwork:
                work[idx] = used
            plog[idx] = (dcur == dm.PULL).sum(dtype=torch.int32)
        cont = bool(cont_t)  # the one device sync per iteration
        k += 1
    wl = plog_out = None
    if log_work:
        wl, plog_out = work.cpu().numpy(), plog.cpu().numpy()
    return EngineResult(state=state, iterations=k - 1, work_log=wl,
                        pull_cols_log=plog_out)


# ----------------------------------------------------------------- hostloop


def _push_tile_mask_host(active: np.ndarray, inc_ptr: np.ndarray,
                         inc_tile: np.ndarray, n_tiles: int) -> np.ndarray:
    """Host twin of ``direction.push_tile_mask``: bool[T] of the tiles
    holding ≥1 active column. Walks only the active columns' ranges of the
    vertex-sorted push index (``inc_ptr`` is its offset vector), so the
    cost is the frontier's incidence, not the whole index."""
    tmask = np.zeros(n_tiles, bool)
    verts = np.nonzero(active)[0]
    starts = inc_ptr[verts]
    counts = inc_ptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return tmask
    # ragged range gather: concatenate [starts_i, starts_i + counts_i)
    ofs = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])),
                    counts)
    tmask[inc_tile[ofs + np.arange(total)]] = True
    return tmask


def run_hostloop(spec: FixpointSpec, tiled, arg, *, slimwork: bool = True,
                 max_iters: int, direction: str = "push") -> EngineResult:
    """Run a spec with the loop's decisions on the host: each iteration
    brings the spec's bits over (``host_bits``), builds the tile mask and
    chooses the direction in numpy (float64 degree sums, as the JAX
    package's hostloop), and sweeps with the mask. An empty tile set skips
    the sweep for an all-zero result, and still counts as an iteration of
    0 tiles, as in the fused loop. Logs one ``work_log`` and ``dirs_log``
    entry per iteration (tiles are all tiles without SlimWork).

    Batched specs run push only (their tile set is the union over the
    columns); per-column pull and auto need the fused strategy.
    """
    _check_direction(spec, direction)
    if spec.batched and direction != "push":
        raise NotImplementedError(
            f"{spec.name}: batched hostloop is push-only "
            "(per-column pull/auto state needs the fused strategy)")
    device = tiled.cols.device
    n, n_tiles = tiled.n, tiled.n_tiles
    sr = sm.get(spec.sr_name)
    state = spec.init_state(n, arg, device)
    dcur = dm.PULL if direction == "pull" else dm.PUSH
    use_push = direction in ("push", "auto")
    # host copies of the layout metadata the per-iteration masks need
    rv = tiled.row_vertex.cpu().numpy()
    rv_safe = np.where(rv < 0, 0, rv)
    rb = tiled.row_block.cpu().numpy()
    deg = tiled.deg.cpu().numpy().astype(np.float64) \
        if direction == "auto" else None
    if use_push and slimwork:
        inc_tile = tiled.inc_tile.cpu().numpy()
        inc_ptr = tiled.inc_ptr.cpu().numpy() if tiled.inc_ptr is not None \
            else np.searchsorted(tiled.inc_src.cpu().numpy(), np.arange(n + 1))
    k, iters = 1, 0
    work_list, dir_list = [], []
    while k <= max_iters:
        sb, nf = spec.host_bits(state, k, use_push, direction != "push")
        if sb is not None and sb.ndim > 1:
            sb = sb.any(axis=1)  # a batch shares one tile set
        if direction == "auto":
            dcur = dm.choose_direction_host(
                dcur, float(deg[sb].sum()), float(deg[nf].sum()),
                float(sb.sum()), n)
        pull = dcur == dm.PULL
        mask, used = None, n_tiles
        if slimwork:
            if pull:
                tmask = (nf[rv_safe] & (rv >= 0)).any(axis=1)[rb]
            else:
                tmask = _push_tile_mask_host(sb, inc_ptr, inc_tile, n_tiles)
            used = int(np.count_nonzero(tmask))
            if used:
                mask = torch.from_numpy(tmask).to(device)
        work_list.append(used)
        dir_list.append(dcur)
        x = spec.frontier(state, k)
        if used == 0:
            # what an empty tile set gives: zero words for a packed spec
            y = torch.full_like(x, sr.zero)
        else:
            y = _sweep(spec, tiled, x, mask,
                       spec.not_final(state) if pull else None,
                       _weights(spec, state))
        state, cont = spec.update(state, y, k)
        iters = k
        k += 1
        if not bool(cont):
            break
    return EngineResult(state=state, iterations=iters,
                        work_log=np.asarray(work_list, np.int32),
                        dirs_log=np.asarray(dir_list, np.int32))
