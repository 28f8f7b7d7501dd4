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

``fixpoint_handle`` caches a ``FixpointHandle`` per bucket signature for
the serving layer: it builds a state apart from running it, and runs it
through the same fused loop as ``run_fused``.

``dist_step`` is one iteration of a spec on one rank of the distributed
strategy (``core.dist_bfs``): a sweep over the rank's ``ShardTiled`` and
the semiring all-reduce of its partial result over the grid.

Under the sanitizer (``core.debug``) each run checks its layout once
before its first sweep (a shard of the distributed strategy against its
``n_x``), and ``_sweep`` checks every sweep's result: the fused loop ORs
each sweep's flag into a sticky flag on the device that it reads in the
same copy as its continue flag (or once after its last sweep, when the
update made that copy itself), the hostloop and the distributed step read
it as each sweep ends.

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
  ``n_bits``        a packed spec's live bits on its sweep's word axis (n
                    for a bitmap, B for a batch's word planes), which the
                    sanitizer's tail-word check reads
  ================= ======================================================

A spec with ``weights`` sweeps push only: the stored-weight sweep is
``slimsell_spmv(..., weights=)``, or ``slimsell_spmm(..., weights=)`` for
a batched spec (one weight operand for every column). The hostloop hands
the kernel the whole weight array with the bool tile mask, as it does
``cols``: the kernel skips the masked tiles, so no weight subset is
gathered.

A spec over the "or" semiring (``boolean_packed``, SlimSell-B) sweeps
packed int32 words (``core.packing``): a single-source one a frontier
bitmap of ``ceil(n/32)`` words through ``slimsell_spmv_packed``, a batched
one word planes [n, ceil(B/32)] through ``slimsell_spmm``. Its
``source_bits`` are unpacked [n] / [n, B] bits as for any spec. Packed
sweeps are push-only: ``_sweep`` raises on a pull sweep of one.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Optional

import numpy as np
import torch

from . import debug
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
    n_bits: Optional[int] = None


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
           weights: Optional[torch.Tensor] = None,
           sticky: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep: push without ``rows``, pull over the not-final ``rows``
    with them; the matrix form for batched specs, the packed sweeps under
    the "or" semiring (``slimsell_spmm`` routes the batched one), the
    stored-weight SpMV or SpMM with ``weights``.

    Under the sanitizer the result is checked (``debug.sweep_flag``): the
    flag is ORed into ``sticky``, the fused loop's device flag, or read
    and raised at once without one."""
    sr = sm.get(spec.sr_name)
    y = _sweep_once(spec, sr, tiled, x, tile_mask, rows, weights)
    flag = debug.sweep_flag(sr, y, spec.n_bits)
    if flag is not None:
        if sticky is None:
            debug.raise_sweep(sr, flag.item(), spec.n_bits)
        else:
            sticky.bitwise_or_(flag)
    return y


def _sweep_once(spec: FixpointSpec, sr, tiled, x: torch.Tensor,
                tile_mask: Optional[torch.Tensor],
                rows: Optional[torch.Tensor],
                weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is not None:
        if rows is not None:
            raise ValueError(f"{spec.name}: stored-weight sweeps are "
                             "push-only")
        sweep = slimsell_spmm if spec.batched else slimsell_spmv
        return sweep(sr, tiled, x, weights=weights, tile_mask=tile_mask)
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
         nf: Optional[torch.Tensor] = None,
         sticky: Optional[torch.Tensor] = None):
    """Iteration ``k`` from ``state``: tile mask, sweep, update.

    Push masks the tiles holding a source column, pull the chunks holding
    a not-final row (a batch's union over its columns). ``sb`` / ``nf`` are
    the source and not-final bits when the caller has them already;
    ``sticky`` the fused loop's sanitizer flag (``_sweep``).
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
               _weights(spec, state), sticky)
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
    debug.check_layout(tiled)
    state = spec.init_state(tiled.n, arg, tiled.cols.device)
    # a batched spec's arg is its roots, one per column
    return _fused_loop(spec, tiled, state, len(arg) if spec.batched else None,
                       slimwork=slimwork, max_iters=max_iters,
                       log_work=log_work, direction=direction)


def _fused_loop(spec: FixpointSpec, tiled, state: dict, B: Optional[int], *,
                slimwork: bool, max_iters: int, log_work: bool,
                direction: str) -> EngineResult:
    """Drive ``state`` to the spec's fixpoint: the fused loop that
    ``run_fused`` and ``FixpointHandle.run`` share (a batched spec's ``B``
    is its width)."""
    device = tiled.cols.device
    work = torch.zeros(WORK_LOG if log_work else 1, dtype=torch.int32,
                       device=device)
    if spec.batched:
        return _run_fused_batched(spec, tiled, state, work, B,
                                  slimwork=slimwork, max_iters=max_iters,
                                  log_work=log_work, direction=direction)
    dirs = np.full(WORK_LOG if log_work else 1, -1, np.int32)
    d = dm.PULL if direction == "pull" else dm.PUSH
    sb = nf = None
    sticky = _sticky_flag(device)
    deferred = False
    if direction == "auto":
        sb, nf, d_t = _auto_choice(spec, tiled, state, 1,
                                   torch.tensor(dm.PUSH, dtype=torch.int32,
                                                device=device))
        d = int(d_t)  # the first iteration's direction, before the loop
    k, cont = 1, True
    while cont and k <= max_iters:
        state, cont_t, used = step(spec, tiled, state, k, slimwork=slimwork,
                                   pull=d == dm.PULL, sb=sb, nf=nf,
                                   sticky=sticky)
        if log_work:
            if slimwork:
                work[min(k - 1, WORK_LOG - 1)] = used
            dirs[min(k - 1, WORK_LOG - 1)] = d
        if direction == "auto":
            # the next iteration's bits and direction, worked out now so
            # that one copy brings the flags and the direction to the host
            sb, nf, d_t = _auto_choice(spec, tiled, state, k + 1, d_t)
            vals = torch.stack([cont_t.to(torch.int32), d_t]
                               + ([] if sticky is None else [sticky])).tolist()
            cont, d = vals[:2]
            if sticky is not None:
                _raise_flag(spec, vals[2])
        else:
            # the one device sync per iteration (none if the update made it)
            cont, waits = _read_cont(spec, cont_t, sticky)
            deferred |= waits
        k += 1
    if deferred:
        _raise_flag(spec, sticky.item())
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
                       work: torch.Tensor, B: int, *, slimwork: bool,
                       max_iters: int, log_work: bool,
                       direction: str) -> EngineResult:
    """The batched loop over ``B`` columns: push and pull sweep the whole
    batch one way; "auto" keeps a direction per column on the device and
    sweeps the SpMM over the union of the push mask of its push columns and
    the pull mask of its pull columns, as the JAX package does."""
    device = tiled.cols.device
    dcur = torch.full((B,), dm.PULL if direction == "pull" else dm.PUSH,
                      dtype=torch.int32, device=device)
    plog = torch.zeros_like(work)
    sticky = _sticky_flag(device)
    deferred = False
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
            y = _sweep(spec, tiled, spec.frontier(state, k), mask,
                       sticky=sticky)
            state, cont_t = spec.update(state, y, k)
        else:
            state, cont_t, used = step(spec, tiled, state, k,
                                       slimwork=slimwork,
                                       pull=direction == "pull",
                                       sticky=sticky)
        if log_work:
            idx = min(k - 1, WORK_LOG - 1)
            if slimwork:
                work[idx] = used
            plog[idx] = (dcur == dm.PULL).sum(dtype=torch.int32)
        cont, waits = _read_cont(spec, cont_t, sticky)  # the one device sync
        deferred |= waits
        k += 1
    if deferred:
        _raise_flag(spec, sticky.item())
    wl = plog_out = None
    if log_work:
        wl, plog_out = work.cpu().numpy(), plog.cpu().numpy()
    return EngineResult(state=state, iterations=k - 1, work_log=wl,
                        pull_cols_log=plog_out)


def _sticky_flag(device) -> Optional[torch.Tensor]:
    """The fused loop's sanitizer flag: an int32 0 on the device that every
    sweep's check ORs into, or None with the sanitizer off."""
    if not debug.enabled():
        return None
    return torch.zeros((), dtype=torch.int32, device=device)


def _raise_flag(spec: FixpointSpec, flag: int) -> None:
    """Raise for the sanitizer's sticky flag as read on the host."""
    if flag:
        debug.raise_sweep(sm.get(spec.sr_name), flag, spec.n_bits)


def _read_cont(spec: FixpointSpec, cont_t, sticky):
    """The loop's read of an iteration: the continue flag, and in the same
    copy the sanitizer's sticky flag (raised on). Returns ``(cont,
    waits)``: an update that returned a Python bool made its copy itself,
    so the sticky flag waits for one read after the loop (``waits``)."""
    if not isinstance(cont_t, torch.Tensor):
        return bool(cont_t), sticky is not None
    if sticky is None:
        return bool(cont_t), False
    cont, flag = torch.stack([cont_t.to(torch.int32), sticky]).tolist()
    _raise_flag(spec, flag)
    return bool(cont), False


# ---------------------------------------------------------- fixpoint handles


@dataclasses.dataclass(eq=False)
class FixpointHandle:
    """A persistent, re-entrant fused fixpoint runner for one bucket
    signature (spec, slimwork, max_iters, direction, batch width): the
    serving layer's unit of reuse.

    ``spec`` is a ``FixpointSpec``, or a factory ``(tiled, *ctx_args) ->
    FixpointSpec`` for a spec that closes over per-run constants (the SSSP
    bucket width, PageRank's damping and tol): ``setup`` binds them, so one
    handle serves every bucket of its signature, each run with its own
    constants. The bound spec is the run's ``ctx``, which ``init_state``
    and ``run`` take.

    ``run`` drives a state through the same loop as ``run_fused``, without
    the work log, and returns once the sweeps are done (the loop reads its
    continue flag on the host each iteration): ``(state, iterations)``,
    the state still on the layout's device.
    """
    spec: object
    slimwork: bool
    max_iters: int
    direction: str
    batch_width: Optional[int]

    def setup(self, tiled, ctx_args=()) -> FixpointSpec:
        """The spec bound to one run's constants."""
        if isinstance(self.spec, FixpointSpec):
            if tuple(ctx_args):
                raise ValueError(f"{self.spec.name}: the spec takes no "
                                 "per-run constants")
            spec = self.spec
        else:
            spec = self.spec(tiled, *tuple(ctx_args))
        if spec.batched != (self.batch_width is not None):
            raise ValueError(f"{spec.name}: batched specs need batch_width, "
                             "single-source specs none")
        _check_direction(spec, self.direction)
        return spec

    def init_state(self, tiled, arg, ctx: FixpointSpec) -> dict:
        """Fresh state for one run, on the layout's device."""
        return ctx.init_state(tiled.n, arg, tiled.cols.device)

    def run(self, tiled, ctx: FixpointSpec, state: dict):
        """Drive ``state`` to the fixpoint: ``(state, iterations)``; under
        the sanitizer the layout is checked first, once a run."""
        debug.check_layout(tiled)
        res = _fused_loop(ctx, tiled, state, self.batch_width,
                          slimwork=self.slimwork, max_iters=self.max_iters,
                          log_work=False, direction=self.direction)
        return res.state, res.iterations


# fixpoint_handle's concurrent-first-call guard: lru_cache does not
# deduplicate concurrent misses, so two serving threads asking for the
# same new signature would both build a handle. One lock per signature
# serializes construction exactly once per key.
_HANDLE_ONCE_GUARD = threading.Lock()
_HANDLE_BUILD_LOCKS: dict = {}


@functools.lru_cache(maxsize=None)
def _fixpoint_handle_cached(spec, slimwork: bool, max_iters: int,
                            direction: str,
                            batch_width: Optional[int]) -> FixpointHandle:
    return FixpointHandle(spec=spec, slimwork=slimwork, max_iters=max_iters,
                          direction=direction, batch_width=batch_width)


def fixpoint_handle(spec, *, slimwork: bool = True, max_iters: int,
                    direction: str = "push",
                    batch_width: Optional[int] = None) -> FixpointHandle:
    """Get (or build) the process-wide ``FixpointHandle`` for a bucket
    signature; ``spec`` is a ``FixpointSpec`` or a factory of one (see
    ``FixpointHandle``), keyed by identity. ``batch_width`` is required
    for batched specs.

    Thread-safe: a per-signature once-guard serializes the first call for
    each new signature, so concurrent threads missing on the same key get
    one handle, never two.
    """
    check_choice("direction", direction, DIRECTIONS)
    if isinstance(spec, FixpointSpec) and spec.batched and batch_width is None:
        raise ValueError(f"{spec.name}: batched specs need batch_width")
    key = (spec, bool(slimwork), int(max_iters), direction,
           None if batch_width is None else int(batch_width))
    with _HANDLE_ONCE_GUARD:
        build_lock = _HANDLE_BUILD_LOCKS.setdefault(key, threading.Lock())
    with build_lock:
        return _fixpoint_handle_cached(*key)


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
    debug.check_layout(tiled)
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


# --------------------------------------------------------------- distributed


@dataclasses.dataclass
class ShardTiled:
    """One rank's block of the 2D partition (``dist_bfs.partition_slimsell``)
    as a layout the sweeps and kernels take: the tiles of row shard ``row``
    (chunks ``row * n_chunks`` on) and column shard ``col`` (vertices
    ``col * n_x`` on).

    ``cols`` hold *localized* column ids (``[0, n_x)``, -1 padding), so a
    sweep's operand is the frontier's column range, ``n_x`` rows;
    ``row_vertex`` holds *global* vertex ids, so the result lands in vertex
    space, ``n`` rows, of which only the shard's rows are written
    (``owns_all_rows`` is False: the kernels' wrappers start the others at
    the semiring zero). ``n_tiles`` is the partition's ``t_max``: the
    tiles past the shard's own are padding (all -1) that keep the last
    chunk's id, so ``tile_ptr`` counts them into that chunk, and ``cl``,
    each chunk's length in this column range, keeps the kernels' work
    lists below them. ``deg`` is the whole graph's degree vector (the
    direction heuristic and PageRank read it), ``inc_src`` / ``inc_tile``
    the shard's push index padded with tile id ``n_tiles``. Arrays are
    host numpy until ``to_torch``.
    """
    n: int
    n_x: int
    C: int
    L: int
    n_chunks: int
    row: int
    col: int
    cols: object        # int32[n_tiles, C, L], localized
    row_block: object   # int32[n_tiles]
    row_vertex: object  # int32[n_chunks, C], global ids
    tile_ptr: object    # int32[n_chunks + 1]
    cl: object          # int32[n_chunks]
    deg: object         # int[n]
    inc_src: object = None
    inc_tile: object = None
    wts: object = None  # float32[n_tiles, C, L]
    device: Optional[torch.device] = None
    spmm_work: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                   compare=False)
    spmv_work: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                   compare=False)
    owns_all_rows = False

    @property
    def n_tiles(self) -> int:
        return int(self.cols.shape[0])

    def to_torch(self, device=None) -> "ShardTiled":
        """The host shard as tensors on ``device`` (default: the card;
        raises when there is none), with the layout's dtypes."""
        from .formats import layout_to_torch
        return layout_to_torch(self, device)


def _column_range(x: torch.Tensor, lo: int, rows: int, fill) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of ``x``, those past its end ``fill``."""
    part = x[lo:lo + rows]
    if part.shape[0] < rows:
        pad = x.new_full((rows - part.shape[0],) + tuple(x.shape[1:]), fill)
        part = torch.cat([part, pad])
    return part.contiguous()


def dist_step(spec: FixpointSpec, local: ShardTiled, state: dict, k: int, *,
              pull: bool, grid, row_axes, col_axes, comm: str,
              slimwork: bool):
    """One fixpoint iteration on one rank of the 2D partition.

    The sweep runs over the rank's tiles on the frontier's column range
    (padded with the semiring zero past n); its result is in vertex space
    with the semiring zero outside the shard's rows, and the semiring
    all-reduce over the grid combines the ranks' partial results: each
    edge lies in exactly one block, so the combine is exact for every
    semiring. The state is replicated, and every rank runs the spec's own
    update on the combined result.

    push: the SlimWork mask holds the tiles with a source in the shard's
    column range (the shard's own push index). pull: the sweep runs over
    the not-final rows, the mask holds the chunks with one; other shards'
    rows contribute the zero, so the all-reduce doubles as the row
    gather. ``comm`` "allreduce" reduces over every axis at once,
    "reduce_gather" over the column axes first, then the row axes.
    """
    sr = sm.get(spec.sr_name)
    lo = local.col * local.n_x
    x = _column_range(spec.frontier(state, k), lo, local.n_x, sr.zero)
    mask = nf = None
    if pull:
        nf = spec.not_final(state)
        if slimwork:
            mask = _pull_tile_mask(local, nf.any(dim=-1) if nf.ndim > 1 else nf)
    elif slimwork:
        sb = _column_range(spec.source_bits(state, k), lo, local.n_x, False)
        mask = dm.push_tile_mask(local, sb)
    y = _sweep(spec, local, x, mask, nf, _weights(spec, state))
    if comm == "allreduce":
        y = grid.pall(sr.reduction, y, tuple(col_axes) + tuple(row_axes))
    else:
        y = grid.pall(sr.reduction, y, tuple(col_axes))
        y = grid.pall(sr.reduction, y, tuple(row_axes))
    return spec.update(state, y, k)


def dist_choose_direction(spec: FixpointSpec, deg: torch.Tensor, state: dict,
                          k: int, current: torch.Tensor,
                          n: int) -> torch.Tensor:
    """The replicated Beamer choice of the distributed strategy, from the
    whole graph's degrees. A batch takes one direction for all its columns
    (the mean of their statistics), as the JAX package's distributed
    strategy does: one sweep advances every column."""
    sb = spec.source_bits(state, k)
    nf = spec.not_final(state)
    mf, mu, nnz_f = dm.edge_counts(deg, sb, nf)
    if spec.batched:
        mf, mu, nnz_f = mf.mean(), mu.mean(), nnz_f.mean()
    return dm.choose_direction(current, mf, mu, nnz_f, n)
