"""Batched multi-source algebraic BFS: many roots as one semiring SpMM.

Graph500 runs BFS from 64 sampled roots over the same graph. Batching B
roots turns the frontier vector [n] into a frontier matrix [n, B] and
every iteration into a semiring SpMM: one read of the adjacency structure
advances B traversals. The per-column math is single-source BFS's
(``bfs.semiring_update`` verbatim).

SlimWork generalizes column-wise: a tile is swept if ANY root's frontier
touches it, so the batch shares one tile mask (the union of the per-root
masks). Iterations run to the deepest root of the batch; converged
columns simply stop changing, which is exact for every semiring.

Direction optimization is per column: under ``direction="auto"`` each
root carries its own push/pull state (Beamer's switch on its own frontier
statistics) and the per-column directions compose into one union tile
mask for the SpMM. ``direction="pull"`` runs the batched bottom-up sweep
(``slimsell_pull_mm``), whose early exit is per (row, column).

SlimSell-B (``packed=True``) packs the B root columns into ``ceil(B/32)``
word planes (``packed_multi_bfs_spec``), and one word-wise SpMM advances
32 traversals per word.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import direction as dm
from . import engine as eng
from . import packing
from . import semiring as sm
from .bfs import (_check_packed, _frontier_payload, _ids1, _not_final,
                  check_bfs_options, dp_transform, host_direction_bits,
                  on_device, semiring_update)
from .options import EngineConfig


@dataclasses.dataclass
class MultiBFSResult:
    """What ``multi_source_bfs`` returns: one row per root, vertex space.

    ``distances[i]`` equals ``bfs(tiled, roots[i]).distances``: batching
    changes the schedule, never the answer.
    """
    distances: np.ndarray          # int32[n_roots, n]; -1 unreachable
    parents: Optional[np.ndarray]  # int32[n_roots, n]; root -> root
    iterations: np.ndarray         # int32[n_batches] loop trips per batch
    roots: np.ndarray              # int32[n_roots]
    work_log: Optional[np.ndarray] = None  # int32[n_batches, WORK_LOG]
    # int32[n_batches, WORK_LOG]: columns running pull per iteration
    pull_cols_log: Optional[np.ndarray] = None


def _init_state_multi(sr_name: str, n: int, roots: torch.Tensor, device) -> dict:
    """Batched ``bfs._init_state``: every field gains a trailing B axis."""
    roots = roots.to(device=device, dtype=torch.long)
    cols = torch.arange(roots.shape[0], device=device)
    B = roots.shape[0]
    d = torch.full((n, B), -1, dtype=torch.int32, device=device)
    d[roots, cols] = 0
    if sr_name == "tropical":
        f = torch.full((n, B), float("inf"), device=device)
        f[roots, cols] = 0.0
        return {"d": d, "f": f}
    if sr_name in ("real", "boolean"):
        f = torch.zeros((n, B), dtype=sm.get(sr_name).dtype, device=device)
        f[roots, cols] = 1
        v = torch.zeros((n, B), dtype=torch.bool, device=device)
        v[roots, cols] = True
        return {"d": d, "f": f, "visited": v}
    if sr_name == "selmax":
        x = torch.zeros((n, B), device=device)
        x[roots, cols] = roots.to(torch.float32) + 1.0
        return {"d": d, "x": x, "p": x.clone()}
    raise ValueError(sr_name)


def _columns_to_host(m: torch.Tensor, k: int) -> np.ndarray:
    """The first ``k`` columns of an [n, B] state matrix as a host [k, n]
    array. The transpose runs on the device: a transposed host view would
    leave numpy a strided copy of n * k elements."""
    return m[:, :k].T.contiguous().cpu().numpy()


def _iter_batches(roots: np.ndarray, batch_size: Optional[int]):
    """Yield ``(start, batch, padded)`` slices of the roots. The width
    defaults to all roots in one batch; the final partial batch is padded
    by repeating its last root, and callers drop the padded columns."""
    B = int(batch_size) if batch_size is not None else roots.size
    if B <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    for start in range(0, roots.size, B):
        batch = roots[start:start + B]
        pad = B - batch.size
        batch_p = np.concatenate([batch, np.repeat(batch[-1:], pad)]) \
            if pad else batch
        yield start, batch, batch_p


@functools.lru_cache(maxsize=None)
def multi_bfs_spec(sr_name: str) -> eng.FixpointSpec:
    """Multi-source BFS as a batched fixpoint spec: the single-source state
    algebra with a trailing B axis."""
    return eng.FixpointSpec(
        name=f"multi_bfs/{sr_name}",
        sr_name=sr_name,
        batched=True,
        init_state=lambda n, roots, device: _init_state_multi(
            sr_name, n, roots, device),
        frontier=lambda state, k: _frontier_payload(sr_name, state),
        source_bits=lambda state, k: dm.frontier_bits(sr_name, state, k),
        not_final=lambda state: _not_final(sr_name, state),
        update=lambda state, y, k: semiring_update(sr_name, state, y, k,
                                                   _ids1(y)),
        host_bits=lambda state, k, need_sb, need_nf: host_direction_bits(
            sr_name, state, k, need_sb, need_nf),
    )


@functools.lru_cache(maxsize=None)
def packed_multi_bfs_spec(B: int) -> eng.FixpointSpec:
    """SlimSell-B multi-source BFS: ``B`` roots become ``ceil(B/32)``
    packed word planes; frontier and visited are int32[n, ceil(B/32)]
    (roots packed along axis 1) and one word-wise SpMM advances 32
    traversals per word.

    The per-column recurrence of ``multi_bfs_spec("boolean")`` with
    word-wise mask math; only the distance stamp unpacks. The padding bits
    above B in the last plane stay zero. Push-only.
    """

    def init_state(n, roots, device):
        roots = roots.to(device=device, dtype=torch.long)
        cols = torch.arange(B, device=device)
        d = torch.full((n, B), -1, dtype=torch.int32, device=device)
        d[roots, cols] = 0
        bits = torch.zeros((n, B), dtype=torch.bool, device=device)
        bits[roots, cols] = True
        f = packing.pack_bits(bits, axis=1)             # [n, ceil(B/32)]
        return {"d": d, "f": f, "visited": f.clone()}

    def update(state, y, k):
        new_w = y & ~state["visited"]
        d = torch.where(packing.unpack_bits(new_w, B, axis=1), k, state["d"])
        return ({"d": d, "f": new_w, "visited": state["visited"] | new_w},
                (new_w != 0).any())

    def host_bits(state, k, need_sb, need_nf):
        # push-only: the hostloop unions these columns into one tile set
        sb = packing.unpack_bits_np(state["f"].cpu().numpy(), B, axis=1) \
            if need_sb else None
        return sb, None

    return eng.FixpointSpec(
        name="multi_bfs/boolean_packed",
        sr_name="boolean_packed",
        batched=True,
        init_state=init_state,
        frontier=lambda state, k: state["f"],
        source_bits=lambda state, k: packing.unpack_bits(state["f"], B,
                                                         axis=1),
        update=update,
        host_bits=host_bits,
        n_bits=B,
    )


def multi_source_bfs(tiled, roots: Sequence[int],
                     semiring: str = "tropical", *,
                     need_parents: bool = False, slimwork: bool = True,
                     packed: bool = False,
                     batch_size: Optional[int] = None,
                     max_iters: Optional[int] = None,
                     log_work: bool = False,
                     config: Optional[EngineConfig] = None,
                     device=None) -> MultiBFSResult:
    """BFS from every root in ``roots``; one SpMM loop per batch.

    batch_size: roots per batch (None -> all roots in one batch).
    config: the engine knobs, as in ``bfs``: under direction "auto" every
    column carries its own direction, and ``pull_cols_log`` (with
    ``log_work``) counts the columns that ran pull in each iteration; the
    batched "hostloop" mode is push-only and raises NotImplementedError
    for pull and auto.
    packed: SlimSell-B, the B root columns packed into ``ceil(B/32)`` word
    planes and swept word-wise (needs ``semiring="boolean"`` and the push
    direction); the same distances with a 32x narrower frontier state.
    device: where to run; None means the card (raises when there is none).
    """
    config = config if config is not None else EngineConfig()
    check_bfs_options("multi_source_bfs", semiring, tiled, slimwork, config)
    if packed:
        _check_packed("multi_source_bfs", semiring, config.direction)
    tiled = on_device(tiled, device)
    roots = np.asarray(roots, np.int32).reshape(-1)
    if roots.size == 0:
        raise ValueError("multi_source_bfs needs at least one root")
    if roots.min() < 0 or roots.max() >= tiled.n:
        raise ValueError(f"roots must lie in [0, {tiled.n})")
    n = tiled.n
    max_iters = int(max_iters) if max_iters is not None else n

    d_out = np.empty((roots.size, n), np.int32)
    p_out = np.empty((roots.size, n), np.int32) if need_parents else None
    iters, work_rows, plog_rows = [], [], []
    for start, batch, batch_p in _iter_batches(roots, batch_size):
        spec = packed_multi_bfs_spec(batch_p.size) if packed \
            else multi_bfs_spec(semiring)
        with config.applied():
            if config.mode == "fused":
                res = eng.run_fused(spec, tiled, torch.from_numpy(batch_p),
                                    slimwork=slimwork, max_iters=max_iters,
                                    log_work=log_work, direction=config.direction)
            else:
                res = eng.run_hostloop(spec, tiled, torch.from_numpy(batch_p),
                                       slimwork=slimwork, max_iters=max_iters,
                                       direction=config.direction)
        state = res.state
        d_out[start:start + batch.size] = _columns_to_host(state["d"], batch.size)
        if need_parents:
            if semiring == "selmax":
                p_out[start:start + batch.size] = _columns_to_host(
                    state["p"].to(torch.int32) - 1, batch.size)
            else:
                # one DP sweep per root: memory stays one column's worth
                for b in range(batch.size):
                    p_out[start + b] = dp_transform(
                        tiled, state["d"][:, b].contiguous(),
                        int(batch[b])).cpu().numpy()
            for b, r in enumerate(batch):
                p_out[start + b, int(r)] = int(r)
        iters.append(res.iterations)
        if log_work:
            work_rows.append(res.work_log)
            plog_rows.append(res.pull_cols_log)
    wl = plog = None
    if log_work:
        # fused rows are WORK_LOG long, hostloop rows one entry per
        # iteration: pad to the longest so the batches stack
        width = max(w.size for w in work_rows)
        wl = np.zeros((len(work_rows), width), np.int32)
        plog = np.zeros((len(work_rows), width), np.int32)
        for i, (w, p) in enumerate(zip(work_rows, plog_rows)):
            wl[i, : w.size] = w
            if p is not None:
                plog[i, : p.size] = p
    return MultiBFSResult(
        distances=d_out, parents=p_out, iterations=np.asarray(iters, np.int32),
        roots=roots, work_log=wl, pull_cols_log=plog)
