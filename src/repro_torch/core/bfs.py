"""Algebraic BFS over SlimSell (paper §III): four semirings, SlimWork, DP.

One BFS iteration is one semiring SpMV (``core.spmv``) plus a semiring-
specific state update. What the sweep's payload carries, and so what
auxiliary state the update needs, is the paper's storage/work tradeoff
(§III-A, Table I):

  ================ ========================== =============================
  semiring         payload / frontier         auxiliary state per vertex
  ================ ========================== =============================
  ``tropical``     float distances in-band    none (inf == unvisited)
  ``real``         float path counts          visited bitmap + d
  ``boolean``      int32 reachability bits    visited bitmap + d
  ``selmax``       float 1-based parent ids   parent array p + d
  ================ ========================== =============================

sel-max is the only semiring whose result is the BFS tree; the other three
get parents from one sel-max DP sweep (``dp_transform``). The iteration
itself lives in ``core.engine``; BFS is the spec ``bfs_spec(semiring)``.

SlimSell-B (``packed=True``) runs the boolean recurrence over bit-packed
frontier and visited bitmaps of ``ceil(n/32)`` words
(``packed_bfs_spec``): the same distances, a 32x smaller state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import direction as dm
from . import engine as eng
from . import packing
from .formats import resolve_device
from .options import BFS_SEMIRINGS, EngineConfig
from .spmv import _combine_and_scatter
from . import semiring as sm


@dataclasses.dataclass
class BFSResult:
    """What ``bfs`` returns, all in original (pre-σ-sort) vertex space."""
    distances: np.ndarray          # int32[n]; -1 unreachable
    parents: Optional[np.ndarray]  # int32[n]; parent in BFS tree; root -> root
    iterations: int
    work_log: Optional[np.ndarray] = None    # active tiles per iteration
    directions: Optional[np.ndarray] = None  # 0 push / 1 pull per iteration


# ------------------------------------------------------------------ state ops


def _init_state(sr_name: str, n: int, root: int, device) -> dict:
    d = torch.full((n,), -1, dtype=torch.int32, device=device)
    d[root] = 0
    if sr_name == "tropical":
        f = torch.full((n,), float("inf"), device=device)
        f[root] = 0.0
        return {"d": d, "f": f}
    if sr_name in ("real", "boolean"):
        f = torch.zeros(n, dtype=sm.get(sr_name).dtype, device=device)
        f[root] = 1
        visited = torch.zeros(n, dtype=torch.bool, device=device)
        visited[root] = True
        return {"d": d, "f": f, "visited": visited}
    if sr_name == "selmax":
        x = torch.zeros(n, device=device)
        x[root] = float(root) + 1.0
        return {"d": d, "x": x, "p": x.clone()}
    raise ValueError(sr_name)


def _not_final(sr_name: str, state) -> torch.Tensor:
    """bool[n]: True where the output value can still change (SlimWork §III-C)."""
    if sr_name == "tropical":
        return torch.isinf(state["f"])
    if sr_name in ("real", "boolean"):
        return ~state["visited"]
    return state["p"] == 0.0


def _frontier_payload(sr_name: str, state) -> torch.Tensor:
    return state["x"] if sr_name == "selmax" else state["f"]


def _ids1(y: torch.Tensor) -> torch.Tensor:
    """1-based vertex ids shaped like the sweep result (sel-max payload)."""
    ids = torch.arange(y.shape[0], dtype=torch.float32, device=y.device) + 1.0
    return ids[:, None] if y.ndim == 2 else ids


def semiring_update(sr_name: str, state, y: torch.Tensor, k: int,
                    ids1: torch.Tensor):
    """Per-semiring state update given the sweep result ``y``; the same code
    serves y [n] (single source) and y [n, B] (batched)."""
    if sr_name == "tropical":
        f_new = torch.minimum(state["f"], y)  # accumulator init == implicit diagonal
        changed = (f_new < state["f"]).any()
        d = torch.where(torch.isfinite(f_new), f_new.to(torch.int32), -1)
        return {"d": d, "f": f_new}, changed
    if sr_name in ("real", "boolean"):
        new = (y > 0) & ~state["visited"]
        d = torch.where(new, k, state["d"])
        visited = state["visited"] | new
        f = new.to(state["f"].dtype)
        return {"d": d, "f": f, "visited": visited}, new.any()
    if sr_name == "selmax":
        new = (y > 0) & (state["p"] == 0.0)
        p = torch.where(new, y, state["p"])
        d = torch.where(new, k, state["d"])
        x = torch.where(new, ids1, 0.0)
        return {"d": d, "x": x, "p": p}, new.any()
    raise ValueError(sr_name)


def host_direction_bits(sr_name: str, state, k: int, need_sb: bool,
                        need_nf: bool):
    """numpy twins of ``frontier_bits`` and ``_not_final`` for the hostloop
    engine: ``(sb, nf)``, each None unless asked for. One copy to the host
    per state field; under tropical both come from the one copy of ``f``.
    The same code serves [n] and [n, B] states."""
    sb = nf = None
    if sr_name == "tropical":
        f = state["f"].cpu().numpy() if (need_sb or need_nf) else None
        sb = (f == (k - 1)) if need_sb else None
        nf = np.isinf(f) if need_nf else None
    elif sr_name in ("real", "boolean"):
        sb = (state["f"].cpu().numpy() > 0) if need_sb else None
        nf = ~state["visited"].cpu().numpy() if need_nf else None
    else:
        sb = (state["x"].cpu().numpy() > 0) if need_sb else None
        nf = (state["p"].cpu().numpy() == 0.0) if need_nf else None
    return sb, nf


@functools.lru_cache(maxsize=None)
def bfs_spec(sr_name: str) -> eng.FixpointSpec:
    """Single-source BFS as a fixpoint spec (one spec per semiring)."""
    return eng.FixpointSpec(
        name=f"bfs/{sr_name}",
        sr_name=sr_name,
        init_state=lambda n, root, device: _init_state(sr_name, n, root, device),
        frontier=lambda state, k: _frontier_payload(sr_name, state),
        source_bits=lambda state, k: dm.frontier_bits(sr_name, state, k),
        not_final=lambda state: _not_final(sr_name, state),
        update=lambda state, y, k: semiring_update(sr_name, state, y, k,
                                                   _ids1(y)),
        host_bits=lambda state, k, need_sb, need_nf: host_direction_bits(
            sr_name, state, k, need_sb, need_nf),
    )


@functools.lru_cache(maxsize=None)
def packed_bfs_spec(n: int) -> eng.FixpointSpec:
    """SlimSell-B single-source BFS: boolean BFS with its frontier and
    visited bitmaps packed to int32[ceil(n/32)] words.

    The recurrence of ``bfs_spec("boolean")``, with word-wise mask math
    (``new = y & ~visited``; ``~`` on int32 flips the same 32 bits) and the
    packed SpMV as the sweep. Only the distance stamp unpacks. Tail bits
    stay zero: y's are, and AND keeps them so. Push-only.
    """

    def init_state(n_, root, device):
        d = torch.full((n,), -1, dtype=torch.int32, device=device)
        d[root] = 0
        bits = torch.zeros(n, dtype=torch.bool, device=device)
        bits[root] = True
        f = packing.pack_bits(bits)
        return {"d": d, "f": f, "visited": f.clone()}

    def update(state, y, k):
        new_w = y & ~state["visited"]
        d = torch.where(packing.unpack_bits(new_w, n), k, state["d"])
        return ({"d": d, "f": new_w, "visited": state["visited"] | new_w},
                (new_w != 0).any())

    def host_bits(state, k, need_sb, need_nf):
        # push-only: the hostloop asks for the source bits alone
        sb = packing.unpack_bits_np(state["f"].cpu().numpy(), n) \
            if need_sb else None
        return sb, None

    return eng.FixpointSpec(
        name="bfs/boolean_packed",
        sr_name="boolean_packed",
        init_state=init_state,
        frontier=lambda state, k: state["f"],
        source_bits=lambda state, k: packing.unpack_bits(state["f"], n),
        update=update,
        host_bits=host_bits,
        n_bits=n,
    )


# ---------------------------------------------------------------- DP transform


def dp_transform(tiled, d: torch.Tensor, root: int) -> torch.Tensor:
    """p = DP(d): for each v pick a neighbor w with d[w] == d[v]-1 (paper §II-C).

    One SlimSell sweep under the sel-max semiring (the largest such id
    wins); O(m+n) work. Returns int32[n] with p[root] = root, -1 where v
    is unreachable.
    """
    cols = tiled.cols
    pad = cols < 0
    safe = cols.clamp_min(0)
    d_nbr = d.index_select(0, safe.reshape(-1)).reshape(cols.shape)   # [T, C, L]
    rv_tile = tiled.row_vertex.index_select(0, tiled.row_block)       # [T, C]
    d_row = d.index_select(0, rv_tile.clamp_min(0).reshape(-1)).reshape(
        rv_tile.shape)[:, :, None]
    ok = (~pad) & (d_row > 0) & (d_nbr == d_row - 1) & (d_nbr >= 0)
    tile_red = torch.where(ok, safe + 1, 0).amax(dim=-1)              # [T, C]
    y_blocks = torch.zeros((tiled.n_chunks, tiled.C), dtype=torch.int32,
                           device=cols.device)
    idx = tiled.row_block.long()[:, None].expand_as(tile_red).contiguous()
    y_blocks.scatter_reduce_(0, idx, tile_red, "amax", include_self=True)
    # the ids are int32, so the int32 max semiring (boolean's) places them
    p = _combine_and_scatter(sm.BOOLEAN, tiled, y_blocks) - 1
    p[root] = root
    return p


# ----------------------------------------------------------------- public API


def check_bfs_options(fn_name: str, semiring: str, tiled, slimwork: bool,
                      config: EngineConfig):
    """Shared entry validation for the BFS-family front doors; the push
    index is needed where push tile masks are built (push and auto under
    SlimWork)."""
    if semiring not in BFS_SEMIRINGS:
        raise KeyError(f"{fn_name} supports {BFS_SEMIRINGS}, got {semiring!r}")
    if config.direction in ("push", "auto") and slimwork \
            and tiled.inc_src is None:
        raise ValueError("push tile masks need the push index; rebuild the "
                         "layout with formats.build_slimsell")
    if semiring == "selmax" and tiled.n > (1 << 24):
        # sel-max carries 1-based vertex ids in its float32 payload
        raise ValueError("selmax BFS carries vertex ids in float32 (exact "
                         f"up to 2^24); use another semiring for n={tiled.n}")


def _check_packed(fn_name: str, semiring: str, direction: str):
    """Validation of ``packed=True``: the packed path is the boolean
    recurrence over packed words, push only."""
    if semiring != "boolean":
        raise ValueError(f"{fn_name}: packed=True is the bit-packed boolean "
                         f"path; got semiring={semiring!r}")
    if direction != "push":
        raise ValueError(f"{fn_name}: packed=True is push-only (packed "
                         "payloads carry no per-row ordering for the pull "
                         f"early-exit); got direction={direction!r}")


def on_device(tiled, device):
    """The layout on the entry point's device: a host layout is moved there;
    a device layout must already be on it (the entry points never move a
    layout between devices on their own)."""
    dev = resolve_device(device)
    if tiled.device is None:
        return tiled.to_torch(dev)
    if tiled.device.type != dev.type or (dev.index is not None
                                         and tiled.device != dev):
        raise ValueError(f"the layout is on {tiled.device}, the call asks for "
                         f"{dev}; move it with to_torch({str(dev)!r})")
    return tiled


def bfs(tiled, root: int, semiring: str = "tropical", *,
        need_parents: bool = False, slimwork: bool = True,
        packed: bool = False,
        max_iters: Optional[int] = None, log_work: bool = False,
        config: Optional[EngineConfig] = None, device=None) -> BFSResult:
    """Run BFS from ``root``; returns distances (+parents) in vertex space.

    semiring: one of ``BFS_SEMIRINGS``; all four give identical distances,
    ``selmax`` also gives parents in-band, the others derive them with one
    DP sweep when ``need_parents=True``.
    slimwork: sweep only the tiles that can change the output (§III-C).
    config: the engine knobs (``EngineConfig``): direction "push" (top-down
    SpMV over the frontier's tiles), "pull" (bottom-up sweep over the
    not-final rows, with a per-row early exit) or "auto" (Beamer's
    alpha/beta switch each iteration); mode "fused" or "hostloop" (masks
    and the direction choice in numpy on the host). ``directions`` holds
    the direction of each iteration under ``log_work`` or "hostloop", and
    also otherwise unless the direction is "auto"; ``work_log`` is kept
    under ``log_work`` or "hostloop".
    packed: SlimSell-B, the boolean recurrence over bit-packed
    int32[ceil(n/32)] frontier and visited bitmaps and the packed sweep
    (needs ``semiring="boolean"`` and the push direction); the same
    distances with a 32x smaller state. Parents come from the DP pass.
    device: where to run; None means the card (raises when there is none).
    """
    config = config if config is not None else EngineConfig()
    check_bfs_options("bfs", semiring, tiled, slimwork, config)
    if packed:
        _check_packed("bfs", semiring, config.direction)
    tiled = on_device(tiled, device)
    root = int(root)
    if not 0 <= root < tiled.n:
        raise ValueError(f"root {root} outside [0, {tiled.n})")
    max_iters = int(max_iters) if max_iters is not None else tiled.n
    spec = packed_bfs_spec(tiled.n) if packed else bfs_spec(semiring)
    with config.applied():
        if config.mode == "fused":
            res = eng.run_fused(spec, tiled, root, slimwork=slimwork,
                                max_iters=max_iters, log_work=log_work,
                                direction=config.direction)
        else:
            res = eng.run_hostloop(spec, tiled, root, slimwork=slimwork,
                                   max_iters=max_iters,
                                   direction=config.direction)
    state = res.state
    parents = None
    if need_parents:
        if semiring == "selmax":
            p = state["p"].to(torch.int32) - 1
            p[root] = root
        else:
            p = dp_transform(tiled, state["d"], root)
        parents = p.cpu().numpy()
    wl = res.work_log if (log_work or config.mode == "hostloop") else None
    return BFSResult(distances=state["d"].cpu().numpy(), parents=parents,
                     iterations=res.iterations, work_log=wl,
                     directions=res.dirs_log)
