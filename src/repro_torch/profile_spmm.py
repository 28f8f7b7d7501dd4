"""Where the SlimSell SpMM and SpMV spend their time across chunks, on the card.

    PYTHONPATH=src python -m repro_torch.profile_spmm --scale 20

Builds ``kronecker(scale, 16, seed=1)`` with the Graph500 SSSP weights
(uniform on [2^-8, 1], seed 2) and its SlimSell layout (C=8, L=128,
sigma=n), and times each sweep entry through ``kernels.ops`` with every
tile kept and then over parts of the layout, chosen by the SlimWork tile
mask: the chunk with the most tiles alone, every other chunk, the chunks
of at least ``--heavy`` tiles alone, the rest, and no tile at all (the
launch and the write of the output). The SpMM entries: the implicit SpMM
(2, tropical, B=64), the stored-weight min-plus SpMM (2w, B=64) and the
GCN SpMM (2g, real, B=16). The SpMV entries: the implicit SpMV (1) under
tropical and under real, and the stored-weight min-plus SpMV (1w); beside
them ``adj @ x`` (sparse CSR times x, real) and 1w over the real sweep
masks of one single-source SSSP (from Graph500's first search key, the
default delta): each sweep's state rebuilt, its frontier, weight view and
mask timed, and the sum over the sweeps. If one block's walk over the
longest chunk holds a sweep, the heaviest chunk alone takes most of the
time of all of it.

Two entries run at real states of Graph500's 64-root batch (its search
keys): the batched pull (4, ``slimsell_pull_mm``, tropical, B=64) at the
state just before the first iteration in which most of the auto batch's
columns pull, every part also restricted to that state's own SlimWork
mask, with one more part that has no pending (row, column) (the floor:
reading the not-final bits and writing Y), the slots the first hits need
(``pull_work``) and the push SpMM of the same iteration; and the packed
SpMM (6, ``slimsell_spmm_packed``, B=64) at the packed batch's iteration
with the most tiles, every tile kept. Two more run at real states of
single-source BFS from Graph500's first search key (``chip_smoke.py``'s
phase-4b root): the single-source pull (3, ``slimsell_pull``, tropical)
at the state just before the first iteration that the auto BFS runs as
pull, split as kernel 4 is, beside ``pull_work``, the push SpMV of the
same iteration over its push mask and kernel 4 at B=1 on the same state;
and the packed SpMV (5, ``slimsell_spmv_packed``) at the packed BFS's
iteration with the most tiles, every tile kept, beside kernel 1 (tropical,
random x) in the same call. ``--only`` picks the groups to run
(``spmv``, ``spmm``, ``pull``, ``pull_mm``, ``spmv_packed``,
``spmm_packed``). The last line is all of it as JSON.

It measures the device, so it needs a CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
from .core import direction as dm
from .core import engine, semiring
from .core.bfs import bfs, bfs_spec, packed_bfs_spec
from .core.formats import build_slimsell
from .core.multi_bfs import (multi_bfs_spec, multi_source_bfs,
                             packed_multi_bfs_spec)
from .core.options import EngineConfig
from .core.spmv import pull_first_hits
from .core.sssp import default_delta, sssp, sssp_spec
from .graph500 import sample_roots
from .graphs.generators import kronecker, with_random_weights
from .kernels import ops

EDGE_FACTOR = 16  # Graph500's
GROUPS = ("spmv", "spmm", "pull", "pull_mm", "spmv_packed",
          "spmm_packed")


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def chunk_masks(tiled, heavy: int) -> dict:
    """Tile masks of the parts timed: {name: bool[T]} and the tile counts
    (below ``cl``) of the chunks each part keeps."""
    live = -(-tiled.cl.long() // tiled.L)                    # tiles below cl
    top = int(live.argmax())
    rb = tiled.row_block.long()
    big = live >= heavy
    parts = {"all": torch.ones_like(rb, dtype=torch.bool),
             "heaviest chunk": rb == top,
             "all but the heaviest": rb != top,
             f"chunks of >= {heavy} tiles": big[rb],
             f"chunks of < {heavy} tiles": ~big[rb],
             "none": torch.zeros_like(rb, dtype=torch.bool)}
    info = {"heaviest_chunk": top, "heaviest_tiles": int(live[top]),
            "next_tiles": torch.topk(live, 4).values.tolist()[1:],
            "heavy_chunks": int(big.sum()),
            "heavy_slots": int((tiled.cl.long() * tiled.C)[big].sum()),
            "slots": int((tiled.cl.long() * tiled.C).sum())}
    return parts, info


def chunk_split(fn, tiled, *, heavy: int = 10, reps: int = 10,
                parts=None) -> dict:
    """{part: ms} of ``fn(tile_mask)`` over the parts of ``chunk_masks``
    named in ``parts`` (default: all), and the parts' tile counts under
    "layout"."""
    masks, info = chunk_masks(tiled, heavy)
    out = {name: time_ms(lambda: fn(mask), reps) for name, mask in masks.items()
           if parts is None or name in parts}
    out["layout"] = info
    return out


def entries(tiled, device, rng) -> dict:
    """The three SpMM entries at the main paths' widths, as callables of a
    tile mask: {name: (batch width, fn)}."""
    n = tiled.n
    X = rng.integers(0, 4, size=(n, 64)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = np.inf
    X = torch.from_numpy(X).to(device)
    Xw = rng.uniform(0.0, 8.0, (n, 64)).astype(np.float32)
    Xw[rng.random(Xw.shape) >= 0.7] = np.inf
    Xw = torch.from_numpy(Xw).to(device)
    X16 = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).to(device)
    deg = tiled.deg.float()
    return {
        "slimsell_spmm": (64, lambda m: ops.spmm(semiring.TROPICAL, tiled, X,
                                                 tile_mask=m)),
        "slimsell_spmm_wts": (64, lambda m: ops.spmm(
            semiring.MINPLUS, tiled, Xw, tile_mask=m, weights=tiled.wts)),
        "slimsell_spmm_gcn": (16, lambda m: ops.spmm(
            semiring.REAL, tiled, X16, tile_mask=m, deg=deg)),
    }


def spmv_entries(tiled, device, rng) -> dict:
    """The three SpMV entries at the main paths' operands, as callables of
    a tile mask: {name: (batch width, fn)}."""
    n = tiled.n
    x = rng.integers(0, 4, size=n).astype(np.float32)
    x[rng.random(n) < 0.5] = np.inf
    xr = rng.integers(0, 4, size=n).astype(np.float32)
    xw = rng.uniform(0.0, 8.0, n).astype(np.float32)
    xw[rng.random(n) >= 0.7] = np.inf
    out = {}
    for name, sr, xs, w in (
            ("slimsell_spmv", semiring.TROPICAL, x, None),
            ("slimsell_spmv real", semiring.REAL, xr, None),
            ("slimsell_spmv_wts", semiring.MINPLUS, xw, tiled.wts)):
        xt = torch.from_numpy(xs).to(device)

        def fn(m, sr=sr, xt=xt, w=w):
            return ops.spmv(sr, tiled, xt, tile_mask=m, weights=w)
        out[name] = (1, fn)
    return out


def library_spmv(csr, x: torch.Tensor):
    """``adj @ x`` (sparse CSR times x, real) as a callable."""
    adj = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)), torch.ones(csr.nnz),
        size=(csr.n, csr.n)).to(x.device)
    return lambda: adj @ x


def length_histogram(tiled, edges=(0, 4, 8, 16, 32, 64, 128, 1024)) -> dict:
    """Chunks and slots below ``cl`` by chunk length: {"<= e": [chunks,
    slots]} for each edge e, then "> last"."""
    cl = tiled.cl.long()
    out, lo = {}, -1
    for e in (*edges, None):
        sel = (cl > lo) if e is None else (cl > lo) & (cl <= e)
        key = f"> {lo}" if e is None else f"<= {e}"
        out[key] = [int(sel.sum()), int((cl[sel] * tiled.C).sum())]
        lo = e
    return out


def sssp_sweeps(tiled, root: int) -> list:
    """The sweeps of ``sssp(tiled, root)`` (default delta, fused) as
    ``(k, x, weights, tile_mask)``: each state rebuilt by running the
    engine for k - 1 sweeps, the way the sweep saw it. Checks each mask's
    tile count against the run's work log."""
    delta = default_delta(tiled)
    run = sssp(tiled, root, delta=delta, log_work=True, device=tiled.device)
    spec = sssp_spec(tiled, delta)
    out = []
    for k in range(1, run.sweeps + 1):
        st = engine.run_fused(spec, tiled, root, max_iters=k - 1).state
        mask = dm.push_tile_mask(tiled, spec.source_bits(st, k))
        if int(mask.sum()) != int(run.work_log[k - 1]):
            raise AssertionError(f"sweep {k}: the rebuilt state is not the run's")
        out.append((k, spec.frontier(st, k), spec.weights(st), mask))
    return out


def sweep_times(tiled, sweeps, reps: int) -> list:
    """ms of the stored-weight SpMV at each sweep's own state and mask."""
    return [time_ms(lambda: ops.spmv(semiring.MINPLUS, tiled, x, tile_mask=m,
                                     weights=w), reps)
            for _, x, w, m in sweeps]


def tile_slots(tiled) -> torch.Tensor:
    """int64[T]: the slots of one row of each tile before its chunk's
    length cl, the ones a sweep reads in each row when it keeps the tile."""
    ptr = tiled.tile_ptr.long()
    rb = tiled.row_block.long()
    rank = torch.arange(tiled.n_tiles, device=ptr.device) - ptr[rb]
    return (tiled.cl.long()[rb] - rank * tiled.L).clamp(0, tiled.L)


def pull_work(tiled, ranks, nf, mask, per_piece=None):
    """What the first-hit pull needs at this state, worked out from the
    plain version's hit ranks (int32[n, B], -1 for no hit): a pending
    (v, b) reads the kept slots of v's chunk through its hit tile, or all
    of them without a hit, and a row's cols are read once for all its
    columns. Returns a dict: cols slots read, operations, the 32-byte
    sectors of X the pending columns gather (eight float columns a
    sector, fetched at a slot while any of them is pending), the slots all
    kept tiles of the pending rows hold, and for the chunk with the most
    tiles, the tiles it has and the tiles its block must load. With
    ``per_piece`` (the chunks cut into pieces of that many tiles that run
    side by side) also ``slots_past_hits``: the kept slots of the pieces
    after the one that holds a row's last first hit, which a piece reads
    without knowing of the earlier hits. A row leaves such a piece once its
    columns hit there as well, so it reads at most these."""
    C = tiled.C
    ptr = tiled.tile_ptr.long()
    slots_t = tile_slots(tiled)
    if mask is not None:
        slots_t = slots_t * mask
    cum = torch.cat([slots_t.new_zeros(1), slots_t.cumsum(0)])
    rv = tiled.row_vertex.long().reshape(-1)
    chunk_of = torch.empty(tiled.n, dtype=torch.long, device=rv.device)
    rows = torch.arange(rv.numel(), device=rv.device)
    chunk_of[rv[rv >= 0]] = (rows // C)[rv >= 0]
    start = ptr[chunk_of][:, None]                                  # [n, 1]
    kept = (cum[ptr[1:]] - cum[ptr[:-1]])[chunk_of][:, None]
    through = cum[start + ranks.long().clamp_min(0) + 1] - cum[start]
    slots = torch.where(ranks >= 0, through, kept) * nf              # [n, B]
    # a block loads tiles until none of its rows is pending
    n_tiles = ptr[1:] - ptr[:-1]
    need = (torch.where(ranks >= 0, ranks.long() + 1,
                        n_tiles[chunk_of][:, None]) * nf).amax(dim=1)
    loaded = torch.zeros_like(n_tiles).scatter_reduce_(0, chunk_of, need, "amax")
    longest = int(n_tiles.argmax())
    per_sector = slots.new_zeros(slots.shape[0], -(-slots.shape[1] // 8) * 8)
    per_sector[:, :slots.shape[1]] = slots
    out = {"slots_read": int(slots.amax(dim=1).sum()),
           "operations": 2 * int(slots.sum()),
           "x_sectors": int(per_sector.reshape(slots.shape[0], -1, 8)
                            .amax(dim=2).sum()),
           "slots_kept": int((kept * nf.any(dim=1, keepdim=True)).sum()),
           "longest_chunk_tiles": int(n_tiles[longest]),
           "longest_chunk_tiles_loaded": int(loaded[longest])}
    if per_piece is not None:
        # a row whose pending columns all hit: its last needed tile rank,
        # rounded up to the end of its piece
        all_hit = ((ranks >= 0) | ~nf).all(dim=1) & nf.any(dim=1)
        last = torch.where(nf, ranks.long(), -1).amax(dim=1)
        end = torch.minimum((last // per_piece + 1) * per_piece,
                            n_tiles[chunk_of])
        to_end = cum[ptr[chunk_of] + end] - cum[ptr[chunk_of]]
        out["slots_past_hits"] = int(((kept[:, 0] - to_end) * all_hit).sum())
    return out


def pull_mm_state(tiled, roots: np.ndarray) -> dict:
    """The batched pull's state as ``chip_smoke.py`` phase 6 builds it:
    the tropical ``multi_bfs_spec`` state of ``roots`` just before the
    first iteration k in which most of the auto batch's columns pull (the
    first with any, if none has most): its frontier X, not-final bits nf,
    SlimWork mask (the chunks with a not-final row) and frontier bits."""
    B = roots.size
    auto = multi_source_bfs(tiled, roots, "tropical", log_work=True,
                            config=EngineConfig(direction="auto"),
                            device=tiled.device)
    plog = auto.pull_cols_log[0]
    if not (plog > 0).any():
        raise AssertionError("the auto batch never pulls")
    k = 1 + int(np.argmax(plog > B // 2)) if (plog > B // 2).any() \
        else 1 + int(np.argmax(plog > 0))
    return _pull_state(multi_bfs_spec("tropical"), tiled,
                       torch.from_numpy(roots), k)


def pull_state(tiled, root: int) -> dict:
    """The single-source pull's state as ``chip_smoke.py`` phase 6 builds
    it: the tropical ``bfs_spec`` state of ``root`` just before the first
    iteration k that the auto BFS runs as pull, with the same fields as
    ``pull_mm_state`` (x [n], nf bool[n])."""
    auto = bfs(tiled, root, "tropical", log_work=True,
               config=EngineConfig(direction="auto"), device=tiled.device)
    if not (auto.directions == dm.PULL).any():
        raise AssertionError("the auto BFS never pulls")
    k = 1 + int(np.argmax(auto.directions == dm.PULL))
    return _pull_state(bfs_spec("tropical"), tiled, root, k)


def _pull_state(spec, tiled, arg, k: int) -> dict:
    """``spec``'s state from ``arg`` (a root or the roots) just before
    iteration k, run in the pull direction, and its SlimWork pull mask."""
    st = engine.run_fused(spec, tiled, arg, max_iters=k - 1,
                          direction="pull").state
    nf = spec.not_final(st)
    rows = nf.any(dim=-1) if nf.ndim > 1 else nf
    return {"k": k, "X": spec.frontier(st, k), "nf": nf,
            "mask": engine._pull_tile_mask(tiled, rows),
            "fbits": spec.source_bits(st, k)}


def packed_state(tiled, roots: np.ndarray) -> dict:
    """The packed batch's state (``chip_smoke.py`` phase 7c): the packed
    word planes X of ``roots`` at the iteration k with the most tiles."""
    pk = multi_source_bfs(tiled, roots, "boolean", packed=True,
                          log_work=True, device=tiled.device)
    wl = pk.work_log[0][:int(pk.iterations[0])]
    k = 1 + int(np.argmax(wl))
    spec = packed_multi_bfs_spec(roots.size)
    st = engine.run_fused(spec, tiled, torch.from_numpy(roots),
                          max_iters=k - 1).state
    return {"k": k, "X": spec.frontier(st, k), "tiles": int(wl[k - 1])}


def packed_bfs_state(tiled, root: int) -> dict:
    """The packed single-source BFS's state (``chip_smoke.py`` phase 7c):
    the packed frontier bitmap x of ``root`` at the iteration k with the
    most tiles."""
    res = bfs(tiled, root, "boolean", packed=True, log_work=True,
              device=tiled.device)
    k = 1 + int(np.argmax(res.work_log))
    st = engine.run_fused(packed_bfs_spec(tiled.n), tiled, root,
                          max_iters=k - 1).state
    return {"k": k, "X": packed_bfs_spec(tiled.n).frontier(st, k),
            "tiles": int(res.work_log[k - 1])}


def pull_split(tiled, X, nf, mask, *, heavy: int = 10, reps: int = 10,
               parts=None) -> dict:
    """The pull (tropical) at a pull state: kernel 3 for X [n], nf bool[n],
    kernel 4 for X [n, B], nf bool[n, B], with the state's mask:
    ``chunk_split`` with each part also restricted to the mask, and "no
    pending" (nf all false: reading nf and writing y, the floor)."""
    tropical = semiring.TROPICAL
    fn = ops.pull if X.ndim == 1 else ops.pull_mm
    split = chunk_split(lambda m: fn(tropical, tiled, X, nf,
                                     tile_mask=m & mask),
                        tiled, heavy=heavy, reps=reps, parts=parts)
    none = torch.zeros_like(nf)
    split["no pending"] = time_ms(lambda: fn(tropical, tiled, X, none,
                                             tile_mask=mask), reps)
    return split


def pull_profile(tiled, state: dict, *, heavy: int, reps: int) -> dict:
    """Kernel 3 or 4 at ``state`` (``pull_state`` or ``pull_mm_state``):
    ``pull_split``, the slots the first hits need (and at most those the
    pieces, of ``ops.spmv_piece_tiles`` tiles, read past them) and the push
    sweep of the same iteration over its push mask (the SpMV or the SpMM);
    for kernel 3 also kernel 4 at B=1 on the same state."""
    tropical = semiring.TROPICAL
    X, nf, mask = state["X"], state["nf"], state["mask"]
    split = pull_split(tiled, X, nf, mask, heavy=heavy, reps=reps)
    X2, nf2 = (X[:, None], nf[:, None]) if X.ndim == 1 else (X, nf)
    _, ranks = pull_first_hits(tropical, tiled, X2, nf2, mask)
    work = pull_work(tiled, ranks, nf2, mask, ops.spmv_piece_tiles(tiled.L))
    push_mask = dm.push_tile_mask(tiled, state["fbits"])
    push = ops.spmv if X.ndim == 1 else ops.spmm
    out = {"iteration": state["k"], "batch": X2.shape[1], **split,
           "push_ms": time_ms(lambda: push(tropical, tiled, X,
                                           tile_mask=push_mask), reps)}
    if X.ndim == 1:
        X2, nf2 = X2.contiguous(), nf2.contiguous()
        out["pull_mm B=1 ms"] = time_ms(lambda: ops.pull_mm(
            tropical, tiled, X2, nf2, tile_mask=mask), reps)
    out.update(work=work, pending_rows=int(nf2.any(dim=1).sum()),
               tiles_kept=int(mask.sum()), push_tiles=int(push_mask.sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--heavy", type=int, default=10,
                    help="tiles that make a chunk heavy")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=list(GROUPS),
                    help="the groups of entries to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_spmm measures the card: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    csr = with_random_weights(kronecker(args.scale, EDGE_FACTOR, seed=1),
                              low=WEIGHT_LOW, high=WEIGHT_HIGH, seed=2)
    tiled = build_slimsell(csr, C=8, L=128, sigma=csr.n).to_torch(dev)
    result = {"card": card, "scale": args.scale, "n": tiled.n,
              "tiles": tiled.n_tiles, "chunks": tiled.n_chunks, "entries": {}}
    rng = np.random.default_rng(0)
    todo = {**(spmv_entries(tiled, dev, rng) if "spmv" in args.only else {}),
            **(entries(tiled, dev, rng) if "spmm" in args.only else {})}
    roots = sample_roots(csr, 64)
    root = int(sample_roots(csr, 1)[0])  # chip_smoke.py's phase-4b root
    if "spmv_packed" in args.only:
        pk1 = packed_bfs_state(tiled, root)
        todo["slimsell_spmv_packed"] = (1, lambda m: ops.spmv_packed(
            tiled, pk1["X"], tile_mask=m))
        result["packed bfs iteration"] = {"k": pk1["k"], "tiles": pk1["tiles"]}
        if "spmv" not in args.only:  # kernel 1 in the same call
            todo["slimsell_spmv"] = spmv_entries(tiled, dev, rng)["slimsell_spmv"]
    if "spmm_packed" in args.only:
        pk = packed_state(tiled, roots)
        todo["slimsell_spmm_packed"] = (64, lambda m: ops.spmm_packed(
            tiled, pk["X"], tile_mask=m))
        result["packed iteration"] = {"k": pk["k"], "tiles": pk["tiles"]}
    for name, (width, fn) in todo.items():
        split = chunk_split(fn, tiled, heavy=args.heavy, reps=args.reps)
        result["entries"][name] = {"batch": width, **split}
        print(f"{name} B={width}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items() if k != "layout")
            + f" on {card}", flush=True)
    for group, name, make in (
            ("pull", "slimsell_pull", lambda: pull_state(tiled, root)),
            ("pull_mm", "slimsell_pull_mm", lambda: pull_mm_state(tiled, roots))):
        if group not in args.only:
            continue
        prof = pull_profile(tiled, make(), heavy=args.heavy, reps=args.reps)
        result["entries"][name] = prof
        print(f"{name} B={prof['batch']} at iteration {prof['iteration']} "
              "(each part within the state's mask): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in prof.items()
                          if isinstance(v, float))
              + f" | pending rows {prof['pending_rows']}, tiles kept "
              f"{prof['tiles_kept']}, push tiles {prof['push_tiles']}, "
              f"{prof['work']} on {card}", flush=True)
    hist = length_histogram(tiled)
    result["chunk lengths"] = hist
    print(f"layout: {chunk_masks(tiled, args.heavy)[1]}; chunks, slots by "
          f"cl: {hist}")
    if "spmv" in args.only:
        xr = torch.from_numpy(rng.integers(0, 4, size=tiled.n).astype(
            np.float32)).to(dev)
        lib_ms = time_ms(library_spmv(csr, xr), args.reps)
        sweeps = sssp_sweeps(tiled, root)
        times = sweep_times(tiled, sweeps, args.reps)
        result["adj @ x"] = lib_ms
        result["sssp sweeps"] = {
            "root": root, "tiles": [int(m.sum()) for *_, m in sweeps],
            "ms": times, "sum_ms": sum(times)}
        print(f"adj @ x (real): {lib_ms:.4f} ms on {card}")
        print(f"slimsell_spmv_wts over the {len(sweeps)} sweeps of sssp from "
              f"root {root}: sum {sum(times):.4f} ms, per sweep "
              + ", ".join(f"{int(m.sum())}:{t:.4f}"
                          for (*_, m), t in zip(sweeps, times))
              + f" on {card}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
