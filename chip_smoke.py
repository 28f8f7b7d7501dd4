#!/usr/bin/env python3
"""Drive the PyTorch port of SlimSell BFS on one CUDA card, end to end.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, each of which must pass (any failure ends the run with a nonzero
exit and no result line):

1. the card's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nine
   entry points in six sources);
3. every kernel against its plain PyTorch version on the card, exactly
   (all values are integers or +-inf), on a scale-14 Kronecker graph:
   4 semirings x {SpMV, SpMM B=1/5/64} x 4 tile masks (none given, all
   kept, none kept, random with whole chunks dropped), and 4 semirings x
   {pull, pull_mm B=1/5/64} x the same masks x not-final bits (random,
   all, none);
4. (a) the kernel path against the plain path at scale 14: single- and
   multi-source BFS in push, pull and auto, and single-source hostloop
   auto: distances, parents, iterations, work and direction logs equal;
   (b) single-source BFS at scale 20 in all four semirings, push and
   auto, and one hostloop auto run, each tree validated (Graph500 §5.2);
5. the Graph500 harness, 64 roots in one batch of 64, on the same graph:
   push (all 64 trees validated against the oracle), then auto and pull
   (the pull batch through the pull_mm kernel): their TEPS, and their
   distances bit-equal to the push batch's with all 64 trees validated;
6. at the scale-20 shapes, every kernel against its plain version again:
   SpMV and SpMM (4 semirings x 4 masks), pull and pull_mm at a real pull
   state (the BFS state just before an iteration that pulls, 4
   semirings); then each kernel timed beside its plain version, a
   library call and its bound;
7. SlimSell-B, the bit-packed boolean path: (a) at scale 14 both packed
   kernels against their plain versions, exactly (5 masks x the SpMV and
   the SpMM at B=1/5/33/64/97/160 x 2 frontier densities; 97 and 160 fill
   4 and 5 word planes, so the SpMM's second grid-y block runs partly
   used), then packed ``bfs``
   and ``multi_source_bfs``, fused and hostloop, on the card against the
   same on the CPU; (b) at scale 20, packed ``bfs`` from the phase-4b root,
   fused and hostloop, bit-equal to lane-boolean push (distances,
   iterations, work log) with a valid DP-parent tree, and the packed batch
   of the phase-5 roots, distances equal to the push batch's and all 64
   trees valid, timed with and without parents beside push in turns, with
   TEPS under ``run_graph500``'s accounting, and packed ``bfs`` timed in
   turns with lane-boolean push; (c) each packed kernel at the
   real state of the iteration with the most tiles, with that iteration's
   mask and with every tile kept, against its plain version and timed
   beside it, the lane kernel, a library call and its bound; (d) the
   paper's storage accounting at scale 20;
8. weighted SSSP (delta-stepping) through the stored-weight (min-plus)
   kernel: (a) at scale 14 the kernel against its plain version, exactly
   (the full ``wts`` and its light and heavy views at the default delta x
   the five masks of 7a x frontiers all +inf, sparse and dense), then
   ``sssp`` on the card against ``sssp`` on the CPU, fused and hostloop, at
   the default delta, at inf and at 0.05: distances, parents, sweeps,
   buckets and work log equal; (b) at scale 20, ``sssp`` from the phase-4b
   root, fused and hostloop (bit-equal to each other, timed), its distances
   checked against scipy's Dijkstra and its tree validated; then
   ``run_graph500_sssp`` over the phase-5 roots, timed without validation,
   and their trees validated against one scipy Dijkstra call (all 64, or
   the first 16 when 64 would not fit the time limit: the count is
   printed); (c) the kernel at the real state of the sweep with the most
   tiles, with that sweep's mask and with every tile kept, against its
   plain version, timed beside it, the implicit-value SpMV on the same
   frontier, a library call and its bound;
9. batched multi-source SSSP through the stored-weight (min-plus) SpMM
   kernel: (a) at scale 14 the kernel against its plain version, exactly
   (the five masks of 7a x B=1/5/33/64/97/160 x frontiers sparse and
   dense, each with the layout's weights and with every padding slot's
   weight poisoned to -1000; 160 takes a second, partly used block along
   grid y), then ``multi_source_sssp`` on the card against the CPU, fused
   and hostloop; (b) at scale 20, ``multi_source_sssp`` over the 64
   phase-5 roots in one batch of 64, default delta, parents on, fused and
   hostloop: fused == hostloop, and each row's distances, parents, sweeps
   and buckets == phase 8b's per-root ``sssp`` of that root; (c)
   ``run_graph500_sssp(batched=True, batch_size=64)`` with and without
   parents, its sweeps and buckets == the per-root harness's, and the
   batch's trees validated against the per-root distances (all 64, or the
   first 16 when 64 would not fit the time limit: the count is printed);
   (d) the kernel at the real state of the batch's sweep with the most
   tiles, with that sweep's mask and with every tile kept, against its
   plain version, timed beside it, the implicit-value SpMM on the same
   frontier, a library call and its bound;
10. GCN inference (gcn-cora, 2 layers 1433 -> 16 -> 16) on the SlimSell-W
   aggregation through the GCN-weighted SpMM kernel: (a) the kernel
   against its plain version, rtol = atol = 1e-5 and no NaN, on an
   Erdos-Renyi graph of Cora's shape (2,708 nodes, average degree 3.9) at
   C=8, L=16 and the scale-14 graph (isolated vertices) at C=8, L=128 and
   L=16, x B=1/5/16/33/64/160 x the five masks of 7a (160 takes a second
   block along grid y); then ``gcn_forward`` on the card against the CPU,
   both aggregations, at d_in 1433 on the first two graphs, atol = rtol =
   1e-4; (b) at scale 20, N(0, 1) features from a seeded card generator
   (6.01 GB): three requests (``aggregation="slimsell"`` forwards under
   ``torch.inference_mode()``), equal to each other and to the segment
   aggregation within atol = rtol = 1e-3, then the warm forward of each
   aggregation timed (median of 5) with its ``x @ w`` and aggregation
   shares and nodes/s; (c) the kernel at d = 16 with every tile kept
   against a float64 run of its plain version (atol = rtol = 1e-4), timed
   beside the plain version, the implicit real SpMM on the same X,
   ``torch.sparse.mm`` on the GCN-normalised CSR (the same function) and
   its bound.

The graphs carry the Graph500 SSSP weights (uniform on [2^-8, 1]); one
weighted layout per scale serves every phase (the BFS phases never read
the weights). The launch counts of each main path must be nonzero: the
four lane kernels over phases 4b and 5, the two packed kernels over phase
7b, the stored-weight SpMV over phase 8b, the stored-weight SpMM over
phases 9b and 9c, the GCN SpMM over phase 10b, each counted from zero.
The last lines are the kernel table, the card, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEMIRINGS = ("tropical", "real", "boolean", "selmax")
SCALE, EDGE_FACTOR, SMALL_SCALE = 20, 16, 14
# the whole run must end within 1200 s; phase 8b validates 64 SSSP trees
# only if that still ends by this mark, else the first 16; phase 9c the
# same by its own mark; both leave phase 10 its reserve
GCN_RESERVE_S = 60.0
VALIDATE_ALL_BY_S = 900.0 - GCN_RESERVE_S
VALIDATE_BATCH_BY_S = 1000.0 - GCN_RESERVE_S
KERNEL_INFO = {
    "slimsell_spmv": ("src/repro_torch/kernels/csrc/slimsell_spmv.cu",
                      "src/repro/kernels/slimsell_spmv.py:66"),
    "slimsell_spmv_wts": ("src/repro_torch/kernels/csrc/slimsell_spmv.cu",
                          "src/repro/kernels/slimsell_spmv.py:66"),
    "slimsell_spmm": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                      "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_spmm_wts": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                          "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_spmm_gcn": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                          "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_pull": ("src/repro_torch/kernels/csrc/slimsell_pull.cu",
                      "src/repro/kernels/slimsell_pull.py:53"),
    "slimsell_pull_mm": ("src/repro_torch/kernels/csrc/slimsell_pull_mm.cu",
                         "src/repro/kernels/slimsell_pull.py:155"),
    "slimsell_spmv_packed": (
        "src/repro_torch/kernels/csrc/slimsell_spmv_packed.cu",
        "src/repro/kernels/slimsell_packed.py:43"),
    "slimsell_spmm_packed": (
        "src/repro_torch/kernels/csrc/slimsell_spmm_packed.cu",
        "src/repro/kernels/slimsell_packed.py:134"),
}
LANE_KERNELS = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
                "slimsell_pull_mm")
PACKED_KERNELS = ("slimsell_spmv_packed", "slimsell_spmm_packed")
NF_KINDS = ("random", "all", "none")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def frontier(sr, shape, rng, device) -> torch.Tensor:
    """Integer-valued sweep operands: sums and minima stay exact."""
    if sr.name == "boolean":
        x = rng.integers(0, 2, size=shape).astype(np.int32)
    else:
        x = rng.integers(0, 4, size=shape).astype(np.float32)
        if sr.name == "tropical":
            x[rng.random(shape) < 0.5] = np.inf
        if sr.name == "selmax":
            x *= rng.integers(1, 1000, size=shape)
    return torch.from_numpy(x).to(device)


def not_final(kind, shape, rng, device) -> torch.Tensor:
    if kind == "random":
        return torch.from_numpy(rng.random(shape) < 0.6).to(device)
    return torch.full(shape, kind == "all", dtype=torch.bool, device=device)


def masks(tiled, rng, device) -> dict:
    T = tiled.n_tiles
    keep_chunk = torch.from_numpy(rng.random(tiled.n_chunks) < 0.6).to(device)
    random = torch.from_numpy(rng.random(T) < 0.5).to(device) \
        & keep_chunk[tiled.row_block.long()]
    return {"none_given": None,
            "all_kept": torch.ones(T, dtype=torch.bool, device=device),
            "none_kept": torch.zeros(T, dtype=torch.bool, device=device),
            "random": random}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    same = a == b  # equal infinities count as no error
    diff = (a.double() - b.double()).abs()
    return float(torch.where(same, 0.0, diff).max()) if a.numel() else 0.0


def tile_slots(tiled) -> torch.Tensor:
    """int64[T]: the slots of one row of each tile before its chunk's
    length cl, the ones a sweep reads in each row when it keeps the tile."""
    ptr = tiled.tile_ptr.long()
    rb = tiled.row_block.long()
    rank = torch.arange(tiled.n_tiles, device=ptr.device) - ptr[rb]
    return (tiled.cl.long()[rb] - rank * tiled.L).clamp(0, tiled.L)


def sssp_frontier(shape, finite, rng, device) -> torch.Tensor:
    """Float32 distances on a ``finite`` share of the vertices (of each
    column for an [n, B] shape), +inf on the rest."""
    x = rng.uniform(0.0, 8.0, shape).astype(np.float32)
    x[rng.random(shape) >= finite] = np.inf
    return torch.from_numpy(x).to(device)


def hmean(x) -> float:
    return float(1.0 / np.mean(1.0 / np.asarray(x)))


@contextlib.contextmanager
def plain_sweeps(engine, spmv_plain, spmm_plain, pull_plain, pull_mm_plain):
    """Route the engine's sweeps to the plain versions: the reference run."""
    names = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
             "slimsell_pull_mm")
    saved = [getattr(engine, n) for n in names]
    engine.slimsell_spmv = lambda sr, t, x, *, tile_mask=None: spmv_plain(sr, t, x, tile_mask)
    engine.slimsell_spmm = lambda sr, t, x, *, tile_mask=None: spmm_plain(sr, t, x, tile_mask)
    engine.slimsell_pull = lambda sr, t, x, *, row_mask, tile_mask=None: \
        pull_plain(sr, t, x, row_mask, tile_mask)
    engine.slimsell_pull_mm = lambda sr, t, x, *, row_mask, tile_mask=None: \
        pull_mm_plain(sr, t, x, row_mask, tile_mask)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(engine, n, fn)


def time_ms(fn, reps: int) -> float:
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


def check_equal(kern, got, want, errs, what):
    errs[kern] = max(errs[kern], max_abs_err(got, want))
    if not torch.equal(got, want):
        raise AssertionError(f"{kern} != plain: {what}")


def check_close(kern, got, want, errs, what, tol):
    """Float sums in another order: within rtol = atol = ``tol``, no NaN."""
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{kern}: NaN: {what}")
    err = max_abs_err(got, want)
    if errs is not None:
        errs[kern] = max(errs[kern], err)
    if not torch.allclose(got.double(), want.double(), rtol=tol, atol=tol):
        raise AssertionError(f"{kern}: not within {tol} of the reference: "
                             f"{what}; max abs err {err}")


def gcn_batch(csr, feat: torch.Tensor, tiled, device) -> dict:
    """A GCN batch of a graph: features, edge list, degrees, layout."""
    src = np.repeat(np.arange(csr.n, dtype=np.int32), np.diff(csr.indptr))
    edge_index = np.stack([src, csr.indices.astype(np.int32)])
    return {"node_feat": feat.to(device),
            "edge_index": torch.from_numpy(edge_index).to(device),
            "deg": torch.from_numpy(csr.deg.astype(np.int32)).to(device),
            "tiled": tiled}


def pull_work(tiled, ranks, nf, mask):
    """What the first-hit pull needs at this state, worked out from the
    plain version's hit ranks (int32[n, B], -1 for no hit): a pending
    (v, b) reads the kept slots of v's chunk through its hit tile, or all
    of them without a hit, and a row's cols are read once for all its
    columns. Returns a dict: cols slots read, operations, the slots all
    kept tiles of the pending rows hold, and for the chunk with the most
    tiles, the tiles it has and the tiles its block must load."""
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
    return {"slots_read": int(slots.amax(dim=1).sum()),
            "operations": 2 * int(slots.sum()),
            "slots_kept": int((kept * nf.any(dim=1, keepdim=True)).sum()),
            "longest_chunk_tiles": int(n_tiles[longest]),
            "longest_chunk_tiles_loaded": int(loaded[longest])}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
    from repro_torch.core import direction as dm
    from repro_torch.core import engine, packing, semiring
    from repro_torch.core.bfs import bfs, bfs_spec, packed_bfs_spec
    from repro_torch.core.formats import build_slimsell, storage_summary
    from repro_torch.core.multi_bfs import (multi_bfs_spec, multi_source_bfs,
                                            packed_multi_bfs_spec)
    from repro_torch.core.multi_sssp import multi_source_sssp, multi_sssp_spec
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.spmv import (pull_first_hits, pull_mm_plain,
                                       pull_plain, spmm_packed_plain,
                                       spmm_plain, spmv_packed_plain,
                                       spmv_plain)
    from repro_torch.core.sssp import (default_delta, sssp, sssp_spec,
                                       weight_views)
    from repro_torch.graph500 import (batch_teps, run_graph500,
                                      run_graph500_sssp, sample_roots,
                                      validate_bfs_tree, validate_sssp_tree)
    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.graphs.generators import (erdos_renyi, kronecker,
                                               with_random_weights)
    from repro_torch.models.gnn import _gcn_aggregate, gcn_forward, gcn_init

    def weighted_kronecker(scale):
        return with_random_weights(kronecker(scale, EDGE_FACTOR, seed=1),
                                   low=WEIGHT_LOW, high=WEIGHT_HIGH, seed=2)
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card} | torch: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build(ptxas_info=True)
    log(f"[2] built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # ---- 3: each kernel against its plain version, on the card
    rng = np.random.default_rng(0)
    small_csr = weighted_kronecker(SMALL_SCALE)
    small_host = build_slimsell(small_csr, C=8, L=128)
    small = small_host.to_torch(dev)
    errs = {k: 0.0 for k in KERNEL_INFO}
    n_cases = 0
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for mask_name, mask in masks(small, rng, dev).items():
            for B in (None, 1, 5, 64):
                shape = (small.n,) if B is None else (small.n, B)
                x = frontier(sr, shape, rng, dev)
                what = f"{name} B={B} mask={mask_name}"
                if B is None:
                    check_equal("slimsell_spmv", ops.spmv(sr, small, x, tile_mask=mask),
                                spmv_plain(sr, small, x, mask), errs, what)
                else:
                    check_equal("slimsell_spmm", ops.spmm(sr, small, x, tile_mask=mask),
                                spmm_plain(sr, small, x, mask), errs, what)
                n_cases += 1
                for kind in NF_KINDS:
                    nf = not_final(kind, shape, rng, dev)
                    if B is None:
                        check_equal("slimsell_pull",
                                    ops.pull(sr, small, x, nf, tile_mask=mask),
                                    pull_plain(sr, small, x, nf, mask), errs,
                                    f"{what} nf={kind}")
                    else:
                        check_equal("slimsell_pull_mm",
                                    ops.pull_mm(sr, small, x, nf, tile_mask=mask),
                                    pull_mm_plain(sr, small, x, nf, mask), errs,
                                    f"{what} nf={kind}")
                    n_cases += 1
    torch.cuda.synchronize()
    log(f"[3] kernels == plain on {n_cases} cases (scale {SMALL_SCALE}, "
        f"n={small.n}, tiles={small.n_tiles})")

    # ---- 4a: the kernel path against the plain path at scale 14
    small_roots = sample_roots(small_csr, 64)
    root0 = int(small_roots[0])
    paths = [("bfs", "push", "fused"), ("bfs", "pull", "fused"),
             ("bfs", "auto", "fused"), ("bfs", "auto", "hostloop"),
             ("multi", "push", "fused"), ("multi", "pull", "fused"),
             ("multi", "auto", "fused")]
    plain = (spmv_plain, spmm_plain, pull_plain, pull_mm_plain)
    for name in SEMIRINGS:
        for kind, direction, mode in paths:
            cfg = EngineConfig(direction=direction, mode=mode)
            if kind == "bfs":
                def run():
                    return bfs(small, root0, name, need_parents=True,
                               log_work=True, config=cfg, device=dev)
                fields = ("distances", "parents", "iterations", "work_log",
                          "directions")
            else:
                def run():
                    return multi_source_bfs(small, small_roots, name,
                                            need_parents=True, log_work=True,
                                            config=cfg, device=dev)
                fields = ("distances", "parents", "iterations", "work_log",
                          "pull_cols_log")
            with plain_sweeps(engine, *plain):
                before = ops.launch_counts()
                ref = run()
                if ops.launch_counts() != before:
                    raise AssertionError("the plain reference run launched a kernel")
            got = run()
            for f in fields:
                if not np.array_equal(getattr(ref, f), getattr(got, f)):
                    raise AssertionError(f"kernel path != plain path: {f} of "
                                         f"{kind} {name} {direction} {mode}")
    log(f"[4a] kernel path == plain path at scale {SMALL_SCALE} in 4 "
        f"semirings: {', '.join(' '.join(p) for p in paths)}")

    # ---- the main path at scale 20: phases 4b and 5, counted
    t0 = time.perf_counter()
    csr = weighted_kronecker(SCALE)
    t1 = time.perf_counter()
    host = build_slimsell(csr, C=8, L=128, sigma=csr.n)
    t2 = time.perf_counter()
    tiled = host.to_torch(dev)
    torch.cuda.synchronize()
    log(f"[4] scale {SCALE}: n={csr.n} nnz={csr.nnz} tiles={tiled.n_tiles} "
        f"chunks={tiled.n_chunks} K={tiled.inc_src.numel()} | generate "
        f"{t1 - t0:.1f} s, build_slimsell {t2 - t1:.1f} s, to device "
        f"{time.perf_counter() - t2:.1f} s")
    root = int(sample_roots(csr, 1)[0])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    auto_dirs = lane_boolean = None
    for direction, mode in (("push", "fused"), ("auto", "fused"),
                            ("auto", "hostloop")):
        cfg = EngineConfig(direction=direction, mode=mode)
        for name in SEMIRINGS if mode == "fused" else ("tropical",):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bfs(tiled, root, name, need_parents=True, log_work=True,
                      config=cfg, device=dev)
            dt = time.perf_counter() - t0
            validate_bfs_tree(csr, root, res.distances, res.parents)
            if (direction, mode, name) == ("auto", "fused", "tropical"):
                auto_dirs = res.directions
            if (direction, mode, name) == ("push", "fused", "boolean"):
                lane_boolean = res
            log(f"[4b] bfs {name} {direction} {mode}: root={root} "
                f"iterations={res.iterations} directions="
                f"{res.directions.tolist()} work_log={res.work_log.tolist()} "
                f"tiles={int(res.work_log.sum())} {dt * 1e3:.1f} ms valid tree")

    rep = run_graph500(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                       batch_size=64, semiring="tropical", csr=csr,
                       tiled=tiled, device=dev)
    if rep.validated != 64:
        raise AssertionError(f"graph500 validated {rep.validated} of 64 roots")
    log(f"[5] {rep.summary()} batch_s={rep.batch_seconds.tolist()}")
    log(f"[5] push hmean TEPS {rep.harmonic_mean_teps:.6e} on {card}")
    roots = rep.roots
    # the push batch's distances: what run_graph500 just validated against
    # the oracle, and what the other directions must equal
    push = multi_source_bfs(tiled, roots, "tropical", log_work=True, device=dev)
    log(f"[5] push work_log={push.work_log[0][:push.iterations[0]].tolist()}")
    batched = {}
    for direction in ("auto", "pull"):
        cfg = EngineConfig(direction=direction)
        rep_d = run_graph500(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                             batch_size=64, semiring="tropical", csr=csr,
                             tiled=tiled, config=cfg, validate=False,
                             device=dev)
        if not np.array_equal(rep_d.roots, roots):
            raise AssertionError("the batches sampled other roots")
        res = multi_source_bfs(tiled, roots, "tropical", need_parents=True,
                               log_work=True, config=cfg, device=dev)
        if not np.array_equal(res.distances, push.distances):
            raise AssertionError(f"{direction} batch distances != push batch")
        n_valid = 0
        for i, r in enumerate(roots):
            validate_bfs_tree(csr, int(r), res.distances[i], res.parents[i],
                              d_ref=push.distances[i])
            n_valid += 1
        it = int(res.iterations[0])
        batched[direction] = res
        # the timed batch ran with validate=False (its summary says
        # validated=0); this second call's trees are the ones validated
        log(f"[5] {rep_d.summary()} batch_s={rep_d.batch_seconds.tolist()}")
        log(f"[5] {direction} hmean TEPS {rep_d.harmonic_mean_teps:.6e} on "
            f"{card}; distances == push batch, {n_valid} of 64 trees "
            f"validated in a second call; "
            f"pull_cols_log={res.pull_cols_log[0][:it].tolist()} "
            f"work_log={res.work_log[0][:it].tolist()}")
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in LANE_KERNELS}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    log(f"[5] main-path launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 6: at the phase-5 shapes, each kernel against its plain version
    # (4 semirings x 4 masks), then timed with every tile kept
    g = np.random.default_rng(1)
    B = 64
    n_cases = 0
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for mask_name, mask in masks(tiled, g, dev).items():
            for kern, fn, plain_fn, shape in (
                    ("slimsell_spmv", ops.spmv, spmv_plain, (tiled.n,)),
                    ("slimsell_spmm", ops.spmm, spmm_plain, (tiled.n, B))):
                xt = frontier(sr, shape, g, dev)
                check_equal(kern, fn(sr, tiled, xt, tile_mask=mask),
                            plain_fn(sr, tiled, xt, mask), errs,
                            f"scale {SCALE}: {name} mask={mask_name}")
                n_cases += 1
    # the pull kernels at real pull states: the single-source BFS state just
    # before the first iteration auto runs as pull, and the batch's state
    # just before the first iteration most of auto's columns pull
    k_pull = 1 + int(np.argmax(auto_dirs == dm.PULL))
    plog = batched["auto"].pull_cols_log[0]
    k_batch = 1 + int(np.argmax(plog > B // 2)) if (plog > B // 2).any() \
        else k_pull
    states = {}
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for kern, spec, arg, k in (
                ("slimsell_pull", bfs_spec(name), root, k_pull),
                ("slimsell_pull_mm", multi_bfs_spec(name),
                 torch.from_numpy(roots), k_batch)):
            st = engine.run_fused(spec, tiled, arg, max_iters=k - 1,
                                  direction="pull").state
            xt, nf = spec.frontier(st, k), spec.not_final(st)
            mask = engine._pull_tile_mask(tiled, nf.any(dim=-1) if nf.ndim > 1 else nf)
            fn = ops.pull if kern == "slimsell_pull" else ops.pull_mm
            plain_fn = pull_plain if kern == "slimsell_pull" else pull_mm_plain
            check_equal(kern, fn(sr, tiled, xt, nf, tile_mask=mask),
                        plain_fn(sr, tiled, xt, nf, mask), errs,
                        f"real state {name} iteration {k}")
            n_cases += 1
            if name == "tropical":
                fbits = spec.source_bits(st, k).float()
                states[kern] = (xt, nf, mask, fbits, k)
    torch.cuda.synchronize()
    log(f"[6] kernels == plain on {n_cases} cases at scale {SCALE} "
        f"(SpMV, SpMM B={B}; pull at iteration {k_pull}, pull_mm B={B} at "
        f"iteration {k_batch})")
    tropical, real = semiring.get("tropical"), semiring.get("real")
    full = torch.ones(tiled.n_tiles, dtype=torch.bool, device=dev)
    x = frontier(tropical, (tiled.n,), g, dev)
    X = frontier(tropical, (tiled.n, B), g, dev)
    xr = frontier(real, (tiled.n,), g, dev)
    Xr = frontier(real, (tiled.n, B), g, dev)
    adj = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices.astype(np.int64)),
        torch.ones(csr.nnz), size=(csr.n, csr.n)).to(dev)
    for got, want in ((ops.spmv(real, tiled, xr), adj @ xr),
                      (ops.spmm(real, tiled, Xr), torch.sparse.mm(adj, Xr))):
        log(f"[6] real-semiring kernel vs library max_abs_err "
            f"{max_abs_err(got, want)}")
    # the bytes the function needs: each chunk's cols up to its length cl
    # (the slots past it are padding), tile_ptr, row_vertex, cl, the bool mask
    edges = int((tiled.cols >= 0).sum())
    index_bytes = 4 * (tiled.tile_ptr.numel() + tiled.row_vertex.numel()
                       + tiled.cl.numel()) + full.numel()
    layout_bytes = 4 * tiled.C * int(tiled.cl.sum(dtype=torch.int64)) \
        + index_bytes
    table = []

    def row(kern, ms, plain_ms, library_ms, moved, ops_needed,
            semiring_name="tropical", **extra):
        bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops_needed / F32_OPS_PER_S)
        source, replaces = KERNEL_INFO[kern]
        table.append({
            "name": kern, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": errs[kern], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S
            >= ops_needed / F32_OPS_PER_S else "operations",
            "library_ms": library_ms, "semiring": semiring_name,
            "bytes": moved,
            **extra})
        return bound_ms

    for kern, width, xt, xl, fn, plain_fn, lib in (
            ("slimsell_spmv", 1, x, xr, ops.spmv, spmv_plain,
             lambda: adj @ xr),
            ("slimsell_spmm", B, X, Xr, ops.spmm, spmm_plain,
             lambda: torch.sparse.mm(adj, Xr))):
        ms = time_ms(lambda: fn(tropical, tiled, xt, tile_mask=full), 20)
        ms_real = time_ms(lambda: fn(real, tiled, xl, tile_mask=full), 20)
        plain_ms = time_ms(lambda: plain_fn(tropical, tiled, xt, full), 3)
        library_ms = time_ms(lib, 20)
        moved = layout_bytes + 2 * 4 * tiled.n * width   # layout, x in, y out
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       2 * edges * width,                # edge value + min
                       ms_real=ms_real, batch=width,
                       library_call="torch.sparse.mm (real)" if width > 1
                       else "sparse CSR @ x (real)")
        log(f"[6] {kern} B={width}: kernel {ms:.4f} ms (real {ms_real:.4f}) "
            f"plain {plain_ms:.3f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({moved / 1e9:.3f} GB) on {card}")
    for kern, fn, plain_fn in (("slimsell_pull", ops.pull, pull_plain),
                               ("slimsell_pull_mm", ops.pull_mm, pull_mm_plain)):
        xt, nf, mask, fbits, k = states[kern]
        width = 1 if xt.ndim == 1 else xt.shape[1]
        ms = time_ms(lambda: fn(tropical, tiled, xt, nf, tile_mask=mask), 20)
        plain_ms = time_ms(lambda: plain_fn(tropical, tiled, xt, nf, mask), 3)
        lib = (lambda: adj @ fbits) if width == 1 \
            else (lambda: torch.sparse.mm(adj, fbits))
        library_ms = time_ms(lib, 20)
        nf2 = nf.reshape(tiled.n, width)
        _, ranks = pull_first_hits(tropical, tiled, xt.reshape(tiled.n, width),
                                   nf2, mask)
        work = pull_work(tiled, ranks, nf2, mask)
        # cols read through the hits, x in, nf in, y out, layout indices
        moved = 4 * work["slots_read"] + 4 * xt.numel() + nf.numel() \
            + 4 * xt.numel() + index_bytes
        pending = int(nf2.any(dim=1).sum())
        # the push sweep of the same iteration, for comparison
        push_fn = ops.spmv if width == 1 else ops.spmm
        push_mask = dm.push_tile_mask(tiled, fbits > 0)
        push_ms = time_ms(lambda: push_fn(tropical, tiled, xt,
                                          tile_mask=push_mask), 20)
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       work.pop("operations"), batch=width, iteration=k,
                       pending_rows=pending, tiles_kept=int(mask.sum()),
                       push_ms=push_ms, push_tiles=int(push_mask.sum()),
                       library_call=("torch.sparse.mm" if width > 1 else
                                     "sparse CSR @ x")
                       + " (real; full reduction, not the same function)",
                       **work)
        log(f"[6] {kern} B={width} at iteration {k}: kernel {ms:.4f} ms plain "
            f"{plain_ms:.3f} ms library (full reduction, not the same "
            f"function) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({moved / 1e9:.4f} GB) | push sweep of this iteration "
            f"{push_ms:.4f} ms over {int(push_mask.sum())} tiles | pending "
            f"rows {pending}, tiles kept {int(mask.sum())}, {work} on {card}")
    torch.cuda.synchronize()

    # ---- 7: SlimSell-B, the bit-packed boolean path
    boolean = semiring.get("boolean")
    # (a) scale 14: each packed kernel against its plain version, then the
    # packed path on the card against the packed path on the CPU
    g7 = np.random.default_rng(7)
    packed_masks = masks(small, g7, dev)
    keep_chunk = torch.from_numpy(g7.random(small.n_chunks) < 0.6).to(dev)
    packed_masks["whole_chunks"] = keep_chunk[small.row_block.long()]
    n_cases = 0
    for mask_name, mask in packed_masks.items():
        for width in (None, 1, 5, 33, 64, 97, 160):
            for density in (0.02, 0.5):
                shape = (small.n,) if width is None else (small.n, width)
                bits = torch.from_numpy(g7.random(shape) < density).to(dev)
                what = f"B={width} density={density} mask={mask_name}"
                if width is None:
                    xw = packing.pack_bits(bits)
                    check_equal("slimsell_spmv_packed",
                                ops.spmv_packed(small, xw, tile_mask=mask),
                                spmv_packed_plain(small, xw, mask), errs, what)
                else:
                    xw = packing.pack_bits(bits, axis=1)
                    check_equal("slimsell_spmm_packed",
                                ops.spmm_packed(small, xw, tile_mask=mask),
                                spmm_packed_plain(small, xw, mask), errs, what)
                n_cases += 1
    torch.cuda.synchronize()
    small_cpu = small_host.to_torch("cpu")
    for kind, mode in (("bfs", "fused"), ("bfs", "hostloop"),
                       ("multi", "fused"), ("multi", "hostloop")):
        cfg = EngineConfig(mode=mode)
        if kind == "bfs":
            def run(t, d):
                return bfs(t, root0, "boolean", packed=True, need_parents=True,
                           log_work=True, config=cfg, device=d)
            fields = ("distances", "parents", "iterations", "work_log",
                      "directions")
        else:
            def run(t, d):
                return multi_source_bfs(t, small_roots, "boolean", packed=True,
                                        need_parents=True, log_work=True,
                                        config=cfg, device=d)
            fields = ("distances", "parents", "iterations", "work_log")
        ref, got = run(small_cpu, "cpu"), run(small, dev)
        for f in fields:
            if not np.array_equal(getattr(ref, f), getattr(got, f)):
                raise AssertionError(f"packed {kind} {mode}: {f} on the card "
                                     "!= on the CPU")
    log(f"[7a] packed kernels == plain on {n_cases} cases; packed bfs and "
        f"multi_source_bfs ({small_roots.size} roots), fused and hostloop: "
        f"card == CPU at scale {SMALL_SCALE}")

    # (b) scale 20: the packed main path, its launches counted from zero
    ops.reset_launches()
    packed_bfs = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bfs(tiled, root, "boolean", packed=True, need_parents=True,
                  log_work=True, config=EngineConfig(mode=mode), device=dev)
        dt = time.perf_counter() - t0
        if res.iterations != lane_boolean.iterations or any(
                not np.array_equal(getattr(res, f), getattr(lane_boolean, f))
                for f in ("distances", "work_log")):
            raise AssertionError(f"packed bfs {mode} != lane-boolean push")
        validate_bfs_tree(csr, root, res.distances, res.parents,
                          d_ref=lane_boolean.distances)
        packed_bfs[mode] = res
        log(f"[7b] bfs boolean packed push {mode}: root={root} iterations="
            f"{res.iterations} work_log={res.work_log.tolist()} "
            f"{dt * 1e3:.1f} ms; == lane-boolean push (distances, "
            "iterations, work_log), valid DP-parent tree")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = multi_source_bfs(tiled, roots, "boolean", packed=True,
                          need_parents=True, device=dev)
    first_s = time.perf_counter() - t0
    if not np.array_equal(pk.distances, push.distances):
        raise AssertionError("packed batch distances != push batch")
    n_valid = 0
    for i, r in enumerate(roots):
        validate_bfs_tree(csr, int(r), pk.distances[i], pk.parents[i],
                          d_ref=push.distances[i])
        n_valid += 1
    pk_log = multi_source_bfs(tiled, roots, "boolean", packed=True,
                              log_work=True, device=dev)
    it = int(pk_log.iterations[0])
    if it != int(push.iterations[0]) or not np.array_equal(pk_log.work_log,
                                                           push.work_log):
        raise AssertionError("packed batch work log != push batch's")
    packed_launches = {k: v for k, v in ops.launch_counts().items()
                       if k in PACKED_KERNELS}
    if min(packed_launches.values()) == 0:
        raise AssertionError("a packed kernel never ran on the packed main "
                             f"path: {packed_launches}")
    launches.update(packed_launches)
    log(f"[7b] packed batch of the phase-5 roots: distances == push batch, "
        f"{n_valid} of 64 trees valid, work_log == push batch's "
        f"{pk_log.work_log[0][:it].tolist()}; first call {first_s:.4f} s; "
        f"packed main-path launches {packed_launches}")
    # push and packed batches in turns, with and without parents
    seconds = {(kind, p): [] for kind in ("push", "packed")
               for p in (True, False)}
    for order in (("push", "packed"), ("packed", "push")):
        for kind in order:
            for parents in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = multi_source_bfs(
                    tiled, roots, "tropical" if kind == "push" else "boolean",
                    packed=kind == "packed", need_parents=parents, device=dev)
                seconds[(kind, parents)].append(time.perf_counter() - t0)
                if not np.array_equal(res.distances, push.distances):
                    raise AssertionError(f"{kind} batch distances changed")
    for (kind, parents), ss in seconds.items():
        teps = [hmean(batch_teps(csr, push.distances, t)) for t in ss]
        log(f"[7b] {kind} batch {'with' if parents else 'without'} parents: "
            f"s={ss} hmean TEPS={teps} on {card}")
    # single-source lane-boolean and packed push in turns, fused and hostloop
    ms_bfs = {(kind, mode): [] for kind in ("lane", "packed")
              for mode in ("fused", "hostloop")}
    for order in (("lane", "packed"), ("packed", "lane")):
        for kind in order:
            for mode in ("fused", "hostloop"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = bfs(tiled, root, "boolean", packed=kind == "packed",
                          need_parents=True, log_work=True,
                          config=EngineConfig(mode=mode), device=dev)
                ms_bfs[(kind, mode)].append(1e3 * (time.perf_counter() - t0))
                if not np.array_equal(res.work_log, lane_boolean.work_log):
                    raise AssertionError(f"{kind} bfs {mode} work log changed")
    log(f"[7b] single-source boolean push, with parents, ms in turns: "
        + ", ".join(f"{kind} {mode} {v}" for (kind, mode), v in ms_bfs.items())
        + f" on {card}")

    # (c) each packed kernel at the real state of its iteration with the
    # most tiles: with that iteration's push mask, and with every tile kept
    slots = tile_slots(tiled) * tiled.C
    for kern, spec, arg, wl, width in (
            ("slimsell_spmv_packed", packed_bfs_spec(tiled.n), root,
             packed_bfs["fused"].work_log, None),
            ("slimsell_spmm_packed", packed_multi_bfs_spec(B),
             torch.from_numpy(roots), pk_log.work_log[0][:it], B)):
        k = 1 + int(np.argmax(wl))
        st = engine.run_fused(spec, tiled, arg, max_iters=k - 1).state
        xw, bits = spec.frontier(st, k), spec.source_bits(st, k)
        mask = dm.push_tile_mask(tiled, bits)
        fn = ops.spmv_packed if width is None else ops.spmm_packed
        plain_fn = spmv_packed_plain if width is None else spmm_packed_plain
        for m in (mask, full):
            check_equal(kern, fn(tiled, xw, tile_mask=m),
                        plain_fn(tiled, xw, m), errs,
                        f"scale {SCALE} real state, iteration {k}")
        n_kept = int(mask.sum())
        ms = time_ms(lambda: fn(tiled, xw, tile_mask=full), 20)
        masked_ms = time_ms(lambda: fn(tiled, xw, tile_mask=mask), 20)
        plain_ms = time_ms(lambda: plain_fn(tiled, xw, full), 3)
        # the lane kernel over the same frontier as int32 0/1 lanes
        xl = bits.to(torch.int32).contiguous()
        lane_fn = ops.spmv if width is None else ops.spmm
        lane_ms = time_ms(lambda: lane_fn(boolean, tiled, xl, tile_mask=full),
                          20)
        xr = bits.float()
        lib = (lambda: adj @ xr) if width is None \
            else (lambda: torch.sparse.mm(adj, xr))
        library_ms = time_ms(lib, 20)
        # cols up to cl + indices + x words in + y words out; a shift and
        # an OR per slot (SpMV) or one OR per slot and word (SpMM), integer
        # work counted against the float32 rate of the CUDA cores
        words = xw.numel()
        per_slot = 2 if width is None else xw.shape[1]
        moved = layout_bytes + 2 * 4 * words
        masked_moved = 4 * int(slots[mask].sum()) + index_bytes + 2 * 4 * words
        masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                    per_slot * edges / F32_OPS_PER_S)
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       per_slot * edges, semiring_name="boolean_packed",
                       batch=width or 1, iteration=k, tiles_kept=n_kept,
                       masked_ms=masked_ms, masked_bound_ms=masked_bound_ms,
                       lane_ms=lane_ms,
                       library_call=("torch.sparse.mm" if width else
                                     "sparse CSR @ x") + " (real, unpacked "
                       "frontier; not the same function)")
        log(f"[7c] {kern} B={width or 1} at iteration {k}: every tile kept "
            f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms lane boolean kernel "
            f"{lane_ms:.4f} ms library (not the same function) "
            f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({moved / 1e9:.4f} "
            f"GB) | iteration mask ({n_kept} tiles) kernel {masked_ms:.4f} ms "
            f"bound {masked_bound_ms:.4f} ms ({masked_moved / 1e9:.4f} GB) on "
            f"{card}")
    torch.cuda.synchronize()

    # (d) the paper's storage accounting at scale 20
    store = storage_summary(csr, C=8, L=128)
    log(f"[7d] storage in 32-bit cells (paper Table III) at scale {SCALE}: "
        f"{dataclasses.asdict(store)}; SlimSell / Sell-C-sigma "
        f"{store.slimsell_vs_sellcs:.4f}, SlimSell / AL "
        f"{store.slimsell_vs_al:.4f}; a packed frontier is "
        f"{packing.packed_words(csr.n)} words, a lane one {csr.n}")

    # ---- 8: weighted SSSP, the stored-weight (min-plus) kernel
    minplus = semiring.MINPLUS
    sssp_fields = ("distances", "parents", "sweeps", "buckets", "work_log",
                   "delta")
    # (a) scale 14: the kernel against its plain version, then sssp on the
    # card against sssp on the CPU
    g8 = np.random.default_rng(8)
    n_cases = 0
    light, heavy = weight_views(small.wts, default_delta(small))
    for view, w in (("full", small.wts), ("light", light), ("heavy", heavy)):
        for mask_name, mask in packed_masks.items():
            for kind, finite in (("all_inf", 0.0), ("sparse", 0.02),
                                 ("dense", 0.7)):
                x = sssp_frontier(small.n, finite, g8, dev)
                check_equal("slimsell_spmv_wts",
                            ops.spmv(minplus, small, x, tile_mask=mask,
                                     weights=w),
                            spmv_plain(minplus, small, x, mask, w), errs,
                            f"scale {SMALL_SCALE} {view} mask={mask_name} "
                            f"x={kind}")
                n_cases += 1
    torch.cuda.synchronize()
    runs = []
    for mode in ("fused", "hostloop"):
        for delta in (None, float("inf"), 0.05):
            kw = dict(delta=delta, need_parents=True, log_work=True,
                      config=EngineConfig(mode=mode))
            ref = sssp(small_cpu, root0, device="cpu", **kw)
            got = sssp(small, root0, device=dev, **kw)
            for f in sssp_fields:
                if not np.array_equal(getattr(ref, f), getattr(got, f)):
                    raise AssertionError(f"sssp {mode} delta={delta}: {f} on "
                                         "the card != on the CPU")
            runs.append(f"{mode} delta={got.delta:.6g} sweeps={got.sweeps} "
                        f"buckets={got.buckets}")
    log(f"[8a] stored-weight kernel == plain on {n_cases} cases; sssp card "
        f"== CPU at scale {SMALL_SCALE}, root {root0} (distances, parents, "
        f"sweeps, buckets, work_log): {'; '.join(runs)}")

    # (b) scale 20: the SSSP main path, its launches counted from zero
    ops.reset_launches()
    single = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sssp(tiled, root, need_parents=True, log_work=True,
                   config=EngineConfig(mode=mode), device=dev)
        single[mode] = (res, time.perf_counter() - t0)
    fused, hostloop = single["fused"][0], single["hostloop"][0]
    for f in sssp_fields:
        if not np.array_equal(getattr(fused, f), getattr(hostloop, f)):
            raise AssertionError(f"sssp at scale {SCALE}: {f} fused != "
                                 "hostloop")
    adj_w = csr_matrix((csr.weights, csr.indices, csr.indptr),
                       shape=(csr.n, csr.n))
    t0 = time.perf_counter()
    d_ref = dijkstra(adj_w, directed=True, indices=[root])[0]
    scipy_one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    validate_sssp_tree(csr, root, fused.distances, fused.parents, d_ref=d_ref)
    validate_one_s = time.perf_counter() - t0
    for mode, (res, dt) in single.items():
        log(f"[8b] sssp {mode}: root={root} delta={res.delta:.6g} "
            f"sweeps={res.sweeps} buckets={res.buckets} "
            f"tiles={int(res.work_log.sum())} {dt * 1e3:.1f} ms")
    log(f"[8b] fused == hostloop (distances, parents, sweeps, buckets, "
        f"work_log); distances == scipy dijkstra ({scipy_one_s:.1f} s), tree "
        f"valid ({validate_one_s:.2f} s); "
        f"work_log={fused.work_log.tolist()}")
    rep = run_graph500_sssp(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                            csr=csr, tiled=tiled, validate=False, device=dev)
    if not np.array_equal(rep.roots, roots):
        raise AssertionError("the SSSP harness sampled other roots")
    log(f"[8b] {rep.summary()}")
    log(f"[8b] sssp hmean TEPS {rep.harmonic_mean_teps:.6e} (per root "
        f"{rep.teps.min():.4e}..{rep.teps.max():.4e}) on {card}; per root "
        f"sweeps={rep.sweeps.tolist()} buckets={rep.buckets.tolist()}")
    # the timed run did not validate (its summary says validated=0): a
    # second pass gives the trees, with the same schedule
    trees = []
    for i, r in enumerate(rep.roots):
        res = sssp(tiled, int(r), need_parents=True, device=dev)
        if (res.sweeps, res.buckets) != (rep.sweeps[i], rep.buckets[i]):
            raise AssertionError(f"sssp root {r}: another schedule on a "
                                 "second call")
        trees.append(res)
    wts_launches = ops.launch_counts()["slimsell_spmv_wts"]
    if wts_launches == 0:
        raise AssertionError("the stored-weight kernel never ran on the SSSP "
                             "main path")
    launches["slimsell_spmv_wts"] = wts_launches
    projected = time.perf_counter() - t_start \
        + 64 * (scipy_one_s + validate_one_s)
    n_check = 64 if projected < VALIDATE_ALL_BY_S else 16
    t0 = time.perf_counter()
    d_refs = dijkstra(adj_w, directed=True, indices=rep.roots[:n_check])
    for i in range(n_check):
        validate_sssp_tree(csr, int(rep.roots[i]), trees[i].distances,
                           trees[i].parents, d_ref=d_refs[i])
    log(f"[8b] {n_check} of 64 SSSP trees validated (distances == one scipy "
        f"dijkstra call over {n_check} roots, parents tight) in "
        f"{time.perf_counter() - t0:.1f} s (projected end with all 64: "
        f"{projected:.0f} s of the run); main-path launches "
        f"slimsell_spmv_wts={wts_launches}")

    # (c) the kernel at the real state of the sweep with the most tiles
    k = 1 + int(np.argmax(fused.work_log))
    spec = sssp_spec(tiled, fused.delta)
    st = engine.run_fused(spec, tiled, root, max_iters=k - 1).state
    x, w = spec.frontier(st, k), spec.weights(st)
    mask = dm.push_tile_mask(tiled, spec.source_bits(st, k))
    n_kept = int(mask.sum())
    if n_kept != int(fused.work_log[k - 1]):
        raise AssertionError("the rebuilt state is not the run's")
    for m in (mask, full):
        check_equal("slimsell_spmv_wts",
                    ops.spmv(minplus, tiled, x, tile_mask=m, weights=w),
                    spmv_plain(minplus, tiled, x, m, w), errs,
                    f"scale {SCALE} real state, sweep {k}")
    ms = time_ms(lambda: ops.spmv(minplus, tiled, x, tile_mask=full,
                                  weights=w), 20)
    masked_ms = time_ms(lambda: ops.spmv(minplus, tiled, x, tile_mask=mask,
                                         weights=w), 20)
    plain_ms = time_ms(lambda: spmv_plain(minplus, tiled, x, full, w), 3)
    implicit_ms = time_ms(lambda: ops.spmv(tropical, tiled, x, tile_mask=full),
                          20)
    adj_wt = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.weights), size=(csr.n, csr.n)).to(dev)
    x_fin = torch.where(torch.isfinite(x), x, 0.0)[:, None]
    library_ms = time_ms(lambda: torch.sparse.mm(adj_wt, x_fin), 20)
    # cols and wts up to cl, the indices, x in, y out; an add and a min per
    # edge against the float32 rate
    wts_bytes = layout_bytes - index_bytes
    moved = layout_bytes + wts_bytes + 2 * 4 * tiled.n
    masked_moved = 8 * int(slots[mask].sum()) + index_bytes + 2 * 4 * tiled.n
    masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                2 * edges / F32_OPS_PER_S)
    bound_ms = row("slimsell_spmv_wts", ms, plain_ms, library_ms, moved,
                   2 * edges, semiring_name="minplus", batch=1, sweep=k,
                   phase=("light", "heavy")[st["phase"]], tiles_kept=n_kept,
                   masked_ms=masked_ms, masked_bound_ms=masked_bound_ms,
                   implicit_ms=implicit_ms,
                   library_call="torch.sparse.mm (real, the same weights; "
                   "not the same function)")
    log(f"[8c] slimsell_spmv_wts at sweep {k} ({('light', 'heavy')[st['phase']]}"
        f" phase): every tile kept kernel {ms:.4f} ms plain {plain_ms:.3f} ms "
        f"implicit-value SpMV {implicit_ms:.4f} ms library (not the same "
        f"function) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({moved / 1e9:.4f} GB) | sweep mask ({n_kept} tiles) kernel "
        f"{masked_ms:.4f} ms bound {masked_bound_ms:.4f} ms "
        f"({masked_moved / 1e9:.4f} GB) on {card}")
    torch.cuda.synchronize()

    # ---- 9: batched multi-source SSSP, the stored-weight (min-plus) SpMM
    t9 = time.perf_counter()
    # (a) scale 14: the kernel against its plain version, then
    # multi_source_sssp on the card against the same on the CPU
    g9 = np.random.default_rng(9)
    n_cases = 0
    poisoned = torch.where(small.cols < 0, -1000.0, small.wts)
    for mask_name, mask in packed_masks.items():
        for width in (1, 5, 33, 64, 97, 160):
            for kind, finite in (("sparse", 0.02), ("dense", 0.7)):
                X = sssp_frontier((small.n, width), finite, g9, dev)
                want = spmm_plain(minplus, small, X, mask, small.wts)
                for wname, w in (("wts", small.wts), ("poisoned", poisoned)):
                    check_equal("slimsell_spmm_wts",
                                ops.spmm(minplus, small, X, tile_mask=mask,
                                         weights=w), want, errs,
                                f"scale {SMALL_SCALE} B={width} "
                                f"mask={mask_name} x={kind} {wname}")
                    n_cases += 1
    torch.cuda.synchronize()
    msssp_fields = ("distances", "parents", "sweeps", "buckets", "iterations",
                    "work_log", "delta")
    runs = []
    for mode in ("fused", "hostloop"):
        kw = dict(need_parents=True, log_work=True,
                  config=EngineConfig(mode=mode))
        ref = multi_source_sssp(small_cpu, small_roots[:16], device="cpu", **kw)
        got = multi_source_sssp(small, small_roots[:16], device=dev, **kw)
        for f in msssp_fields:
            if not np.array_equal(getattr(ref, f), getattr(got, f)):
                raise AssertionError(f"multi_source_sssp {mode}: {f} on the "
                                     "card != on the CPU")
        runs.append(f"{mode} iterations={got.iterations.tolist()} "
                    f"sweeps={got.sweeps.tolist()}")
    log(f"[9a] stored-weight SpMM kernel == plain on {n_cases} cases; "
        f"multi_source_sssp card == CPU at scale {SMALL_SCALE}, 16 roots "
        f"(distances, parents, sweeps, buckets, iterations, work_log): "
        f"{'; '.join(runs)}")

    # (b) scale 20: the batched SSSP main path, its launches counted from
    # zero over (b) and (c)
    ops.reset_launches()
    batch_runs = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multi_source_sssp(tiled, roots, need_parents=True, log_work=True,
                                config=EngineConfig(mode=mode), device=dev)
        batch_runs[mode] = (res, time.perf_counter() - t0)
    mf, mh = batch_runs["fused"][0], batch_runs["hostloop"][0]
    it = int(mf.iterations[0])
    for f in ("distances", "parents", "sweeps", "buckets", "iterations",
              "delta"):
        if not np.array_equal(getattr(mf, f), getattr(mh, f)):
            raise AssertionError(f"multi_source_sssp at scale {SCALE}: {f} "
                                 "fused != hostloop")
    if not np.array_equal(mf.work_log[0][:it], mh.work_log[0]):
        raise AssertionError("multi_source_sssp work log fused != hostloop")
    if mf.delta != fused.delta:
        raise AssertionError("the batch took another delta than phase 8b")
    for i, r in enumerate(roots):
        t = trees[i]
        if not (np.array_equal(mf.distances[i], t.distances)
                and np.array_equal(mf.parents[i], t.parents)
                and (mf.sweeps[i], mf.buckets[i]) == (t.sweeps, t.buckets)):
            raise AssertionError(f"multi_source_sssp row {i} (root {r}) != "
                                 "the per-root sssp")
    for mode, (res, dt) in batch_runs.items():
        log(f"[9b] multi_source_sssp {mode}: 64 roots, B=64, delta="
            f"{res.delta:.6g} iterations={int(res.iterations[0])} "
            f"{dt:.4f} s with parents")
    log(f"[9b] fused == hostloop (distances, parents, sweeps, buckets, "
        f"iterations, work_log); every row == phase 8b's per-root sssp "
        f"(distances, parents, sweeps, buckets); sweeps per root "
        f"{int(mf.sweeps.min())}..{int(mf.sweeps.max())}, batch iterations "
        f"{it}; work_log={mf.work_log[0][:it].tolist()}")

    # (c) the batched Graph500 SSSP harness, with and without parents
    for parents in (True, False):
        t0 = time.perf_counter()
        rep9 = run_graph500_sssp(scale=SCALE, edge_factor=EDGE_FACTOR,
                                 n_roots=64, batched=True, batch_size=64,
                                 csr=csr, tiled=tiled, validate=False,
                                 need_parents=parents, device=dev)
        call_s = time.perf_counter() - t0
        if not (np.array_equal(rep9.roots, roots)
                and np.array_equal(rep9.sweeps, rep.sweeps)
                and np.array_equal(rep9.buckets, rep.buckets)):
            raise AssertionError("the batched SSSP harness: other roots, "
                                 "sweeps or buckets than the per-root one")
        log(f"[9c] {rep9.summary()} ({'with' if parents else 'without'} "
            f"parents)")
        log(f"[9c] batched sssp hmean TEPS {rep9.harmonic_mean_teps:.6e} "
            f"{'with' if parents else 'without'} parents (harness call "
            f"{call_s:.4f} s; per-root harness, phase 8b: "
            f"{rep.harmonic_mean_teps:.6e}) on {card}")
    msssp_launches = ops.launch_counts()["slimsell_spmm_wts"]
    if msssp_launches == 0:
        raise AssertionError("the stored-weight SpMM never ran on the "
                             "batched SSSP main path")
    launches["slimsell_spmm_wts"] = msssp_launches
    t0 = time.perf_counter()
    validate_sssp_tree(csr, int(roots[0]), mf.distances[0], mf.parents[0],
                       d_ref=trees[0].distances)
    one_s = time.perf_counter() - t0
    n_check = 64 if time.perf_counter() - t_start + 64 * one_s \
        < VALIDATE_BATCH_BY_S else 16
    for i in range(n_check):
        validate_sssp_tree(csr, int(roots[i]), mf.distances[i], mf.parents[i],
                           d_ref=trees[i].distances)
    log(f"[9c] {n_check} of 64 batched SSSP trees validated against the "
        f"per-root distances in {time.perf_counter() - t0:.1f} s; main-path "
        f"launches slimsell_spmm_wts={msssp_launches} (9b and 9c)")

    # (d) the kernel at the real state of the batch's sweep with the most
    # tiles: with that sweep's mask and with every tile kept
    k = 1 + int(np.argmax(mf.work_log[0][:it]))
    spec = multi_sssp_spec(tiled, mf.delta)
    st = engine.run_fused(spec, tiled, torch.from_numpy(roots),
                          max_iters=k - 1).state
    X = spec.frontier(st, k)
    mask = dm.push_tile_mask(tiled, spec.source_bits(st, k))
    n_kept = int(mask.sum())
    if n_kept != int(mf.work_log[0][k - 1]):
        raise AssertionError("the rebuilt batch state is not the run's")
    for m in (mask, full):
        check_equal("slimsell_spmm_wts",
                    ops.spmm(minplus, tiled, X, tile_mask=m, weights=tiled.wts),
                    spmm_plain(minplus, tiled, X, m, tiled.wts), errs,
                    f"scale {SCALE} real batch state, sweep {k}")
    log(f"[9a] stored-weight SpMM kernel == plain at scale {SCALE}, B={B}, "
        f"the batch's sweep {k} ({n_kept} tiles): with its mask and with "
        f"every tile kept")
    ms = time_ms(lambda: ops.spmm(minplus, tiled, X, tile_mask=full,
                                  weights=tiled.wts), 20)
    masked_ms = time_ms(lambda: ops.spmm(minplus, tiled, X, tile_mask=mask,
                                         weights=tiled.wts), 20)
    plain_ms = time_ms(lambda: spmm_plain(minplus, tiled, X, full, tiled.wts),
                       3)
    implicit_ms = time_ms(lambda: ops.spmm(tropical, tiled, X, tile_mask=full),
                          20)
    X_fin = torch.where(torch.isfinite(X), X, 0.0)
    library_ms = time_ms(lambda: torch.sparse.mm(adj_wt, X_fin), 20)
    phases = st["phase"]
    # cols and wts up to cl, the indices, X in, Y out; an add and a min per
    # edge and column against the float32 rate
    moved = layout_bytes + wts_bytes + 2 * 4 * tiled.n * B
    masked_moved = 8 * int(slots[mask].sum()) + index_bytes \
        + 2 * 4 * tiled.n * B
    masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                2 * edges * B / F32_OPS_PER_S)
    bound_ms = row("slimsell_spmm_wts", ms, plain_ms, library_ms, moved,
                   2 * edges * B, semiring_name="minplus", batch=B, sweep=k,
                   light_columns=int((phases == 0).sum()),
                   tiles_kept=n_kept, masked_ms=masked_ms,
                   masked_bound_ms=masked_bound_ms, implicit_ms=implicit_ms,
                   library_call="torch.sparse.mm (real, the same weights; "
                   "not the same function)")
    log(f"[9d] slimsell_spmm_wts B={B} at sweep {k} "
        f"({int((phases == 0).sum())} columns light): every tile kept kernel "
        f"{ms:.4f} ms plain {plain_ms:.3f} ms implicit-value SpMM "
        f"{implicit_ms:.4f} ms library (not the same function) "
        f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({moved / 1e9:.4f} GB) "
        f"| sweep mask ({n_kept} tiles) kernel {masked_ms:.4f} ms bound "
        f"{masked_bound_ms:.4f} ms ({masked_moved / 1e9:.4f} GB) on {card}")
    torch.cuda.synchronize()
    log(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 10: GCN inference on the SlimSell-W aggregation (kernel 2g)
    t10 = time.perf_counter()
    # GCN is float32 end to end, as in the JAX package: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gcn_cfg = make_config()
    slim_cfg = dataclasses.replace(gcn_cfg, aggregation="slimsell")
    seg_cfg = dataclasses.replace(gcn_cfg, aggregation="segment")
    # (a) the kernel against its plain version, then the card against the CPU
    g10 = np.random.default_rng(10)
    cora_csr = erdos_renyi(2708, 3.9, seed=10)
    cora_host = build_slimsell(cora_csr, C=8, L=16)
    cora = cora_host.to_torch(dev)
    gcn_layouts = {
        "cora-shape ER C=8 L=16": cora,
        f"kronecker({SMALL_SCALE}) C=8 L=128": small,
        f"kronecker({SMALL_SCALE}) C=8 L=16":
            build_slimsell(small_csr, C=8, L=16).to_torch(dev)}
    n_cases = 0
    for lname, t in gcn_layouts.items():
        deg_t = t.deg.float()
        gmasks = masks(t, g10, dev)
        keep_chunk = torch.from_numpy(g10.random(t.n_chunks) < 0.6).to(dev)
        gmasks["whole_chunks"] = keep_chunk[t.row_block.long()]
        for mask_name, mask in gmasks.items():
            for width in (1, 5, 16, 33, 64, 160):
                X = torch.from_numpy(g10.standard_normal(
                    (t.n, width)).astype(np.float32)).to(dev)
                check_close("slimsell_spmm_gcn",
                            ops.spmm(real, t, X, tile_mask=mask, deg=deg_t),
                            spmm_plain(real, t, X, mask, deg=deg_t), errs,
                            f"{lname} B={width} mask={mask_name}", 1e-5)
                n_cases += 1
    torch.cuda.synchronize()
    cpu_params = gcn_init(gcn_cfg, generator=torch.Generator().manual_seed(10),
                          device="cpu")
    dev_params = {"w": [w.to(dev) for w in cpu_params["w"]]}
    card_cpu = []
    for gname, gcsr, ghost, gtiled in (
            ("cora-shape ER", cora_csr, cora_host, cora),
            (f"kronecker({SMALL_SCALE})", small_csr, small_host, small)):
        feat = torch.from_numpy(g10.standard_normal(
            (gcsr.n, gcn_cfg.d_in)).astype(np.float32))
        cpu_batch = gcn_batch(gcsr, feat, ghost.to_torch("cpu"), "cpu")
        dev_batch = gcn_batch(gcsr, feat, gtiled, dev)
        for cfg in (seg_cfg, slim_cfg):
            with torch.inference_mode():
                want = gcn_forward(cpu_params, cpu_batch, cfg, device="cpu")
                got = gcn_forward(dev_params, dev_batch, cfg, device=dev)
            check_close("gcn_forward", got.cpu(), want, None,
                        f"{gname} {cfg.aggregation} card vs CPU", 1e-4)
            card_cpu.append(f"{gname} {cfg.aggregation} "
                            f"{max_abs_err(got.cpu(), want):.3e}")
    log(f"[10a] slimsell_spmm_gcn within 1e-5 of plain, no NaN, on {n_cases} "
        f"cases ({', '.join(gcn_layouts)}; B=1/5/16/33/64/160 x 5 masks); "
        f"gcn_forward at d_in {gcn_cfg.d_in} card == CPU within 1e-4, max abs "
        f"err: {'; '.join(card_cpu)}")

    # (b) the GCN main path at scale 20: three requests, counted from zero
    ops.reset_launches()
    feat = torch.randn((tiled.n, gcn_cfg.d_in),
                       generator=torch.Generator(device=dev).manual_seed(10),
                       device=dev)
    params = gcn_init(gcn_cfg, generator=torch.Generator().manual_seed(11),
                      device=dev)
    batch = gcn_batch(csr, feat, tiled, dev)
    answers = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = gcn_forward(params, batch, slim_cfg)
        torch.cuda.synchronize()
        answers.append((y, time.perf_counter() - t0))
    y_slim = answers[0][0]
    if y_slim.shape != (tiled.n, gcn_cfg.n_classes) \
            or not torch.isfinite(y_slim).all():
        raise AssertionError(f"GCN logits: shape {tuple(y_slim.shape)}, or "
                             "not finite")
    if not all(torch.equal(y, y_slim) for y, _ in answers):
        raise AssertionError("the three GCN requests gave different logits")
    with torch.inference_mode():
        y_seg = gcn_forward(params, batch, seg_cfg)
    check_close("gcn_forward", y_slim, y_seg, None,
                f"slimsell vs segment at scale {SCALE}", 1e-3)
    seg_err = max_abs_err(y_slim, y_seg)
    fwd = {"slimsell": [], "segment": []}
    for _ in range(5):
        for name, cfg in (("slimsell", slim_cfg), ("segment", seg_cfg)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                gcn_forward(params, batch, cfg)
            torch.cuda.synchronize()
            fwd[name].append(time.perf_counter() - t0)
    gcn_launches = ops.launch_counts()["slimsell_spmm_gcn"]
    if gcn_launches != 2 * (len(answers) + len(fwd["slimsell"])):
        raise AssertionError(f"slimsell_spmm_gcn launched {gcn_launches} times "
                             f"over {len(answers) + 5} SlimSell forwards")
    launches["slimsell_spmm_gcn"] = gcn_launches
    log(f"[10b] gcn-cora at scale {SCALE} (n={tiled.n}, d_in "
        f"{gcn_cfg.d_in}, features {feat.numel() * 4 / 1e9:.2f} GB): 3 "
        f"requests {[round(dt, 6) for _, dt in answers]} s, bit-equal to "
        f"each other; slimsell == segment within 1e-3 (max abs err "
        f"{seg_err:.3e}, logits max abs {float(y_seg.abs().max()):.3e}); "
        f"main-path launches slimsell_spmm_gcn={gcn_launches}")
    # where a warm forward's time goes: x @ w (two layers) and the two
    # aggregations (each layer's input is [n, 16])
    w0, w1 = params["w"]
    with torch.inference_mode():
        xw = feat @ w0
        h = torch.relu(gcn_forward({"w": [w0]}, batch, slim_cfg))
        mm_ms = time_ms(lambda: feat @ w0, 5) + time_ms(lambda: h @ w1, 5)
        agg_ms = {name: 2 * time_ms(
            lambda: _gcn_aggregate(xw, batch, tiled.n, name), 5)
            for name in ("slimsell", "segment")}
    for name in ("slimsell", "segment"):
        med = float(np.median(fwd[name]))
        log(f"[10b] {name} forward, warm, median of 5: {med:.6f} s "
            f"({fwd[name]}), {tiled.n / med:.6e} nodes/s; x @ w "
            f"{mm_ms:.4f} ms ({mm_ms / 1e3 / med:.4f}), aggregation "
            f"{agg_ms[name]:.4f} ms ({agg_ms[name] / 1e3 / med:.4f}) on {card}")
    del feat, batch, xw, h, answers, y, y_slim, y_seg
    torch.cuda.empty_cache()

    # (c) the kernel alone at d = 16, every tile kept
    degf = tiled.deg.float()
    X16 = torch.from_numpy(g10.standard_normal((tiled.n, 16)).astype(
        np.float32)).to(dev)
    got = ops.spmm(real, tiled, X16, tile_mask=full, deg=degf)
    want32 = spmm_plain(real, tiled, X16, full, deg=degf)
    check_close("slimsell_spmm_gcn", got, want32, errs,
                f"scale {SCALE} B=16 every tile kept", 1e-5)
    want64 = spmm_plain(real, tiled, X16.double(), full, deg=degf.double())
    check_close("slimsell_spmm_gcn", got, want64, None,
                f"scale {SCALE} B=16 against float64", 1e-4)
    err64 = max_abs_err(got, want64)
    plain_err64 = max_abs_err(want32, want64)
    del want64
    norm = torch.rsqrt(degf.clamp_min(1.0)).cpu().numpy()
    rows = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    adj_gcn = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(norm[rows] * norm[csr.indices]),
        size=(csr.n, csr.n)).to(dev)
    lib_err = max_abs_err(got, torch.sparse.mm(adj_gcn, X16))
    ms = time_ms(lambda: ops.spmm(real, tiled, X16, tile_mask=full,
                                  deg=degf), 20)
    plain_ms = time_ms(lambda: spmm_plain(real, tiled, X16, full, deg=degf), 3)
    implicit_ms = time_ms(lambda: ops.spmm(real, tiled, X16, tile_mask=full),
                          20)
    library_ms = time_ms(lambda: torch.sparse.mm(adj_gcn, X16), 20)
    # cols up to cl, the indices and mask, deg, X in, Y out; per edge one
    # weight product, and a multiply and an add per column; per vertex a
    # clamp, a root and a division
    moved = layout_bytes + 4 * tiled.n + 2 * 4 * tiled.n * 16
    bound_ms = row("slimsell_spmm_gcn", ms, plain_ms, library_ms, moved,
                   2 * edges * 16 + edges + 3 * tiled.n, semiring_name="real",
                   batch=16, implicit_ms=implicit_ms,
                   max_abs_err_vs_float64=err64,
                   library_call="torch.sparse.mm on the GCN-normalised CSR "
                   "(real; the same function)")
    log(f"[10c] slimsell_spmm_gcn B=16, every tile kept: kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms implicit real SpMM {implicit_ms:.4f} ms "
        f"library (the same function) {library_ms:.4f} ms bound "
        f"{bound_ms:.4f} ms ({moved / 1e9:.4f} GB) on {card}; max abs err "
        f"vs float64: kernel {err64:.3e}, float32 plain {plain_err64:.3e}, "
        f"vs library {lib_err:.3e}")
    torch.cuda.synchronize()
    log(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s (reserve "
        f"{GCN_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f} "
        f"s so far")

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
