#!/usr/bin/env python3
"""Drive the PyTorch port of SlimSell BFS on one CUDA card, end to end.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, each of which must pass (any failure ends the run with a nonzero
exit and no result line):

1. the card's name and power limit;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain PyTorch version on the card, exactly
   (all values are integers or +-inf): 4 semirings x {SpMV, SpMM B=1/5/64}
   x 4 tile masks (none given, all kept, none kept, random with whole
   chunks dropped) on a scale-14 Kronecker graph;
4. single-source BFS at scale 20 through the SpMV kernel in all four
   semirings, each tree validated (Graph500 §5.2); before that, the kernel
   path against the plain path at scale 14 (single- and multi-source);
5. the Graph500 harness, 64 roots in one batch of 64, through the SpMM
   kernel on the same scale-20 graph: all 64 trees validated;
6. at the phase-5 shapes, every kernel against its plain version again
   (4 semirings x 4 masks, SpMV and SpMM B=64), then each kernel timed
   with every tile kept, beside its plain version, a library call and
   its bytes bound.

The launch counts of the main path (phases 4-5 at scale 20) must be
nonzero for both kernels. The last lines are the kernel table, the card,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
KERNEL_INFO = {
    "slimsell_spmv": ("src/repro_torch/kernels/csrc/slimsell_spmv.cu",
                      "src/repro/kernels/slimsell_spmv.py:66"),
    "slimsell_spmm": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                      "src/repro/kernels/slimsell_spmm.py:44"),
}


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


@contextlib.contextmanager
def plain_sweeps(engine, spmv_plain, spmm_plain):
    """Route the engine's sweeps to the plain versions: the reference run."""
    saved = engine.slimsell_spmv, engine.slimsell_spmm
    engine.slimsell_spmv = lambda sr, t, x, *, tile_mask=None: spmv_plain(sr, t, x, tile_mask)
    engine.slimsell_spmm = lambda sr, t, x, *, tile_mask=None: spmm_plain(sr, t, x, tile_mask)
    try:
        yield
    finally:
        engine.slimsell_spmv, engine.slimsell_spmm = saved


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from repro_torch.core import engine, semiring
    from repro_torch.core.bfs import bfs
    from repro_torch.core.formats import build_slimsell
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.spmv import spmm_plain, spmv_plain
    from repro_torch.graph500 import run_graph500, sample_roots, validate_bfs_tree
    from repro_torch.graphs.generators import kronecker
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
    small_csr = kronecker(SMALL_SCALE, EDGE_FACTOR, seed=1)
    small = build_slimsell(small_csr, C=8, L=128).to_torch(dev)
    errs = {"slimsell_spmv": 0.0, "slimsell_spmm": 0.0}
    n_cases = 0
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for mask_name, mask in masks(small, rng, dev).items():
            for B in (None, 1, 5, 64):
                shape = (small.n,) if B is None else (small.n, B)
                x = frontier(sr, shape, rng, dev)
                if B is None:
                    got, want, kern = ops.spmv(sr, small, x, tile_mask=mask), \
                        spmv_plain(sr, small, x, mask), "slimsell_spmv"
                else:
                    got, want, kern = ops.spmm(sr, small, x, tile_mask=mask), \
                        spmm_plain(sr, small, x, mask), "slimsell_spmm"
                errs[kern] = max(errs[kern], max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"{kern} != plain: {name} B={B} "
                                         f"mask={mask_name}")
                n_cases += 1
    torch.cuda.synchronize()
    log(f"[3] kernels == plain on {n_cases} cases (scale {SMALL_SCALE}, "
        f"n={small.n}, tiles={small.n_tiles})")

    # ---- 4a: the kernel path against the plain path at scale 14
    small_roots = sample_roots(small_csr, 64)
    for name in SEMIRINGS:
        with plain_sweeps(engine, spmv_plain, spmm_plain):
            before = ops.launch_counts()
            ref = bfs(small, int(small_roots[0]), name, need_parents=True,
                      log_work=True, device=dev)
            ref_m = multi_source_bfs(small, small_roots, name, need_parents=True,
                                     log_work=True, device=dev)
            if ops.launch_counts() != before:
                raise AssertionError("the plain reference run launched a kernel")
        got = bfs(small, int(small_roots[0]), name, need_parents=True,
                  log_work=True, device=dev)
        got_m = multi_source_bfs(small, small_roots, name, need_parents=True,
                                 log_work=True, device=dev)
        for a, b in ((ref.distances, got.distances), (ref.parents, got.parents),
                     (ref.work_log, got.work_log),
                     (ref_m.distances, got_m.distances),
                     (ref_m.parents, got_m.parents),
                     (ref_m.iterations, got_m.iterations),
                     (ref_m.work_log, got_m.work_log)):
            if not np.array_equal(a, b):
                raise AssertionError(f"kernel path != plain path ({name})")
        if ref.iterations != got.iterations:
            raise AssertionError(f"iterations differ ({name})")
    log(f"[4a] kernel path == plain path at scale {SMALL_SCALE} "
        "(bfs and 64-root multi_source_bfs, 4 semirings)")

    # ---- the main path at scale 20: phases 4b and 5, counted
    t0 = time.perf_counter()
    csr = kronecker(SCALE, EDGE_FACTOR, seed=1)
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
    for name in SEMIRINGS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bfs(tiled, root, name, need_parents=True, log_work=True,
                  device=dev)
        dt = time.perf_counter() - t0
        validate_bfs_tree(csr, root, res.distances, res.parents)
        log(f"[4b] bfs {name}: root={root} iterations={res.iterations} "
            f"work_log={res.work_log.tolist()} {dt * 1e3:.1f} ms valid tree")
    rep = run_graph500(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                       batch_size=64, semiring="tropical", csr=csr,
                       tiled=tiled, device=dev)
    launches = ops.launch_counts()
    if rep.validated != 64:
        raise AssertionError(f"graph500 validated {rep.validated} of 64 roots")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    log(f"[5] {rep.summary()} batch_s={rep.batch_seconds.tolist()}")
    log(f"[5] hmean TEPS {rep.harmonic_mean_teps:.6e} on {card}")
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
            for kern, fn, plain, shape in (
                    ("slimsell_spmv", ops.spmv, spmv_plain, (tiled.n,)),
                    ("slimsell_spmm", ops.spmm, spmm_plain, (tiled.n, B))):
                xt = frontier(sr, shape, g, dev)
                got, want = fn(sr, tiled, xt, tile_mask=mask), plain(sr, tiled, xt, mask)
                errs[kern] = max(errs[kern], max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"{kern} != plain at scale {SCALE}: "
                                         f"{name} mask={mask_name}")
                n_cases += 1
    torch.cuda.synchronize()
    log(f"[6] kernels == plain on {n_cases} cases at scale {SCALE} "
        f"(SpMV and SpMM B={B})")
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
    cols_needed = tiled.C * int(tiled.cl.sum(dtype=torch.int64))
    layout_bytes = 4 * (cols_needed + tiled.tile_ptr.numel()
                        + tiled.row_vertex.numel() + tiled.cl.numel()) \
        + full.numel()
    table = []
    for kern, width, xt, xl, fn, plain, lib in (
            ("slimsell_spmv", 1, x, xr, ops.spmv, spmv_plain,
             lambda: adj @ xr),
            ("slimsell_spmm", B, X, Xr, ops.spmm, spmm_plain,
             lambda: torch.sparse.mm(adj, Xr))):
        ms = time_ms(lambda: fn(tropical, tiled, xt, tile_mask=full), 20)
        ms_real = time_ms(lambda: fn(real, tiled, xl, tile_mask=full), 20)
        plain_ms = time_ms(lambda: plain(tropical, tiled, xt, full), 3)
        library_ms = time_ms(lib, 20)
        moved = layout_bytes + 2 * 4 * tiled.n * width   # layout, x in, y out
        ops_needed = 2 * edges * width                   # edge value + min
        bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops_needed / F32_OPS_PER_S)
        source, replaces = KERNEL_INFO[kern]
        table.append({
            "name": kern, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": errs[kern], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S
            >= ops_needed / F32_OPS_PER_S else "operations",
            "library_ms": library_ms, "semiring": "tropical",
            "ms_real": ms_real, "library_call": "torch.sparse.mm (real)"
            if width > 1 else "sparse CSR @ x (real)",
            "batch": width, "bytes": moved})
        log(f"[6] {kern} B={width}: kernel {ms:.4f} ms (real {ms_real:.4f}) "
            f"plain {plain_ms:.3f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({moved / 1e9:.3f} GB) on {card}")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
