"""Where one Graph500 batch spends its time on the card.

    PYTHONPATH=src python -m repro_torch.profile_graph500 --scale 20 --batch 64 \
        --direction push auto pull
    PYTHONPATH=src python -m repro_torch.profile_graph500 --scale 20 --batch 64 \
        --sssp

Builds ``kronecker(scale, 16, seed=1)`` and its SlimSell layout,
samples the Graph500 search keys, and for each direction runs one batch
of ``multi_source_bfs`` (tropical) from them; with ``--sssp`` the graph
carries the Graph500 SSSP weights (uniform on [2^-8, 1], seed 2) and the
batch is one ``multi_source_sssp`` at the default delta instead. Each
batch runs once to warm up, then timed on the host clock with and without
the parent pass, then once more under ``torch.profiler``. Prints the wall
times, the device time of the kernels that took the most, and the
device's busy share of the profiled batch (kernel time over wall time).
The last line is all of it as JSON.

It measures the device, so it needs a CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
from .core.formats import build_slimsell
from .core.multi_bfs import multi_source_bfs
from .core.multi_sssp import multi_source_sssp
from .core.options import DIRECTIONS, EngineConfig
from .graph500 import sample_roots
from .graphs.generators import kronecker, with_random_weights

EDGE_FACTOR = 16  # Graph500's
TOP = 12          # kernels listed


def _wall_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_kernels(prof) -> dict:
    """{name: (device ms, calls)} of the device-side events of a trace."""
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        out[e.key] = (ms, e.count)
    return out


def _profile(tiled, roots, direction: str, trace, sssp: bool = False) -> dict:
    """Wall times and the device profile of one batch in one direction
    (BFS), or of one SSSP batch."""
    config = EngineConfig(direction=direction)
    dev = tiled.device

    def batch(parents: bool):
        if sssp:
            return multi_source_sssp(tiled, roots, need_parents=parents,
                                     config=config, device=dev)
        return multi_source_bfs(tiled, roots, "tropical", need_parents=parents,
                                config=config, device=dev)

    batch(True)  # warm-up: allocator, first launches
    wall = {"with_parents_s": _wall_s(lambda: batch(True)),
            "without_parents_s": _wall_s(lambda: batch(False))}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_s = _wall_s(lambda: batch(True))
    if trace:
        prof.export_chrome_trace(trace)
    kernels = _device_kernels(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    label = "sssp" if sssp else f"direction {direction}"
    print(f"{label}: {wall}", flush=True)
    print(f"profiled batch {profiled_s * 1e3:.3f} ms wall, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / (profiled_s * 1e3):.4f} of it)")
    for k, (ms, calls) in top:
        print(f"  {ms:10.3f} ms {calls:6d} x  {k[:110]}")
    return {"kernel": "sssp" if sssp else "bfs", "direction": direction,
            **wall, "profiled_s": profiled_s,
            "device_busy_ms": busy_ms,
            "top": [{"name": k, "ms": ms, "calls": c} for k, (ms, c) in top]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--direction", nargs="+", choices=DIRECTIONS,
                    default=["push"], help="one profiled batch for each")
    ap.add_argument("--trace", default=None,
                    help="write the profiled batch's Chrome trace here "
                    "(with several directions, <trace>.<direction>.json)")
    ap.add_argument("--sssp", action="store_true",
                    help="profile a weighted multi_source_sssp batch "
                    "(push) in place of the BFS directions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_graph500 measures the card; no CUDA device found")
    dev = torch.device("cuda")
    csr = kronecker(args.scale, EDGE_FACTOR, seed=1)
    if args.sssp:
        csr = with_random_weights(csr, low=WEIGHT_LOW, high=WEIGHT_HIGH,
                                  seed=2)
    tiled = build_slimsell(csr, C=8, L=128, sigma=csr.n).to_torch(dev)
    roots = sample_roots(csr, args.batch)
    name = subprocess.run(  # the card's name and power limit
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"scale {args.scale} ef {EDGE_FACTOR} batch {roots.size} on {name}",
          flush=True)
    directions = ["push"] if args.sssp else args.direction
    runs = []
    for direction in directions:
        trace = args.trace
        if trace and len(directions) > 1:
            trace = f"{trace}.{direction}.json"
        runs.append(_profile(tiled, roots, direction, trace, sssp=args.sssp))
    report = {"device": name, "scale": args.scale, "batch": int(roots.size),
              "runs": runs}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
