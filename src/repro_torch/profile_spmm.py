"""Where the SlimSell SpMM spends its time across chunks, on the card.

    PYTHONPATH=src python -m repro_torch.profile_spmm --scale 20

Builds ``kronecker(scale, 16, seed=1)`` with the Graph500 SSSP weights
(uniform on [2^-8, 1], seed 2) and its SlimSell layout (C=8, L=128,
sigma=n), and times each SpMM entry through ``kernels.ops.spmm`` with
every tile kept and then over parts of the layout, chosen by the SlimWork
tile mask: the chunk with the most tiles alone, every other chunk, the
chunks of at least ``--heavy`` tiles alone, the rest, and no tile at all
(the launch and the write of Y). The entries: the implicit SpMM (2,
tropical, B=64), the stored-weight min-plus SpMM (2w, B=64) and the GCN
SpMM (2g, real, B=16). If one block's walk over the longest chunk holds
the sweep, the heaviest chunk alone takes most of the time of all of it.
The last line is all of it as JSON.

It measures the device, so it needs a CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
from .core import semiring
from .core.formats import build_slimsell
from .graphs.generators import kronecker, with_random_weights
from .kernels import ops

EDGE_FACTOR = 16  # Graph500's


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--heavy", type=int, default=10,
                    help="tiles that make a chunk heavy")
    ap.add_argument("--reps", type=int, default=10)
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
    for name, (width, fn) in entries(tiled, dev, np.random.default_rng(0)).items():
        split = chunk_split(fn, tiled, heavy=args.heavy, reps=args.reps)
        result["entries"][name] = {"batch": width, **split}
        print(f"{name} B={width}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items() if k != "layout")
            + f" on {card}", flush=True)
    print(f"layout: {result['entries']['slimsell_spmm']['layout']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
