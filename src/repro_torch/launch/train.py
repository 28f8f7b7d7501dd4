"""Training driver: steps of the LM loss with checkpoints, the port of the
JAX package's ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --device cpu --steps 20 --batch 8 --seq 64 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 10 [--resume]

The port's ``make_train_step`` over ``models.transformer.loss_fn`` with the
configuration's optimiser (``OPTIMIZER``: AdamW, or Muon for kimi-k2), on
``TokenPipeline`` batches. The weights are drawn from ``--seed`` on the
device the run uses. A checkpoint (``checkpoint.save``) holds the weights
and the step's state; ``--resume`` restores the latest one from
``--ckpt-dir`` and goes on from its step, and since a batch is a pure
function of (seed, step) the resumed run sees the stream the straight run
would have seen. Returns the losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import checkpoint
from ..configs import get as get_arch
from ..core.formats import resolve_device
from ..data import TokenPipeline
from ..models import transformer as tf
from ..optim import adamw, muon
from ..train import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises when there is none)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The training run ``main`` drives: ``{"losses", "step_s", "start"}``,
    ``step_s`` each step's seconds by the host clock (the loss read back
    each step), ``start`` the step it began at."""
    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", None) != "lm":
        raise ValueError(f"{args.arch} is not a language model")
    cfg = mod.reduced_config() if args.reduced else mod.make_config()
    opt = muon() if getattr(mod, "OPTIMIZER", "adamw") == "muon" else adamw()
    step_fn, init_state = make_train_step(
        lambda p, b: tf.loss_fn(p, b, cfg, device=dev), opt)

    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    state = init_state(params)
    start = 0
    if args.resume and args.ckpt_dir:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            (params, state), meta = checkpoint.restore(
                args.ckpt_dir, last, (params, state), device=dev)
            start = int(meta["step"])
            print(f"resumed from step {start}")

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.tensor(v, device=dev)
                 for k, v in pipe.get_batch(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({np.mean(step_s) * 1e3:.0f} ms/step)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = checkpoint.save(args.ckpt_dir, step + 1, (params, state),
                                   metadata={"step": step + 1,
                                             "loss": losses[-1]})
            print(f"checkpointed -> {path}")
    if len(losses) > 20:
        print(f"loss first10={np.mean(losses[:10]):.4f} "
              f"last10={np.mean(losses[-10:]):.4f}")
    return {"losses": losses, "step_s": step_s, "start": start}


def main(argv=None) -> list:
    return run(parse_args(argv))["losses"]


if __name__ == "__main__":
    main()
