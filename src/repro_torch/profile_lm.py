"""Where a language model's prefill, decode step and train step spend their
time on the card.

    PYTHONPATH=src python -m repro_torch.profile_lm
    PYTHONPATH=src python -m repro_torch.profile_lm --serve-arch phi3-mini-3.8b \
        --batch 4 --prompt-len 512 --train-arch smollm-135m --seq 256

Draws ``--serve-arch``'s weights on the card (seed 0), runs a prefill of
``--batch`` prompts of ``--prompt-len`` tokens and decode steps through the
padded cache, then trains ``--train-arch`` (AdamW, ``TokenPipeline``
batches of ``--batch`` x ``--seq``). Each is warmed up, timed on the host
clock around synchronised calls (the decode step and the train step over
several calls), and run once more under ``torch.profiler``. Prints each
one's wall time, the device's busy time (kernel time) and idle share, the
kernels launched, the kernels that took the most device time and the
operators that took the most host time. The last line is all of it as
JSON.

It measures the device, so it needs a CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .configs import get as get_arch
from .core.formats import resolve_device
from .data import TokenPipeline
from .launch.serve import prompt_tokens
from .models import transformer as tf
from .optim import adamw
from .train import make_train_step

TOP = 8   # kernels and operators listed


def _wall_ms(fn, n: int = 1) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _profiled(label: str, fn, n: int) -> dict:
    """``n`` calls of ``fn`` under the profiler: per call the wall ms, the
    device's busy ms (every kernel's device time) and kernels launched."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(fn, n)
    avg = prof.key_averages()
    dev = [e for e in avg if "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    kernels = sum(e.count for e in dev) / n
    top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:TOP]
    top_host = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:TOP]
    print(f"{label}: {wall:.3f} ms wall (profiled), device busy {busy:.3f} "
          f"ms, idle share {1 - busy / wall:.4f}, {kernels:.0f} kernels")
    for e in top_dev:
        print(f"    device {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:6.0f}x {e.key[:90]}")
    for e in top_host:
        print(f"    host   {e.self_cpu_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:6.0f}x {e.key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernels": kernels,
            "top_device": [(e.key, e.self_device_time_total / 1e3 / n)
                           for e in top_dev]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve-arch", default="phi3-mini-3.8b")
    ap.add_argument("--train-arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--train-batch", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    report = {"device": torch.cuda.get_device_name(0)}

    cfg = get_arch(args.serve_arch).make_config()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    B, S = args.batch, args.prompt_len
    prompt = torch.tensor(prompt_tokens(cfg.vocab, B, S, 0), device=dev)
    with torch.no_grad():
        prefill = lambda: tf.prefill(params, prompt, cfg, device=dev)
        logits, cache = prefill()
        cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 64))
                 for k, c in cache.items()}
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = [S]

        def decode():
            p = torch.full((B,), pos[0], dtype=torch.int32, device=dev)
            pos[0] += 1
            tf.decode_step(params, cache, tok, p, cfg, device=dev)

        decode()
        report["prefill_ms"] = _wall_ms(prefill)
        report["decode_ms"] = _wall_ms(decode, 8)
        print(f"{cfg.name} B={B} prompt {S}: prefill {report['prefill_ms']:.3f}"
              f" ms, decode {report['decode_ms']:.3f} ms a step")
        report["prefill"] = _profiled(f"{cfg.name} prefill", prefill, 1)
        report["decode"] = _profiled(f"{cfg.name} decode step", decode, 4)
    del params, cache, logits
    torch.cuda.empty_cache()

    cfg = get_arch(args.train_arch).make_config()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    step, init = make_train_step(
        lambda p, b: tf.loss_fn(p, b, cfg, device=dev), adamw())
    state = [init(params)]
    batch = {k: torch.tensor(v, device=dev) for k, v in
             TokenPipeline(cfg.vocab, args.train_batch, args.seq)
             .get_batch(0).items()}

    def train():
        _, state[0], m = step(params, state[0], batch)
        float(m["loss"])

    train()
    report["train_ms"] = _wall_ms(train, 3)
    print(f"{cfg.name} B={args.train_batch} S={args.seq}: "
          f"{report['train_ms']:.3f} ms a step")
    report["train"] = _profiled(f"{cfg.name} train step", train, 1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
