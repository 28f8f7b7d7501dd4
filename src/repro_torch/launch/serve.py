"""Serving driver: batched prefill, then greedy decode through the KV
cache, the port of the JAX package's ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 16

Draws the weights from ``--seed`` (on the device the run uses: the same
seed gives other weights on the card than on the CPU) and the prompt from
a numpy generator seeded with ``--seed``, runs one prefill over the
prompts and ``--gen - 1`` decode steps (greedy), and prints the prefill's
and the decode's tokens/s, the prefill's TFLOP/s (``lm_model_flops``), a
decode step's time beside its bound (every weight but the embedding
table, the batch's embedding rows and the whole cache read once, over
the card's 3.35 TB/s) and, on the card, the peak device memory. Returns
the generated tokens [batch, gen].

``generate(..., ctx=)`` runs the same loop on a rank of a mesh
(``models.transformer.ShardCtx``): prefill and decode through the rank's
blocks of the weights and the cache, the greedy pick over vocab-sharded
logits the first maximum across the shards (as ``jnp.argmax``), every
rank feeding the whole batch's tokens. ``main`` runs on one device, as
the JAX package's does.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import pytree
from ..configs import get as get_arch
from ..configs.cells import lm_model_flops
from ..core.formats import resolve_device
from ..models import transformer as tf
from ..models.sharding import axis_size, block, entry_axes

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def prompt_tokens(vocab: int, batch: int, prompt_len: int,
                  seed: int) -> np.ndarray:
    """The prompts, int32 [batch, prompt_len], uniform over the vocabulary
    from a numpy generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(batch, prompt_len)).astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_bytes(params: dict, cache: dict, batch: int) -> tuple:
    """(weight bytes, cache bytes) a decode step must read: every weight
    leaf but the embedding table, ``batch`` rows of it, and the whole
    ``{"k", "v"}`` cache."""
    embed = params["embed"]
    weights = sum(t.numel() * t.element_size() for t in pytree.leaves(params)
                  if t is not embed)
    weights += batch * embed.shape[1] * embed.element_size()
    kv = sum(t.numel() * t.element_size() for t in cache.values())
    return weights, kv


def greedy(logits: torch.Tensor, cfg: tf.LMConfig,
           ctx: Optional[tf.ShardCtx] = None,
           batch: Optional[int] = None) -> torch.Tensor:
    """The greedy tokens int32 [B] of logits [B, V] (the first maximum);
    under ``ctx`` of the rank's block of a batch of ``batch``
    (``logits_spec(seq=False)``): the first maximum across the vocabulary
    shards, the whole batch on every rank."""
    if ctx is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    grid = ctx.grid
    b_entry, v_entry = tf.logits_spec(cfg, ctx, batch, seq=False)
    tok = torch.argmax(logits, dim=-1)
    if entry_axes(v_entry):
        best = logits.float().amax(-1)
        lo = block(v_entry, cfg.vocab, grid).start
        axes = entry_axes(v_entry)
        bests = grid.all_gather(best, axes)             # [n, b]
        toks = grid.all_gather(tok + lo, axes)
        first = torch.argmax((bests == bests.amax(0)).to(torch.int8), dim=0)
        tok = toks.gather(0, first[None])[0]
    if entry_axes(b_entry):
        tok = grid.all_gather_dim(tok, 0, entry_axes(b_entry))
    return tok.to(torch.int32)


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: tf.LMConfig, gen: int,
             *, ctx: Optional[tf.ShardCtx] = None,
             feed: Optional[torch.Tensor] = None, device=None) -> dict:
    """Prefill ``prompt`` (int [B, S]) into a cache of ``S + gen``
    positions and decode ``gen - 1`` tokens greedily. Returns
    ``{"tokens"}`` int32 [B, gen] (the greedy picks), ``{"logits"}``
    [B, gen, V] (the prefill's last position's, then each decode step's),
    ``prefill_s`` and ``decode_s`` (host clock, the device synchronised)
    and ``weight_bytes`` / ``cache_bytes`` (a decode step's reads,
    ``decode_bytes``). ``feed`` (int [B, gen - 1]), where given, is fed to
    the decode steps in place of the greedy picks (teacher forcing: two
    runs' logits held step by step). Under ``ctx`` the logits and the
    bytes are the rank's, the tokens the whole batch's, and the cache's
    length is rounded up to split over its sequence axes (the extra
    positions stay masked)."""
    dev = tf._device(device, ctx)
    B, S = prompt.shape
    n = S + gen
    if ctx is not None:
        seq_entry = tf.cache_specs(cfg, ctx.grid, ctx.rules,
                                   seq_shard=ctx.cache_seq_shard,
                                   batch=B)["k"][2]
        n = -(-n // axis_size(ctx.grid, seq_entry)) * axis_size(ctx.grid,
                                                                 seq_entry)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, prompt, cfg, ctx, cache_len=n,
                               device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    outs = [logits]
    toks = [greedy(logits, cfg, ctx, B)]
    for i in range(gen - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        tok = toks[-1] if feed is None else feed[:, i].to(torch.int32)
        logits, cache = tf.decode_step(params, cache, tok, pos, cfg, ctx,
                                       device=dev)
        outs.append(logits)
        toks.append(greedy(logits, cfg, ctx, B))
    _sync(dev)
    t2 = time.perf_counter()
    weight_bytes, cache_bytes = decode_bytes(params, cache, B)
    return {"tokens": torch.stack(toks, dim=1),
            "logits": torch.stack(outs, dim=1),
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes}


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises when there is none)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", None) != "lm":
        raise ValueError(f"{args.arch} is not a language model")
    cfg = mod.reduced_config() if args.reduced else mod.make_config()
    B, S = args.batch, args.prompt_len
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    prompt = torch.tensor(prompt_tokens(cfg.vocab, B, S, args.seed),
                          device=dev)
    out = generate(params, prompt, cfg, args.gen, device=dev)

    flops = lm_model_flops(cfg, B, S, "prefill")
    steps = args.gen - 1
    step_s = out["decode_s"] / max(steps, 1)
    moved = out["weight_bytes"] + out["cache_bytes"]
    print(f"prefill: {B * S / out['prefill_s']:.0f} tok/s "
          f"({flops / out['prefill_s'] / 1e12:.3f} TFLOP/s)   "
          f"decode: {B * steps / max(out['decode_s'], 1e-9):.0f} tok/s")
    print(f"decode step: {step_s * 1e3:.4f} ms, bound "
          f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms (weights "
          f"{out['weight_bytes'] / 1e9:.4f} GB + cache "
          f"{out['cache_bytes'] / 1e9:.4f} GB over 3.35 TB/s)")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev)} "
              f"bytes")
    print("generated:", out["tokens"][0][:16].tolist())
    return out["tokens"]


if __name__ == "__main__":
    main()
