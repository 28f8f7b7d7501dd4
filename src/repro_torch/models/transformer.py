"""Decoder-only transformer language model (dense and MoE), the port of the
JAX package's ``repro/models/transformer.py`` on one device: teacher-forced
``forward`` and ``loss_fn``, and serving through a KV cache (``prefill``,
then ``decode_step`` a token at a time).

The weights are the JAX package's tree under its key names, each layer's
weights stacked on a leading ``[L, ...]`` axis, so ``pytree`` and the
checkpoint store see the same leaves in both packages. The layers run in a
Python loop over that axis (the JAX package's ``lax.scan``).
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` under grad
(the JAX package's ``jax.checkpoint``): the layer is recomputed in the
backward, with the same values. ``cfg.scan_unroll`` is kept for parity
with the JAX package's configs and has no effect here.

The MoE FFN is ``moe.moe_reference``. ``ctx`` (the JAX package's
``ShardCtx``: a mesh and its sharding rules) must be None: the sharded
layouts (``param_specs``, ``cache_specs``, the attention's heads and
context modes, the expert-parallel MoE) wait for the sharding slice.

``decode_step`` writes the new key and value of each layer into the cache
it is given, in place, and returns that cache (the JAX package's serving
driver donates it). The cache is [L, B, S, KV, Dh] and holds keys after
RoPE; ``pos`` (int [B]) is the index each request writes, below S, and
may differ across the batch.

Entry points run on the card unless given ``device="cpu"``, and raise
without one; every weight and input must lie on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import pytree
from ..core.formats import resolve_device
from . import moe as moe_lib
from .gnn import _placed, _TreeModel
from .layers import (apply_rope, decode_attention, flash_attention, rmsnorm,
                     rope_freqs)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_cap_factor: float = 2.0
    rope_theta: float = 1e4
    rope_style: str = "half"           # "half" (llama) | "interleaved" (neox)
    window: Optional[int] = None       # chunked/local attention (llama4 option)
    dtype: Any = torch.bfloat16
    remat: bool = True
    scan_unroll: bool = False   # parity with the JAX package; no effect here
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def params_e9(self) -> float:
        p = 2 * self.vocab * self.d_model
        per = (self.d_model * (self.n_heads + 2 * self.n_kv) * self.d_head
               + self.n_heads * self.d_head * self.d_model + 2 * self.d_model)
        if self.moe:
            per += self.d_model * self.n_experts
            per += self.n_experts * 3 * self.d_model * self.d_ff_expert
            per += self.n_shared_experts * 3 * self.d_model * self.d_ff
        else:
            per += 3 * self.d_model * self.d_ff
        return (p + self.n_layers * per) / 1e9

    @property
    def active_params_e9(self) -> float:
        if not self.moe:
            return self.params_e9
        p = 2 * self.vocab * self.d_model
        per = (self.d_model * (self.n_heads + 2 * self.n_kv) * self.d_head
               + self.n_heads * self.d_head * self.d_model + 2 * self.d_model
               + self.d_model * self.n_experts
               + self.top_k * 3 * self.d_model * self.d_ff_expert
               + self.n_shared_experts * 3 * self.d_model * self.d_ff)
        return (p + self.n_layers * per) / 1e9


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "the port runs the language models on one device: ctx must be "
            "None; ShardCtx, param_specs / cache_specs and the expert-parallel "
            "MoE wait for the sharding slice (models/sharding.py)")


# ------------------------------------------------------------------- params


def param_shapes(cfg: LMConfig) -> dict:
    """The weight tree of ``init_params`` as meta tensors (shape and dtype,
    no storage): the JAX package's keys and stacked [L, ...] shapes."""
    L, D, H, KV, Dh = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
                       cfg.d_head)

    def t(*shape, dtype=cfg.dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    lp = {"ln1": t(L, D), "ln2": t(L, D), "wq": t(L, D, H, Dh),
          "wk": t(L, D, KV, Dh), "wv": t(L, D, KV, Dh), "wo": t(L, H, Dh, D)}
    if cfg.moe:
        E, Fe = cfg.n_experts, cfg.d_ff_expert
        lp["router"] = t(L, D, E, dtype=torch.float32)
        lp["e_wi_g"] = t(L, E, D, Fe)
        lp["e_wi_u"] = t(L, E, D, Fe)
        lp["e_wo"] = t(L, E, Fe, D)
        if cfg.n_shared_experts:
            Fs = cfg.d_ff * cfg.n_shared_experts
            lp["s_wi_g"] = t(L, D, Fs)
            lp["s_wi_u"] = t(L, D, Fs)
            lp["s_wo"] = t(L, Fs, D)
    else:
        lp["wi_g"] = t(L, D, cfg.d_ff)
        lp["wi_u"] = t(L, D, cfg.d_ff)
        lp["wo_ff"] = t(L, cfg.d_ff, D)
    return {"embed": t(cfg.vocab, D), "head": t(D, cfg.vocab),
            "final_norm": t(D), "layers": lp}


# the most float32 elements drawn at once: a leaf larger than this (kimi-k2's
# expert weights are 11.3 GB a layer in bfloat16) is drawn slice by slice
_DRAW_ELEMS = 1 << 26


def _normal_into(out: torch.Tensor, cfg_dtype, generator: torch.Generator,
                 std: float = 0.02) -> torch.Tensor:
    """Fill ``out`` with N(0, std^2) drawn in float32 on the generator's
    device, rounded to ``cfg_dtype`` (then to ``out``'s dtype), over
    slices of the leading axes of at most ``_DRAW_ELEMS`` elements."""
    flat = out.view(-1, out.shape[-1]) if out.ndim > 1 else out.view(1, -1)
    rows = max(1, _DRAW_ELEMS // flat.shape[1])
    for r0 in range(0, flat.shape[0], rows):
        part = flat[r0:r0 + rows]
        draw = torch.randn(part.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
        part.copy_((draw * std).to(cfg_dtype))
    return out


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    """The JAX package's weight tree (``param_shapes``): embedding, head
    and every matrix N(0, 0.02^2) in ``cfg.dtype``, the norms' scales one,
    the router float32 holding ``cfg.dtype``-rounded draws. Drawn leaf by
    leaf from ``generator`` (default: a CPU generator seeded with 0) on its
    device, and placed on ``device`` (default: the card; raises when there
    is none). A generator on the card draws there, so a seed gives other
    weights on the card than on the CPU."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ones = ("['ln1']", "['ln2']", "['final_norm']")

    def make(path_leaf):
        path, meta = path_leaf
        out = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        if path.endswith(ones):
            return out.fill_(1.0)
        return _normal_into(out, cfg.dtype, generator)

    pairs, treedef = pytree.flatten_with_paths(param_shapes(cfg))
    return pytree.unflatten(treedef, [make(p) for p in pairs])


# ------------------------------------------------------------------ blocks


def _proj_in(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(h.shape[:-1] + w.shape[1:])


def _dense_ffn(h, wi_g, wi_u, wo):
    return (F.silu(h @ wi_g) * (h @ wi_u)) @ wo


def _attention(x, lp, cfg: LMConfig, cos, sin, *, cache=None, pos=None):
    """Returns (attention output, (k, v)): the new keys and values over the
    sequence, or with ``cache`` the layer's caches with this step's written."""
    h = rmsnorm(x, lp["ln1"])
    q = apply_rope(_proj_in(h, lp["wq"]), cos, sin, style=cfg.rope_style)
    k = apply_rope(_proj_in(h, lp["wk"]), cos, sin, style=cfg.rope_style)
    v = _proj_in(h, lp["wv"])
    if cache is None:
        o = flash_attention(q, k, v, causal=True, window=cfg.window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        k_cache, v_cache = cache
        b_idx = torch.arange(q.shape[0], device=q.device)
        k_cache[b_idx, pos] = k[:, 0]
        v_cache[b_idx, pos] = v[:, 0]
        o = decode_attention(q, k_cache, v_cache, pos, window=cfg.window)
        k, v = k_cache, v_cache
    wo = lp["wo"]
    out = o.reshape(o.shape[:2] + (-1,)) @ wo.reshape(-1, wo.shape[-1])
    return out, (k, v)


def _ffn_block(x, lp, cfg: LMConfig):
    h = rmsnorm(x, lp["ln2"])
    if not cfg.moe:
        return _dense_ffn(h, lp["wi_g"], lp["wi_u"], lp["wo_ff"])
    dims = moe_lib.MoEDims(cfg.n_experts, cfg.top_k, cfg.d_model,
                           cfg.d_ff_expert, cap_factor=cfg.moe_cap_factor)
    y = moe_lib.moe_reference(h, lp["router"], lp["e_wi_g"], lp["e_wi_u"],
                              lp["e_wo"], dims)
    if cfg.n_shared_experts:
        y = y + _dense_ffn(h, lp["s_wi_g"], lp["s_wi_u"], lp["s_wo"])
    return y


# ------------------------------------------------------------------ forward


def _layers(params: dict) -> list:
    """Each layer's weights, views of the stacked leaves. ``unbind`` makes
    the backward stack the layers' gradients once a leaf (the JAX package's
    scan does the same); indexing a layer out of each leaf would scatter
    every layer's gradient into a zeroed [L, ...] tensor of its own."""
    cols = {name: w.unbind(0) for name, w in params["layers"].items()}
    return [{name: ws[i] for name, ws in cols.items()}
            for i in range(len(next(iter(cols.values()))))]


def _check(params, dev: torch.device, **inputs) -> None:
    for path, leaf in pytree.flatten_with_paths(params)[0]:
        _placed(leaf, dev, f"params{path}")
    for name, t in inputs.items():
        for path, leaf in pytree.flatten_with_paths(t)[0]:
            _placed(leaf, dev, f"{name}{path}")


def _embed(params, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.dtype)


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, params["final_norm"]) @ params["head"]


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig, ctx=None, *,
            return_cache: bool = False, device=None):
    """Teacher-forced forward over tokens int [B, S] -> logits [B, S, V]
    in ``cfg.dtype``; with ``return_cache`` also (k, v), each
    [L, B, S, KV, Dh]."""
    _no_ctx(ctx)
    dev = resolve_device(device)
    _check(params, dev, tokens=tokens)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_freqs(torch.arange(S, device=dev), cfg.d_head,
                          cfg.rope_theta)

    def layer(x, lp):
        a, kv = _attention(x, lp, cfg, cos, sin)
        x = x + a
        return x + _ffn_block(x, lp, cfg), kv

    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in _layers(params):
        if remat:
            x, (k, v) = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, (k, v) = layer(x, lp)
        if return_cache:
            ks.append(k)
            vs.append(v)
    logits = _logits(params, x)
    if return_cache:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def loss_fn(params: dict, batch: dict, cfg: LMConfig, ctx=None, *,
            device=None) -> torch.Tensor:
    """Mean next-token NLL in float32 over ``batch["tokens"]`` and
    ``batch["labels"]`` (int [B, S]); a label of -1 is masked out. A
    label at or past the vocabulary raises (the JAX package reads NaN
    there)."""
    logits = forward(params, batch["tokens"], cfg, ctx, device=device)
    labels = batch["labels"].long()
    if bool((labels >= cfg.vocab).any()):
        raise ValueError(f"labels must lie below the vocabulary {cfg.vocab}")
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


class LM(_TreeModel):
    """The language model as a module over ``init_params``' tree:
    ``forward(tokens)`` is ``forward``'s logits."""
    init = staticmethod(init_params)
    apply = staticmethod(forward)


# ------------------------------------------------------------------ serving


def init_cache(cfg: LMConfig, batch: int, seq: int, *, device=None) -> dict:
    """``{"k", "v"}``, each zeros [L, batch, seq, KV, Dh] in ``cfg.dtype``
    on ``device`` (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    shp = (cfg.n_layers, batch, seq, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=dev)}


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, ctx=None, *,
            device=None):
    """The forward over the prompt: (the last position's logits [B, V],
    the cache ``{"k", "v"}`` of the prompt, [L, B, S, KV, Dh] each)."""
    logits, (k, v) = forward(params, tokens, cfg, ctx, return_cache=True,
                             device=device)
    return logits[:, -1], {"k": k, "v": v}


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig, ctx=None, *, device=None):
    """token int [B] at positions pos int [B] (each below the cache's
    length) -> (logits [B, V], cache): the cache written in place at
    ``pos`` and returned."""
    _no_ctx(ctx)
    dev = resolve_device(device)
    _check(params, dev, cache=cache, token=token, pos=pos)
    x = _embed(params, token[:, None], cfg)
    pos = pos.long()
    cos, sin = rope_freqs(pos[:, None], cfg.d_head, cfg.rope_theta)
    for i, lp in enumerate(_layers(params)):
        a, _ = _attention(x, lp, cfg, cos, sin,
                          cache=(cache["k"][i], cache["v"][i]), pos=pos)
        x = x + a
        x = x + _ffn_block(x, lp, cfg)
    return _logits(params, x)[:, 0], cache
