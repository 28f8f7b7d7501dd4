"""Decoder-only transformer language model (dense and MoE), the port of the
JAX package's ``repro/models/transformer.py``: teacher-forced ``forward``
and ``loss_fn``, and serving through a KV cache (``prefill``, then
``decode_step`` a token at a time), on one device or on a mesh of ranks.

The weights are the JAX package's tree under its key names, each layer's
weights stacked on a leading ``[L, ...]`` axis, so ``pytree`` and the
checkpoint store see the same leaves in both packages. The layers run in a
Python loop over that axis (the JAX package's ``lax.scan``).
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` under grad
(the JAX package's ``jax.checkpoint``): the layer is recomputed in the
backward, with the same values. ``cfg.scan_unroll`` is kept for parity
with the JAX package's configs and has no effect here.

``decode_step`` writes the new key and value of each layer into the cache
it is given, in place, and returns that cache (the JAX package's serving
driver donates it). The cache is [L, B, S, KV, Dh] and holds keys after
RoPE; ``pos`` (int [B]) is the index each request writes, below S, and
may differ across the batch.

**On a mesh** (``ctx``, a ``ShardCtx`` over the world's
``distributed.Grid``) every rank holds exactly the block of each weight
that ``param_specs`` gives its mesh position (``init_params(ctx=)``,
``convert.lm_shards_from_arrays``) and the block of the cache that
``cache_specs`` gives, and runs the collectives GSPMD inserts for the JAX
package's sharding constraints, explicitly:

* FSDP: a weight's ``D`` block is all-gathered over ``fsdp`` just before
  its use and dropped after;
* heads mode (heads and KV heads divisible by ``tp``): q, k and v are the
  rank's heads, ``wo`` is row-parallel (each rank's partial [B, S, D] is
  SUM-reduced over ``tp``), the FFN's ``d_ff`` is split over ``tp`` in the
  same column-then-row pattern;
* context mode (otherwise): the attention weights are whole on heads, the
  queries are the rank's block of the sequence (RoPE, causal and window
  masks at global positions) and k and v are all-gathered;
* between blocks the activations are ``S``-sharded over ``tp`` (sequence
  parallelism): a block all-gathers its normed input over ``tp`` and
  reduce-scatters its output, so the residual stream really is sharded;
  in decode they are replicated over ``tp`` and a row-parallel output is
  all-reduced;
* the embedding and the head are vocab-parallel: a rank looks up the ids
  of its vocabulary block and the rows are SUM-reduced over ``tp``; the
  logits are the rank's vocabulary block; ``loss_fn`` takes the global
  max and sum of exponentials over ``tp`` and the label's logit from the
  rank that holds it;
* decode writes the new key and value only where the rank's cache shard
  holds ``pos``; across a sequence split (over ``tp`` in context mode,
  over ``dp`` with ``cache_seq_shard``) ``layers.decode_attention``
  combines the shards;
* the MoE, its experts split over ``tp``: under ``moe_impl="ep"`` (the
  default, the JAX package's) expert parallelism (``models.moe``): outside
  decode ``moe_ep_train`` sends each (token, slot) pair of the rank's
  block to its expert's rank in a static-capacity all-to-all over ``tp``
  and back, dropping the pairs past the capacity; in decode
  ``moe_ep_decode`` runs on every rank the pairs of its own experts and
  SUM-reduces over ``tp``; it raises ``ValueError`` where the JAX
  package's ``shard_map`` does (experts, or outside decode the batch or
  the sequence, not splitting over their axes: ``moe.check_ep``). Under
  ``moe_impl="reference"`` the router is whole on every rank, each rank
  runs its experts over every token and the float32 partial outputs are
  SUM-reduced over ``tp``.

Every dimension follows ``sharding.shard_dim``: one that does not divide
is replicated, and its collective drops away. Inputs (tokens, labels,
token, pos) are the whole batch on every rank; each rank takes its batch
block (``dp``, where the batch divides). Outputs are the rank's blocks:
logits [B/dp, S, V/tp] (``gather_shard`` with ``logits_spec`` makes them
whole), the loss whole on every rank. A row-parallel product's partials
are rounded to the weights' dtype before they are summed, so a bfloat16
model on a mesh is not bit-equal to one device.

Not on a mesh yet: training (grad mode under a ``ShardCtx`` is refused:
the training-on-a-mesh slice, which brings the all-to-all's backward).

Entry points run on the card unless given ``device="cpu"``, and raise
without one; under ``ctx`` they run on the grid's device. Every weight and
input must lie on that device.
"""
from __future__ import annotations

import dataclasses
import functools
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
from .sharding import (AxisRules, axis_size, block, entry_axes, local_shard,
                       reshard, shard_dim, spec_leaves)


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


MOE_IMPLS = ("ep", "reference")


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh and its policy bits, the JAX package's ``ShardCtx``.
    ``grid``: the world's ``distributed.Grid`` to run on, or any mesh
    (``launch.mesh.MeshShape``) for the specs alone. ``cache_seq_shard``:
    the KV cache's sequence over ``dp`` (``long_500k``). ``moe_impl``:
    "ep" (the default: ``moe_ep_train`` / ``moe_ep_decode``) or
    "reference" (``moe_partial``, each rank's experts over every
    token)."""
    grid: Any
    rules: AxisRules
    cache_seq_shard: bool = False
    moe_impl: str = "ep"


def _attn_mode(cfg: LMConfig, ctx: Optional[ShardCtx]) -> str:
    """'heads': tensor parallelism over (H, KV). 'context': where the head
    counts do not divide the tp extent, the query *sequence* is sharded
    instead and k / v are gathered."""
    if ctx is None:
        return "none"
    tp = ctx.grid.axis_size(ctx.rules.tp)
    if cfg.n_heads % tp == 0 and cfg.n_kv % tp == 0:
        return "heads"
    return "context"


def _check_ctx(cfg: LMConfig, ctx: ShardCtx) -> None:
    if not isinstance(ctx, ShardCtx):
        raise TypeError(f"ctx must be a ShardCtx or None, got "
                        f"{type(ctx).__name__}")
    if ctx.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                         f"{ctx.moe_impl!r}")
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "training on a mesh (FSDP's gradient reduce-scatter) waits for "
            "the training-on-a-mesh slice with the build_*_cell builders "
            "(ROADMAP module queue 2.3); run the sharded paths under "
            "torch.no_grad()")
    if not hasattr(ctx.grid, "all_reduce"):
        raise TypeError("a ShardCtx runs on a distributed.Grid; a mesh "
                        "shape gives the specs alone")


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


def param_specs(cfg: LMConfig, mesh, rules: AxisRules) -> dict:
    """The spec of each leaf of ``init_params``' tree (the JAX package's
    ``param_specs``, each ``PartitionSpec`` a tuple): vocabulary, heads,
    experts and ``d_ff`` over ``tp``, ``D`` over ``fsdp``; context-mode
    configs keep the attention's heads whole."""
    fs, tp = rules.fsdp, rules.tp

    def sd(dim, axes):
        return shard_dim(mesh, dim, axes)

    H, KV, D = cfg.n_heads, cfg.n_kv, cfg.d_model
    heads_ok = H % mesh.axis_size(tp) == 0 and KV % mesh.axis_size(tp) == 0
    h_ax = tp if heads_ok else None
    ls = {"ln1": (None, None), "ln2": (None, None),
          "wq": (None, sd(D, fs), sd(H, h_ax), None),
          "wk": (None, sd(D, fs), sd(KV, h_ax), None),
          "wv": (None, sd(D, fs), sd(KV, h_ax), None),
          "wo": (None, sd(H, h_ax), None, sd(D, fs))}
    if cfg.moe:
        E = cfg.n_experts
        ls["router"] = (None, None, None)
        ls["e_wi_g"] = (None, sd(E, tp), sd(D, fs), None)
        ls["e_wi_u"] = (None, sd(E, tp), sd(D, fs), None)
        ls["e_wo"] = (None, sd(E, tp), None, sd(D, fs))
        if cfg.n_shared_experts:
            Fs = cfg.d_ff * cfg.n_shared_experts
            ls["s_wi_g"] = (None, sd(D, fs), sd(Fs, tp))
            ls["s_wi_u"] = (None, sd(D, fs), sd(Fs, tp))
            ls["s_wo"] = (None, sd(Fs, tp), sd(D, fs))
    else:
        ls["wi_g"] = (None, sd(D, fs), sd(cfg.d_ff, tp))
        ls["wi_u"] = (None, sd(D, fs), sd(cfg.d_ff, tp))
        ls["wo_ff"] = (None, sd(cfg.d_ff, tp), sd(D, fs))
    return {"embed": (sd(cfg.vocab, tp), sd(D, fs)),
            "head": (sd(D, fs), sd(cfg.vocab, tp)),
            "final_norm": (None,), "layers": ls}


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
                *, device=None, ctx: Optional[ShardCtx] = None) -> dict:
    """The JAX package's weight tree (``param_shapes``): embedding, head
    and every matrix N(0, 0.02^2) in ``cfg.dtype``, the norms' scales one,
    the router float32 holding ``cfg.dtype``-rounded draws. Drawn leaf by
    leaf from ``generator`` (default: a CPU generator seeded with 0) on its
    device, and placed on ``device`` (default: the card, or the grid's
    device under ``ctx``; raises when there is none). A generator on the
    card draws there, so a seed gives other weights on the card than on
    the CPU. With ``ctx`` each leaf is drawn whole and only the rank's
    block (``param_specs``) kept, so every rank of a mesh holds its block
    of the same weights and none holds the whole model."""
    dev = _device(device, ctx)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ones = ("['ln1']", "['ln2']", "['final_norm']")
    specs = None if ctx is None else spec_leaves(
        param_specs(cfg, ctx.grid, ctx.rules))

    def make(i, path_leaf):
        path, meta = path_leaf
        out = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        if path.endswith(ones):
            out.fill_(1.0)
        else:
            _normal_into(out, cfg.dtype, generator)
        if specs is None:
            return out
        return local_shard(out, specs[i], ctx.grid).clone()

    pairs, treedef = pytree.flatten_with_paths(param_shapes(cfg))
    return pytree.unflatten(treedef, [make(i, p) for i, p in enumerate(pairs)])


# ------------------------------------------------------------------ blocks


def _proj_in(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(h.shape[:-1] + w.shape[1:])


def _dense_ffn(h, wi_g, wi_u, wo):
    return (F.silu(h @ wi_g) * (h @ wi_u)) @ wo


@functools.lru_cache(maxsize=64)
def _mesh_specs(cfg: LMConfig, ctx: ShardCtx, batch: int) -> tuple:
    """The top leaves' specs, a layer's (``param_specs``, the layer axis
    dropped) and the cache's at ``batch`` (``cache_specs``): computed once
    for each config, ctx and batch, not at every decode step."""
    specs = param_specs(cfg, ctx.grid, ctx.rules)
    top = {k: v for k, v in specs.items() if k != "layers"}
    layer = {k: v[1:] for k, v in specs["layers"].items()}
    cache = cache_specs(cfg, ctx.grid, ctx.rules,
                        seq_shard=ctx.cache_seq_shard, batch=batch)["k"]
    return top, layer, cache


def _moe_dims(cfg: LMConfig) -> moe_lib.MoEDims:
    return moe_lib.MoEDims(cfg.n_experts, cfg.top_k, cfg.d_model,
                           cfg.d_ff_expert, cap_factor=cfg.moe_cap_factor)


class _Mesh:
    """A call's view of its mesh: the rank's grid, the layer specs, the
    attention mode, and the spec entries of the activations between
    blocks (batch over ``dp`` and, outside decode, sequence over ``tp``,
    each where it divides; under the expert-parallel MoE each must
    divide)."""

    def __init__(self, cfg: LMConfig, ctx: ShardCtx, batch: int, seq: int,
                 decode: bool):
        if cfg.moe and ctx.moe_impl == "ep":
            moe_lib.check_ep(_moe_dims(cfg), ctx.grid, batch, seq,
                             dp=ctx.rules.dp, tp=ctx.rules.tp, decode=decode)
        self.grid, self.rules, self.ctx = ctx.grid, ctx.rules, ctx
        self.tp = (ctx.rules.tp,)
        self.top, self.layer, cache = _mesh_specs(cfg, ctx, batch)
        self.mode = _attn_mode(cfg, ctx)
        self.b = shard_dim(ctx.grid, batch, ctx.rules.dp)
        self.s = None if decode else shard_dim(ctx.grid, seq, ctx.rules.tp)
        self.cache = cache if decode else None   # decode: the cache's spec

    def rows(self, n: int) -> slice:
        """The rank's block of the batch."""
        return block(self.b, n, self.grid)

    def fsdp(self, w: torch.Tensor, spec) -> torch.Tensor:
        """``w`` with its ``fsdp``-sharded dimensions all-gathered."""
        fs = tuple(self.rules.fsdp)
        for d, e in enumerate(spec):
            if entry_axes(e) == fs:
                w = self.grid.all_gather_dim(w, d, fs)
        return w

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """A sequence-sharded activation whole along ``dim``."""
        if self.s is None:
            return x
        return self.grid.all_gather_dim(x, dim, self.tp)

    def tp_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-parallel output's partials summed over ``tp``: scattered
        along the sequence between sharded blocks, else all-reduced."""
        if self.s is not None:
            return self.grid.reduce_scatter(partial, 1, self.tp)
        return self.grid.all_reduce(partial, "sum", self.tp)

    def local_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of a whole sequence (no collective)."""
        if self.s is None:
            return x
        sl = block(self.s, x.shape[1], self.grid)
        return x[:, sl]

    def sharded(self, name: str, dim: int) -> bool:
        return bool(entry_axes(self.layer[name][dim]))


def _attention(x, lp, cfg: LMConfig, cos, sin, *, cache=None, pos=None,
               mesh: Optional[_Mesh] = None):
    """Returns (attention output, (k, v)): the new keys and values over the
    sequence, or with ``cache`` the layer's caches with this step's written."""
    if mesh is not None:
        return _attention_mesh(x, lp, cfg, cos, sin, mesh, cache=cache,
                               pos=pos)
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


def _attention_mesh(x, lp, cfg: LMConfig, cos, sin, mesh: _Mesh, *,
                    cache=None, pos=None):
    """``_attention`` on a rank (the module docstring): ``x`` is the rank's
    block, ``cos`` / ``sin`` at the positions of the rows it projects."""
    spec = mesh.layer
    wq, wk, wv, wo = (mesh.fsdp(lp[n], spec[n])
                      for n in ("wq", "wk", "wv", "wo"))
    h = rmsnorm(x, lp["ln1"])
    context = mesh.mode == "context"
    if cache is None and not context:
        h = mesh.gather_seq(h)       # heads mode: every position, own heads
    q = apply_rope(_proj_in(h, wq), cos, sin, style=cfg.rope_style)
    k = apply_rope(_proj_in(h, wk), cos, sin, style=cfg.rope_style)
    v = _proj_in(h, wv)
    if cache is None:
        q_chunk, q_offset = cfg.q_chunk, 0
        if context:                  # own queries, every key
            k, v = mesh.gather_seq(k), mesh.gather_seq(v)
            q_chunk = q.shape[1]
            if mesh.s is not None:
                q_offset = block(mesh.s, k.shape[1], mesh.grid).start
        o = flash_attention(q, k, v, causal=True, window=cfg.window,
                            q_chunk=q_chunk, kv_chunk=cfg.kv_chunk,
                            q_offset=q_offset)
        kv = (k, v)
    else:
        o, kv = _decode_mesh(q, k, v, cache, pos, cfg, mesh)
    out = o.reshape(o.shape[:2] + (-1,)) @ wo.reshape(-1, wo.shape[-1])
    if mesh.sharded("wo", 0):        # row-parallel over the heads
        out = mesh.tp_sum(out)
    return out, kv


def _decode_mesh(q, k, v, cache, pos, cfg: LMConfig, mesh: _Mesh):
    """Write this step's keys and values where the rank's cache shard
    holds ``pos``, and attend over the cache (split over its sequence
    axes, if any). ``pos`` is the rank's batch block's."""
    k_cache, v_cache = cache
    b_cache, s_cache = mesh.cache[1], mesh.cache[2]
    widen = entry_axes(mesh.b) != entry_axes(b_cache)
    if widen:                        # the cache holds every request
        q, k, v, pos = (mesh.grid.all_gather_dim(t, 0, entry_axes(mesh.b))
                        for t in (q, k, v, pos))
    S = k_cache.shape[1]
    s0 = S * mesh.grid.index(entry_axes(s_cache)) if entry_axes(s_cache) \
        else 0
    here = (pos >= s0) & (pos < s0 + S)
    b_idx = torch.arange(q.shape[0], device=q.device)[here]
    k_cache[b_idx, pos[here] - s0] = k[here, 0]
    v_cache[b_idx, pos[here] - s0] = v[here, 0]
    o = decode_attention(q, k_cache, v_cache, pos, window=cfg.window,
                         k_offset=s0, grid=mesh.grid,
                         axes=entry_axes(s_cache))
    if widen:
        o = o[block(mesh.b, o.shape[0], mesh.grid)]
    return o, (k_cache, v_cache)


def _ffn_block(x, lp, cfg: LMConfig, mesh: Optional[_Mesh], *,
               decode: bool):
    """The FFN sublayer's output; on a mesh the MoE by ``moe_impl``, the
    expert-parallel one by ``decode`` (a decode step or not)."""
    h = rmsnorm(x, lp["ln2"])
    if not cfg.moe:
        return _ffn(h, lp, ("wi_g", "wi_u", "wo_ff"), mesh)
    dims = _moe_dims(cfg)
    if mesh is not None and mesh.ctx.moe_impl == "ep":
        ep = moe_lib.moe_ep_decode if decode else moe_lib.moe_ep_train
        y = ep(h, lp["router"], lp["e_wi_g"], lp["e_wi_u"], lp["e_wo"], dims,
               mesh.grid, dp=mesh.rules.dp, tp=mesh.rules.tp,
               fsdp=mesh.rules.fsdp)
    elif mesh is None or not mesh.sharded("e_wi_g", 0):
        w = [lp[n] if mesh is None else mesh.fsdp(lp[n], mesh.layer[n])
             for n in ("e_wi_g", "e_wi_u", "e_wo")]
        y = moe_lib.moe_reference(h, lp["router"], *w, dims)
    else:                            # the rank's experts over every token
        w = [mesh.fsdp(lp[n], mesh.layer[n])
             for n in ("e_wi_g", "e_wi_u", "e_wo")]
        e0 = block(mesh.layer["e_wi_g"][0], cfg.n_experts, mesh.grid).start
        part = moe_lib.moe_partial(mesh.gather_seq(h), lp["router"], *w,
                                   dims, e0)
        y = mesh.tp_sum(part).to(h.dtype)
    if cfg.n_shared_experts:
        y = y + _ffn(h, lp, ("s_wi_g", "s_wi_u", "s_wo"), mesh)
    return y


def _ffn(h, lp, names, mesh: Optional[_Mesh]):
    """The SwiGLU FFN of weights ``names``: column-parallel in, row-parallel
    out over ``tp`` on a mesh (where ``d_ff`` divides)."""
    if mesh is None:
        return _dense_ffn(h, *(lp[n] for n in names))
    w = [mesh.fsdp(lp[n], mesh.layer[n]) for n in names]
    if not mesh.sharded(names[2], 0):
        return _dense_ffn(h, *w)
    return mesh.tp_sum(_dense_ffn(mesh.gather_seq(h), *w))


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


def _device(device, ctx: Optional[ShardCtx]) -> torch.device:
    if ctx is None or device is not None:
        return resolve_device(device)
    return torch.device(ctx.grid.device)


def _embed(params, tokens: torch.Tensor, cfg: LMConfig,
           mesh: Optional[_Mesh] = None) -> torch.Tensor:
    """The rows of ``tokens`` [b, T]; on a mesh vocab-parallel: each rank
    looks up the ids of its vocabulary block and the rows are summed over
    ``tp`` (one rank adds a row, the others zeros), then kept as the
    rank's sequence block. Under FSDP the table's ``D`` blocks stay where
    they are: the ranks of an fsdp group gather each other's ids, look
    them up in their own block and all-gather the rows along ``D`` (the
    values of a lookup in the gathered table, for the rows' bytes, not the
    table's)."""
    if mesh is None:
        return params["embed"][tokens.long()].to(cfg.dtype)
    emb = params["embed"]
    v_entry, d_entry = mesh.top["embed"]
    ids = tokens.long()
    fs = entry_axes(d_entry)
    if fs:                           # every member's ids, in fsdp order
        ids = mesh.grid.all_gather(ids, fs)
    if entry_axes(v_entry):
        ids = ids - block(v_entry, cfg.vocab, mesh.grid).start
        mine = (ids >= 0) & (ids < emb.shape[0])
        rows = torch.where(mine[..., None],
                           emb[ids.clamp(0, emb.shape[0] - 1)],
                           torch.zeros((), dtype=emb.dtype, device=emb.device))
    else:
        rows = emb[ids]
    if fs:                           # the rank's own ids' rows, whole D
        rows = mesh.grid.all_gather_dim(rows, rows.ndim - 1, fs)
        rows = rows[mesh.grid.index(fs)]
    if not entry_axes(v_entry):
        return mesh.local_seq(rows.to(cfg.dtype))
    return mesh.tp_sum(rows).to(cfg.dtype)


def _logits(params, x: torch.Tensor, mesh: Optional[_Mesh] = None):
    if mesh is None:
        return rmsnorm(x, params["final_norm"]) @ params["head"]
    head = mesh.fsdp(params["head"], mesh.top["head"])
    return mesh.gather_seq(rmsnorm(x, params["final_norm"])) @ head


def logits_spec(cfg: LMConfig, ctx: ShardCtx, batch: int, *,
                seq: bool = True) -> tuple:
    """The spec of the logits a rank returns: [B, S, V] from ``forward``
    (``seq``), [B, V] from ``prefill`` and ``decode_step``."""
    b = shard_dim(ctx.grid, batch, ctx.rules.dp)
    v = shard_dim(ctx.grid, cfg.vocab, ctx.rules.tp)
    return (b, None, v) if seq else (b, v)


def _run(params: dict, tokens: torch.Tensor, cfg: LMConfig,
         ctx: Optional[ShardCtx], dev: torch.device, keep=None):
    """The forward's logits; ``keep(i, k, v)`` receives each layer's keys
    and values."""
    _check(params, dev, tokens=tokens)
    B, S = tokens.shape
    mesh = None
    positions = torch.arange(S, device=dev)
    if ctx is not None:
        _check_ctx(cfg, ctx)
        mesh = _Mesh(cfg, ctx, B, S, decode=False)
        tokens = tokens[mesh.rows(B)]
        if mesh.mode == "context":   # the rank's queries: its positions
            positions = positions[block(mesh.s, S, mesh.grid)]
    x = _embed(params, tokens, cfg, mesh)
    cos, sin = rope_freqs(positions, cfg.d_head, cfg.rope_theta)

    def layer(x, lp):
        a, kv = _attention(x, lp, cfg, cos, sin, mesh=mesh)
        x = x + a
        return x + _ffn_block(x, lp, cfg, mesh, decode=False), kv

    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(_layers(params)):
        if remat:
            x, (k, v) = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, (k, v) = layer(x, lp)
        if keep is not None:
            keep(i, k, v)
    return _logits(params, x, mesh)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            ctx: Optional[ShardCtx] = None, *, return_cache: bool = False,
            device=None):
    """Teacher-forced forward over tokens int [B, S] -> logits [B, S, V]
    in ``cfg.dtype``; with ``return_cache`` also (k, v), each
    [L, B, S, KV, Dh]. Under ``ctx`` the rank's blocks: logits
    ``logits_spec``, k and v the rank's batch block and (heads mode) its
    KV heads, every position."""
    dev = _device(device, ctx)
    ks, vs = [], []

    def keep(i, k, v):
        ks.append(k)
        vs.append(v)

    logits = _run(params, tokens, cfg, ctx, dev,
                  keep if return_cache else None)
    if return_cache:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            ctx: Optional[ShardCtx] = None, *, device=None) -> torch.Tensor:
    """Mean next-token NLL in float32 over ``batch["tokens"]`` and
    ``batch["labels"]`` (int [B, S]); a label of -1 is masked out. A
    label at or past the vocabulary raises (the JAX package reads NaN
    there). Under ``ctx`` every rank returns the whole loss."""
    labels = batch["labels"].long()
    if bool((labels >= cfg.vocab).any()):
        raise ValueError(f"labels must lie below the vocabulary {cfg.vocab}")
    logits = forward(params, batch["tokens"], cfg, ctx, device=device)
    lf = logits.float()
    if ctx is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).to(torch.float32)
        nll = (logz - gold) * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    grid, tp = ctx.grid, (ctx.rules.tp,)
    b_entry, _, v_entry = logits_spec(cfg, ctx, labels.shape[0])
    labels = labels[block(b_entry, labels.shape[0], grid)]
    if entry_axes(v_entry):          # vocab-parallel log-sum-exp and gold
        m = grid.all_reduce(lf.amax(-1), "max", tp)
        se = grid.all_reduce(torch.exp(lf - m[..., None]).sum(-1), "sum", tp)
        logz = m + torch.log(se)
        lo = block(v_entry, cfg.vocab, grid).start
        ids = labels - lo
        mine = (ids >= 0) & (ids < lf.shape[-1])
        gold = torch.gather(lf, -1, ids.clamp(0, lf.shape[-1] - 1)[..., None])
        gold = grid.all_reduce(torch.where(mine, gold[..., 0], 0.0), "sum",
                               tp)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    sums = torch.stack([((logz - gold) * mask).sum(), mask.sum()])
    if entry_axes(b_entry):
        sums = grid.all_reduce(sums, "sum", entry_axes(b_entry))
    return sums[0] / torch.clamp_min(sums[1], 1.0)


class LM(_TreeModel):
    """The language model as a module over ``init_params``' tree:
    ``forward(tokens)`` is ``forward``'s logits."""
    init = staticmethod(init_params)
    apply = staticmethod(forward)


# ------------------------------------------------------------------ serving


def cache_specs(cfg: LMConfig, mesh, rules: AxisRules, *,
                seq_shard: bool = False, batch: int = 0) -> dict:
    """KV cache [L, B, S, KV, Dh] (the JAX package's ``cache_specs``):
    batch over ``dp``; KV heads over ``tp`` where they divide, otherwise
    the cache *sequence* over ``tp``; ``seq_shard`` (long_500k) puts the
    sequence over ``dp`` instead and leaves the batch whole."""
    dp, tp = rules.dp, rules.tp
    kv_ax = shard_dim(mesh, cfg.n_kv, tp)
    if seq_shard:
        spec_ = (None, None, dp, kv_ax, None)
    else:
        seq_tp = None if kv_ax is not None else tp
        spec_ = (None, shard_dim(mesh, batch, dp), seq_tp, kv_ax, None)
    return {"k": spec_, "v": spec_}


def cache_spec(cfg: LMConfig, ctx: ShardCtx, batch: int, seq: int) -> tuple:
    """``cache_specs``' spec of a cache of ``batch`` requests and ``seq``
    positions under ``ctx``, which must split evenly over its sequence
    axes (a rank's block of the cache then tells its layout:
    ``serve.generate`` rounds its length up)."""
    spec_ = cache_specs(cfg, ctx.grid, ctx.rules,
                        seq_shard=ctx.cache_seq_shard, batch=batch)["k"]
    n = axis_size(ctx.grid, spec_[2])
    if seq % n:
        raise ValueError(f"a cache of {seq} positions does not split over "
                         f"the sequence axes {entry_axes(spec_[2])} ({n})")
    return spec_


def init_cache(cfg: LMConfig, batch: int, seq: int, *, device=None,
               ctx: Optional[ShardCtx] = None) -> dict:
    """``{"k", "v"}``, each zeros [L, batch, seq, KV, Dh] in ``cfg.dtype``
    on ``device`` (default: the card, or the grid's device under ``ctx``;
    raises when there is none); under ``ctx`` the rank's block of it."""
    dev = _device(device, ctx)
    shp = (cfg.n_layers, batch, seq, cfg.n_kv, cfg.d_head)
    if ctx is not None:
        spec_ = cache_spec(cfg, ctx, batch, seq)
        shp = tuple(n // axis_size(ctx.grid, e) for n, e in zip(shp, spec_))
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=dev)}


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            ctx: Optional[ShardCtx] = None, *, cache_len: Optional[int] = None,
            device=None):
    """The forward over the prompt: (the last position's logits [B, V],
    the cache ``{"k", "v"}`` of the prompt, [L, B, cache_len, KV, Dh]
    each, zeros past the prompt; ``cache_len`` defaults to the prompt's
    length). Under ``ctx`` the rank's blocks: the logits ``logits_spec``,
    the cache the spec ``cache_specs`` gives (the sequence split only where
    ``cache_len`` divides)."""
    dev = _device(device, ctx)
    B, S = tokens.shape
    n = S if cache_len is None else int(cache_len)
    if n < S:
        raise ValueError(f"cache_len {n} is below the prompt's {S}")
    ks, vs = [], []
    if ctx is None:
        def keep(i, k, v):
            ks.append(k)
            vs.append(v)
    else:
        want = cache_spec(cfg, ctx, B, n)[1:]
        mesh = _Mesh(cfg, ctx, B, S, decode=False)
        kv_h = mesh.layer["wk"][1] if mesh.mode == "heads" else None
        have = (mesh.b, None, kv_h, None)

        def keep(i, k, v):
            for out, t in ((ks, k), (vs, v)):
                t = F.pad(t, (0, 0, 0, 0, 0, n - S))
                out.append(reshard(t, have, want, ctx.grid))

    logits = _run(params, tokens, cfg, ctx, dev, keep)
    k, v = torch.stack(ks), torch.stack(vs)
    if ctx is None and n > S:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, n - S)) for t in (k, v))
    return logits[:, -1], {"k": k, "v": v}


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig,
                ctx: Optional[ShardCtx] = None, *, device=None):
    """token int [B] at positions pos int [B] (each below the cache's
    length) -> (logits [B, V], cache): the cache written in place at
    ``pos`` and returned. Under ``ctx`` the cache is the rank's block
    (``cache_specs``), token and pos the whole batch, and the logits the
    rank's block (``logits_spec(seq=False)``)."""
    dev = _device(device, ctx)
    _check(params, dev, cache=cache, token=token, pos=pos)
    pos = pos.long()
    mesh = None
    if ctx is not None:
        _check_ctx(cfg, ctx)
        mesh = _Mesh(cfg, ctx, token.shape[0], 1, decode=True)
        rows = mesh.rows(token.shape[0])
        token, pos = token[rows], pos[rows]
    x = _embed(params, token[:, None], cfg, mesh)
    cos, sin = rope_freqs(pos[:, None], cfg.d_head, cfg.rope_theta)
    for i, lp in enumerate(_layers(params)):
        a, _ = _attention(x, lp, cfg, cos, sin,
                          cache=(cache["k"][i], cache["v"][i]), pos=pos,
                          mesh=mesh)
        x = x + a
        x = x + _ffn_block(x, lp, cfg, mesh, decode=True)
    return _logits(params, x, mesh)[:, 0], cache
