"""Transformer building blocks, the port of the JAX package's
``repro/models/layers.py``: RMSNorm, RoPE and attention.

``flash_attention`` is the same online softmax over chunks of keys, run
chunk of queries by chunk of queries, so its temporaries are O(S * chunk),
never O(S^2): the JAX package's nested scans become two Python loops. The
numerics follow the JAX package's:

* the scores and the PV product accumulate in float32 (its
  ``preferred_element_type=float32``): a bfloat16 ``torch.matmul`` would
  round its output to bfloat16, so q and k, and p and v for the PV
  product, are cast to float32 first. A product of two bfloat16 values is
  exact in float32, so this is the same sum;
* ``p`` is rounded to ``v``'s dtype before the PV product;
* a masked score is ``NEG_INF = -1e30``, not ``-inf``: a window row whose
  first key chunks are all masked then accumulates ``exp(0)`` terms that a
  later chunk's ``exp(-1e30 - m)`` correction wipes out, where ``-inf``
  would give NaN;
* padded queries are sliced off, padded keys masked by ``k_pos < Skv``;
* grouped-query attention: query head ``h`` reads key/value head
  ``h // G`` (heads laid out ``[KV, G]``).

Under a device mesh (``models.transformer``'s context mode) a rank's
queries are a block of the sequence: ``flash_attention``'s ``q_offset`` is
the global position of its first row, which the causal and window masks
compare with the keys' global positions. ``decode_attention`` over a
shard of the cache's sequence takes the shard's global offset
(``k_offset``) and the grid and axes the sequence is split over, and
combines the shards as GSPMD partitions the JAX package's softmax: the
global max (a MAX all-reduce), the global sum of ``exp(s - m)`` (a SUM),
then each shard's ``(p / max(l, 1e-30))`` rounded to ``v``'s dtype times
its values in float32, SUM-reduced; not flash-decoding's rescale of
per-shard (output, sum) pairs, which rounds differently in bfloat16.

The JAX package's ``rope_freqs`` promotes a bfloat16 ``x`` times float32
cos / sin to float32 and casts back at the end; PyTorch's type promotion
does the same.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x)`` in float32, cast to ``x``'s dtype, then times
    ``scale`` in that dtype (the JAX package's order)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(positions: torch.Tensor, d_head: int,
               theta: float = 10000.0) -> tuple:
    """positions int[...] -> (cos, sin), each float32 [..., d_head // 2]."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               style: str = "half") -> torch.Tensor:
    """x [..., S, H, Dh]; cos / sin [..., S, Dh // 2].

    ``"half"``: the llama rotate-half pairing (i, i + Dh/2);
    ``"interleaved"``: the GPT-NeoX pairing (2i, 2i + 1)."""
    if style not in ("half", "interleaved"):
        raise ValueError(f"style must be 'half' or 'interleaved', got "
                         f"{style!r}")
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    if style == "half":
        x1, x2 = torch.chunk(x, 2, dim=-1)
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        return torch.cat([r1, r2], dim=-1).to(x.dtype)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:  # iRoPE-style local attention within chunks
        m &= (q_pos[:, None] // window) == (k_pos[None, :] // window)
    return m


def _pad_seq(x: torch.Tensor, mult: int) -> torch.Tensor:
    extra = -x.shape[1] % mult
    if not extra:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], extra) + x.shape[2:])],
                     dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, Dh], k / v [B, Skv, KV, Dh] (GQA: H = KV * G) ->
    [B, Sq, H, Dh] in q's dtype; query row i sits at position
    ``q_offset + i``, key j at j.

    Online softmax over chunks of ``kv_chunk`` keys, for each chunk of
    ``q_chunk`` queries; every temporary is [B, KV, G, q_chunk, kv_chunk]."""
    B, Sq, H, Dh = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    Sq0, Skv0 = Sq, Skv
    q = _pad_seq(q, q_chunk)          # padded query rows are sliced off
    k = _pad_seq(k, kv_chunk)         # padded keys are masked: k_pos >= Skv0
    v = _pad_seq(v, kv_chunk)
    Sq, Skv = q.shape[1], k.shape[1]
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = Dh ** -0.5
    dev = q.device

    # [nq, B, KV, G * q_chunk, Dh] and [nk, B, KV, kv_chunk, Dh]
    qr = q.reshape(B, nq, q_chunk, KV, G, Dh).permute(1, 0, 3, 4, 2, 5) \
        .reshape(nq, B, KV, G * q_chunk, Dh)
    kr = k.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    vr = v.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    k_valid = torch.arange(Skv, device=dev) < Skv0

    outs = []
    for iq in range(nq):
        qi = qr[iq].float()
        q_pos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dh), dtype=torch.float32,
                          device=dev)
        for jk in range(nk):
            kj, vj = kr[jk], vr[jk]
            k_pos = jk * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.matmul(qi, kj.float().transpose(-1, -2)).reshape(
                B, KV, G, q_chunk, kv_chunk) * scale
            mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window)
            mask = mask & k_valid[jk * kv_chunk:(jk + 1) * kv_chunk][None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(
                p.to(vj.dtype).float().reshape(B, KV, G * q_chunk, kv_chunk),
                vj.float()).reshape(B, KV, G, q_chunk, Dh)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    # [nq, B, KV, G, q_chunk, Dh] -> [B, Sq, H, Dh]
    o = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, Dh)
    return o[:, :Sq0].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None, k_offset: int = 0,
                     grid=None, axes: tuple = ()) -> torch.Tensor:
    """One token against a cache: q [B, 1, H, Dh], caches [B, S, KV, Dh],
    pos int[B] (the index being written; keys at ``k_pos <= pos`` count).
    The softmax runs in float32 over the whole cache axis.

    With ``axes``, the caches are this rank's shard of a sequence split
    over ``axes`` of ``grid``, its first position ``k_offset``: the max,
    the sum and the output are reduced over them (module docstring)."""
    B, S, KV, Dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, Dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * (Dh ** -0.5)
    k_pos = k_offset + torch.arange(S, device=q.device)
    pos = pos.to(k_pos.dtype)
    valid = k_pos[None] < pos[:, None] + 1
    if window is not None:
        valid &= (k_pos[None] // window) == (pos[:, None] // window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if axes:
        m = grid.all_reduce(m, "max", axes)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if axes:
        l = grid.all_reduce(l, "sum", axes)
    w = (p / torch.clamp_min(l, 1e-30)).to(v_cache.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    if axes:
        o = grid.all_reduce(o, "sum", axes)
    return o.reshape(B, 1, H, Dh).to(q.dtype)
