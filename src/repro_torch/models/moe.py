"""The Mixture-of-Experts FFN's reference path, the port of the JAX
package's ``repro/models/moe.py``: ``MoEDims``, the router, the SwiGLU
expert FFN and ``moe_reference``, in which every expert runs over every
token and a masked combine keeps the routed ones (O(E N D F) FLOPs).

On a mesh under ``ShardCtx(moe_impl="reference")`` the experts are split
over ``tp`` (``transformer.param_specs``): each rank runs
``moe_partial``, its own experts over every token, and the float32
partial outputs are SUM-reduced over ``tp`` before the cast back. The
router is whole on every rank, so every rank routes alike. The
expert-parallel paths ``moe_ep_train`` and ``moe_ep_decode`` (and their
``_pack``), which dispatch tokens over the mesh with all-to-alls, are not
ported yet (ROADMAP module queue 2.2).

Numerics as in the JAX package: the router's logits and softmax are
float32; the top-k gates are renormalised with ``max(sum, 1e-9)``; the
expert FFN runs in the weights' dtype (bfloat16 in, bfloat16 out) and the
combine in float32, cast back to the input's dtype at the end.
``lax.top_k`` breaks ties toward the lower index, which ``torch.topk``
does not promise; with random weights no two probabilities tie.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    cap_factor: float = 2.0


def _router(tokens: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """tokens [N, D] -> (gates float32 [N, k], renormalised; eids int32
    [N, k]), the k largest probabilities in descending order."""
    logits = tokens.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eids.to(torch.int32)


def _expert_ffn(buf: torch.Tensor, wi_g: torch.Tensor, wi_u: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D]: SwiGLU with each expert's weights."""
    g = torch.bmm(buf, wi_g)
    u = torch.bmm(buf, wi_u)
    return torch.bmm(F.silu(g) * u, wo)


def moe_reference(x: torch.Tensor, w_router: torch.Tensor,
                  wi_g: torch.Tensor, wi_u: torch.Tensor, wo: torch.Tensor,
                  dims: MoEDims) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: every expert over every token, each
    token's output the gate-weighted sum of its top-k experts' outputs."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    gates, eids = _router(tokens, w_router, dims.top_k)
    mask = F.one_hot(eids.long(), dims.n_experts).to(gates.dtype)  # [N,k,E]
    comb = (gates[..., None] * mask).sum(dim=1)                     # [N, E]
    outs = _expert_ffn(tokens.expand(dims.n_experts, -1, -1),
                       wi_g, wi_u, wo)                               # [E,N,D]
    y = torch.einsum("ne,end->nd", comb, outs.to(gates.dtype))
    return y.reshape(B, S, D).to(x.dtype)


def moe_partial(x: torch.Tensor, w_router: torch.Tensor, wi_g: torch.Tensor,
                wi_u: torch.Tensor, wo: torch.Tensor, dims: MoEDims,
                e0: int) -> torch.Tensor:
    """``moe_reference``'s float32 sum restricted to the experts
    ``[e0, e0 + wi_g.shape[0])`` (one rank's block): x [B, S, D] ->
    float32 [B, S, D], before the cast. The partials of all blocks sum to
    ``moe_reference``'s output in float32."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    gates, eids = _router(tokens, w_router, dims.top_k)
    mask = F.one_hot(eids.long(), dims.n_experts).to(gates.dtype)
    comb = (gates[..., None] * mask).sum(dim=1)[:, e0:e0 + wi_g.shape[0]]
    outs = _expert_ffn(tokens.expand(wi_g.shape[0], -1, -1), wi_g, wi_u, wo)
    y = torch.einsum("ne,end->nd", comb, outs.to(gates.dtype))
    return y.reshape(B, S, D)
