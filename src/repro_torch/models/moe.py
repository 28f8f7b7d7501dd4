"""The Mixture-of-Experts FFN's reference path, the port of the JAX
package's ``repro/models/moe.py``: ``MoEDims``, the router, the SwiGLU
expert FFN and ``moe_reference``, in which every expert runs over every
token and a masked combine keeps the routed ones (O(E N D F) FLOPs).

The expert-parallel paths ``moe_ep_train`` and ``moe_ep_decode`` (and
their ``_pack``) dispatch tokens over a device mesh; they wait for the
sharding slice.

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
