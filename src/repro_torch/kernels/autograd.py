"""Kernels 7 and 2g under autograd: the routes a training step takes.

The JAX package has no backward kernel: ``jax.grad`` differentiates its
jnp paths. These ``torch.autograd.Function``s give the port's kernels the
same gradients. Each forward is the kernel's wrapper (``kernels.ops``): its
CUDA kernel on a card tensor, its plain version on a CPU tensor. The
wrappers themselves refuse tensors that autograd would have to see
through; a ``Function`` is the one route under grad mode.

* ``bag_lookup`` (kernel 7): the backward scatters each bag's gradient into
  a dense gradient of each table with ``index_add_``, divided by the bag's
  count of ids under ``mean``; pads and ids past the table add nothing.
  That is ``jax.grad`` of the JAX package's jnp lookup. On the card
  ``index_add_`` adds with atomics in no fixed order, so a training step
  there is not bit-reproducible run to run; a hand-written backward with a
  fixed order is a speed item, not a parity need.
* ``gcn_aggregate`` (kernel 2g): on a symmetric layout
  (``core.formats.is_symmetric``) the normalised adjacency is symmetric,
  ``w(v, u) = w(u, v)``, so the gradient of ``Y = A X`` is ``A dY``: the
  same sweep, run on the output's gradient. On a layout that is not
  symmetric the backward raises: it needs the transposed sweep, which the
  port does not have. ``deg`` takes no gradient.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.formats import is_symmetric
from ..core.semiring import REAL
from . import ops


class _BagLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bags, mode, *tables):
        ctx.save_for_backward(bags)
        ctx.mode = mode
        ctx.rows = [t.shape[0] for t in tables]
        return ops.embedding_bag_grouped(list(tables), bags, mode)

    @staticmethod
    def backward(ctx, grad):
        bags, = ctx.saved_tensors
        grad = grad.contiguous()
        if ctx.mode == "mean":
            count = (bags >= 0).sum(dim=2, keepdim=True).clamp_min(1)
            grad = grad / count
        B, _, K = bags.shape
        d = grad.shape[-1]
        out = []
        for t, V in enumerate(ctx.rows):
            if not ctx.needs_input_grad[2 + t]:
                out.append(None)
                continue
            ids = bags[:, t]
            keep = (ids >= 0) & (ids < V)
            src = grad[:, t, None, :].expand(B, K, d)[keep]
            table_grad = grad.new_zeros((V, d))
            out.append(table_grad.index_add_(0, ids[keep].long(), src))
        return (None, None, *out)


def bag_lookup(tables: Sequence[torch.Tensor], bags: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """``ops.embedding_bag_grouped(tables, bags, mode)`` (-> [B, T, d], a
    new tensor) with a gradient for each table that requires one."""
    return _BagLookup.apply(bags, mode, *tables)


class _GCNAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiled, X, deg):
        ctx.tiled = tiled
        ctx.save_for_backward(deg)
        return ops.spmm(REAL, tiled, X, deg=deg)

    @staticmethod
    def backward(ctx, dY):
        deg, = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None
        if not is_symmetric(ctx.tiled):
            raise NotImplementedError(
                "the GCN aggregation's gradient on a layout whose adjacency "
                "is not symmetric needs the transposed sweep (A^T dY), which "
                "the port does not have; build the layout from an undirected "
                "CSR")
        return None, ops.spmm(REAL, ctx.tiled, dY.contiguous(), deg=deg), None


def gcn_aggregate(tiled, X: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``ops.spmm(REAL, tiled, X, deg=deg)``, the GCN aggregation, with a
    gradient for X: the same sweep over the output's gradient, on a
    symmetric layout only. ``deg`` takes no gradient: one that requires
    one is refused under grad mode."""
    if torch.is_grad_enabled() and deg.requires_grad:
        raise ValueError("the GCN aggregation takes no gradient for deg; pass "
                         "deg.detach()")
    return _GCNAggregate.apply(tiled, X, deg)
