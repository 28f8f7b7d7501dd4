"""Plain PyTorch versions of the kernels that are not SlimSell sweeps.

``embedding_bag_ref`` is the counterpart of the JAX package's
``repro/kernels/ref.py::embedding_bag_ref``: what the embedding-bag kernel
(``kernels/csrc/embedding_bag.cu``) computes, in plain tensor operations.
It is the CPU path of the wrapper ``kernels.ops.embedding_bag`` and the
reference the kernel is checked against on the card.
``embedding_bag_grouped_ref`` is the same over several tables at once, the
plain version of the grouped entry (``kernels.ops.embedding_bag_grouped``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.options import check_choice

BAG_MODES = ("sum", "mean")


def embedding_bag_ref(table: torch.Tensor, bags: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """table float[V, d], bags int[B, K] (-1 pads) -> [B, d].

    Each bag is the sum of the table rows its ids name, taken in slot order
    (``acc += row`` for k = 0..K-1, a pad adding nothing), so the kernel,
    which adds in the same order, agrees with it bit for bit. Under
    ``mean`` the sum is divided by ``max(count, 1)``, the count of ids that
    are not pads: a bag of only pads gives zeros in both modes. An id at or
    past V reads no row and makes its bag NaN, as ``jnp.take`` does in the
    JAX package's version."""
    check_choice("embedding_bag mode", mode, BAG_MODES)
    if table.ndim != 2 or bags.ndim != 2:
        raise ValueError(f"expected table [V, d] and bags [B, K], got "
                         f"{tuple(table.shape)} and {tuple(bags.shape)}")
    V = table.shape[0]
    pad = bags < 0
    outside = bags >= V
    safe = torch.where(pad | outside, 0, bags).long()
    out = table.new_zeros((bags.shape[0], table.shape[1]))
    for k in range(bags.shape[1]):
        row = table.index_select(0, safe[:, k])
        row = torch.where(outside[:, k, None], float("nan"), row)
        out = out + torch.where(pad[:, k, None], 0.0, row)
    if mode == "mean":
        out = out / (~pad).sum(dim=1, keepdim=True).clamp_min(1)
    return out


def embedding_bag_grouped_ref(tables: Sequence[torch.Tensor], bags: torch.Tensor,
                              mode: str = "sum",
                              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T tables float[V_t, d], bags int[B, T, K] (-1 pads) -> [B, T, d]:
    ``embedding_bag_ref`` of table t over field t, written into ``out[:,
    t]`` (allocated when not given) one table at a time."""
    if bags.ndim != 3 or bags.shape[1] != len(tables):
        raise ValueError(f"expected bags [B, {len(tables)}, K] for "
                         f"{len(tables)} tables, got {tuple(bags.shape)}")
    if out is None:
        out = tables[0].new_empty((bags.shape[0], len(tables),
                                   tables[0].shape[1]))
    for t, table in enumerate(tables):
        out[:, t] = embedding_bag_ref(table, bags[:, t], mode)
    return out
