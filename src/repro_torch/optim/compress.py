"""Int8 error-feedback gradient compression, the port of the JAX package's
``repro/optim/compress.py``.

Each gradient leaf plus its error buffer is quantised to int8 under a
per-leaf float32 scale (``max|g| / 127``); the dequantised gradient goes on
to the optimiser and the quantisation residual stays in the error buffer
for the next step. ``torch.round`` rounds half to even, as ``jnp.round``
does, and the residual is taken with one fused multiply-add as XLA
computes it, so ``q``, the dequantised gradient and the error buffer equal
the JAX package's bit for bit on the CPU.
"""
from __future__ import annotations

import torch

from .. import pytree


@torch.no_grad()
def int8_compress_ef(grads, error):
    """Returns ``(dequantised grads, new error)``; ``error`` matches
    ``grads`` (None: zeros). In place: the dequantised gradient is written
    into each gradient leaf and the residual into each error leaf, and the
    two trees are returned."""
    if error is None:
        error = pytree.tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    for g, e in zip(pytree.leaves(grads), pytree.leaves(error)):
        e.add_(g.float())                               # g32 = g + e
        scale = torch.clamp(e.abs().max(), min=1e-12) / 127.0
        q = torch.round(e / scale).clamp_(-127, 127)    # int8 values
        g.copy_(q * scale)
        e.addcmul_(q, scale, value=-1.0)                # fma(-q, scale, g32)
    return grads, error
