"""The generic train step, the port of the JAX package's
``repro/train/step.py``: loss and gradient, clip, optional int8
error-feedback compression, optimiser update, ``step + 1``.

The gradient is ``torch.autograd.grad`` of the loss over the weight
leaves (the JAX package's ``jax.value_and_grad``); a leaf the loss does not
reach gets a zero gradient, as ``jax.grad`` gives it. The clip, the
compression and the update work in place (``optim``): the step returns the
tensors it was given, the weights and the state updated, where the JAX
package's launchers donate them.
"""
from __future__ import annotations

import torch

from .. import pytree
from ..optim import Optimizer, clip_by_global_norm, int8_compress_ef


def _owned(leaves, grads) -> list:
    """The gradients as tensors the clip and the optimiser may write in
    place: a zero tensor where the loss does not reach a leaf, and a dense
    copy of one that autograd returned expanded (stride 0, as the backward
    of a sum gives) or that another leaf's gradient already is."""
    seen, out = set(), []
    for p, g in zip(leaves, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif not g.is_contiguous() or (g.numel() and g.data_ptr() in seen):
            g = g.clone(memory_format=torch.contiguous_format)
        if g.numel():
            seen.add(g.data_ptr())
        out.append(g)
    return out


def make_train_step(loss_fn, optimizer: Optimizer, *, grad_clip: float = 1.0,
                    compress: bool = False):
    """``loss_fn(params, batch) -> scalar``. Returns ``train_step(params,
    state, batch) -> (params, state, {"loss", "grad_norm"})`` and
    ``init_state(params)`` (``{"opt", "step"}``, and ``"ef"`` with
    ``compress``: the JAX package's keys). Every weight leaf must be a
    floating-point leaf tensor; the step sets ``requires_grad`` on those
    that lack it."""

    def init_state(params):
        leaves = pytree.leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        state = {"opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if compress:
            state["ef"] = pytree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return state

    def train_step(params, state, batch):
        leaves, treedef = pytree.flatten(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = pytree.unflatten(treedef, _owned(leaves, grads))
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        if compress:
            grads, ef = int8_compress_ef(grads, state["ef"])
        params, opt = optimizer.update(grads, state["opt"], params,
                                       state["step"])
        new_state = {"opt": opt, "step": state["step"] + 1}
        if compress:
            new_state["ef"] = ef
        return params, new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, init_state
