"""Optimizers as ``(init, update)`` pairs over trees of tensors, the port of
the JAX package's ``repro/optim/optimizers.py``: AdamW, Muon, SGD and the
gradient utilities.

The contract is the JAX package's: ``init(params) -> state`` and
``update(grads, state, params, step) -> (params, state)``, ``step`` the
0-d int32 count of updates made so far, and the state laid out as there
(AdamW ``{"m": tree, "v": tree}``; SGD one momentum tree; Muon a
``{"mom", "m", "v"}`` dict for each weight), so a state crosses between
the packages (``convert.opt_state_from_arrays``, ``checkpoint``).

**In place.** Where the JAX package's launchers donate the weights and the
state, ``update`` writes the new weights and state into the tensors it was
given, under ``torch.no_grad()``, and returns them; the gradients are its
scratch and hold garbage afterwards. ``clip_by_global_norm`` scales the
gradients in place. So a step holds the weights, the gradients, the state
and the temporaries of one leaf, no second copy of any tree: AdamW at
2^22-row DLRM tables is 4 x 12.82 GB, and a second copy would not fit one
80 GB card.

**The same arithmetic.** XLA contracts ``a * b + c`` into one fused
multiply-add on the CPU. Each update is written so that PyTorch's kernels
make the same roundings: ``torch.add(c, b, alpha=a)`` and
``addcmul(..., value=)`` where XLA fuses, the bias corrections
``1 - b ** t`` in float32 (``t`` a float32 tensor, as in the JAX package;
Python's ``0.9 ** 3`` is float64 and gives other bits). On the CPU, AdamW's
and SGD's moments then equal the JAX package's jitted update bit for bit,
and the weights differ at most by the last bit of a square root (PyTorch's
vectorised ``sqrt`` on the CPU is not correctly rounded everywhere).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import pytree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple]
    # update(grads, state, params, step) -> (params, state), in place


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, float32, on the leaves' device."""
    leaves = pytree.leaves(tree)
    total = sum(torch.sum(torch.square(l.float())) for l in leaves)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf of ``tree`` in place by ``min(1, max_norm /
    max(norm, 1e-9))``; returns ``(tree, norm)``, the norm before
    scaling. The scale stays on the device: no host sync."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    leaves = pytree.leaves(tree)
    if leaves:
        torch._foreach_mul_(leaves, scale)
    return tree, g


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """``1 - b1 ** t`` and ``1 - b2 ** t``, t = step + 1, in float32."""
    t = step.to(torch.float32) + 1.0
    one = torch.ones((), dtype=torch.float32, device=t.device)
    return (one - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), t),
            one - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t))


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    if new is not p:
        p.copy_(new)


def _adam_leaf(g, m, v, p, *, lr, b1, b2, eps, weight_decay, bc1, bc2) -> None:
    """One AdamW update of a leaf, in place: m, v, then p; ``g`` is used as
    scratch. The JAX package's order of roundings:
    ``m = fma(b1, m, (1 - b1) g)``, ``v = fma(b2, v, ((1 - b2) g) g)``,
    ``u = (m / bc1) / (sqrt(v / bc2) + eps)``, ``u = fma(wd, p, u)``,
    ``p = fma(-lr, u, p)``."""
    g = g.float()
    sq = (g * (1 - b2)).mul_(g)
    torch.add(sq, v, alpha=b2, out=v)
    del sq
    torch.add(g.mul_(1 - b1), m, alpha=b1, out=m)
    u = torch.div(m, bc1, out=g)                       # g is dead: reuse it
    u.div_(torch.div(v, bc2).sqrt_().add_(eps))
    p32 = p.float()
    if weight_decay:
        u.add_(p32, alpha=weight_decay)
    p32.add_(u, alpha=-lr)
    _write(p, p32)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": pytree.tree_map(zeros, params),
                "v": pytree.tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        bc1, bc2 = _bias_corrections(step, b1, b2)
        for g, m, v, p in zip(*(pytree.leaves(t) for t in (
                grads, state["m"], state["v"], params))):
            _adam_leaf(g, m, v, p, lr=lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, bc1=bc1, bc2=bc2)
        return params, state

    return Optimizer(init, update)


def _newton_schulz(G: torch.Tensor, steps: int = 5,
                   eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalize the trailing 2-D matrices of ``G`` (Muon's NS5
    iteration) in bfloat16, as the JAX package does: the norm's squares
    rounded to bfloat16 and summed in float32 (``jnp.sum``'s upcast), every
    product and sum after that in bfloat16, and the coefficients rounded to
    bfloat16 first (JAX's weakly typed Python floats take the array's
    type; PyTorch would multiply by the float32 value). Returns float32."""
    a, b, c = (torch.tensor(k, dtype=torch.bfloat16, device=G.device)
               for k in (3.4445, -4.7750, 2.0315))
    X = G.to(torch.bfloat16)
    transpose = G.shape[-2] > G.shape[-1]
    if transpose:
        X = X.transpose(-1, -2)
    norm = (X * X).float().sum(dim=(-2, -1), keepdim=True).to(
        torch.bfloat16).sqrt()
    X = X / (norm + eps)
    for _ in range(steps):
        A = X @ X.transpose(-1, -2)
        B = b * A + (c * A) @ A    # the JAX package's c * A @ A
        X = a * X + B @ X
    if transpose:
        X = X.transpose(-1, -2)
    return X.float()


def _is_state_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"mom", "m", "v"}


def muon(lr: float = 0.02, momentum: float = 0.95, ns_steps: int = 5,
         adam_lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8) -> Optimizer:
    """Muon on stacked layer weights (``ndim >= 3``), AdamW (no weight
    decay, ``adam_lr``) on the rest. A Muon leaf keeps one bfloat16
    momentum buffer ``mom`` and empty ``m`` / ``v``; an AdamW leaf an empty
    ``mom`` and float32 ``m`` / ``v``. The momentum and Newton-Schulz run
    one stacked layer at a time (the JAX package's ``lax.map``), so the
    temporaries are one layer's."""

    def is_muon(p):
        return p.ndim >= 3

    def init(params):
        def st(p):
            z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=p.device)
            if is_muon(p):
                return {"mom": z(p.shape, torch.bfloat16),
                        "m": z((0,), torch.float32), "v": z((0,), torch.float32)}
            return {"mom": z((0,), torch.bfloat16),
                    "m": z(p.shape, torch.float32), "v": z(p.shape, torch.float32)}
        return pytree.tree_map(st, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        bc1, bc2 = _bias_corrections(step, b1, b2)
        states = pytree.leaves(state, is_leaf=_is_state_leaf)
        for g, p, st in zip(pytree.leaves(grads), pytree.leaves(params), states):
            if not is_muon(p):
                _adam_leaf(g, st["m"], st["v"], p, lr=adam_lr, b1=b1, b2=b2,
                           eps=eps, weight_decay=0.0, bc1=bc1, bc2=bc2)
                continue
            sh = p.shape[1:]
            scale = (max(1.0, sh[-2] / sh[-1])) ** 0.5
            for i in range(p.shape[0]):
                m = torch.add(g[i].float(), st["mom"][i].float(),
                              alpha=momentum)
                o = _newton_schulz(m.reshape(-1, *sh[-2:]), ns_steps).reshape(sh)
                p32 = p[i].float()
                p32.add_(o, alpha=-(lr * scale))
                _write(p[i], p32)
                st["mom"][i].copy_(m)
        return params, state

    return Optimizer(init, update)


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return pytree.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, step):
        for g, m, p in zip(*(pytree.leaves(t) for t in (grads, state, params))):
            torch.add(g.float(), m, alpha=momentum, out=m)  # fma(mu, m, g)
            p32 = p.float()
            p32.add_(m, alpha=-lr)
            _write(p, p32)
        return params, state

    return Optimizer(init, update)
