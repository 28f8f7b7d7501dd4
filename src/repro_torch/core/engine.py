"""The algebraic fixpoint engine (paper §III): one semiring sweep per step.

An algorithm is a small spec (``FixpointSpec``): initial state, how to read
the sweep operand and the push source bits off the state, and a state
merge that also decides convergence. ``run_fused`` drives a spec to its
fixpoint with the push direction and SlimWork tile masks; ``step`` is one
iteration of it.

The loop runs on the host and reads the convergence flag from the device
once per iteration; the sweeps, masks and state updates stay on the
device. Loop semantics match the JAX package's fused loop: iterate while
``cont and k <= max_iters`` from ``k = 1``; ``iterations = k - 1`` at exit;
``work_log[k-1]`` is the number of active tiles of iteration ``k``.

Spec callables (B = batch width for ``batched`` specs):

  ================= ======================================================
  ``init_state``    (n, arg, device) -> state dict of [n] / [n, B] tensors
  ``frontier``      (state, k) -> sweep operand [n] / [n, B]
  ``source_bits``   (state, k) -> bool[n] / [n, B] push sources
  ``update``        (state, y, k) -> (state, continue? as a bool tensor)
  ================= ======================================================
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import direction as dm
from . import semiring as sm
from .spmv import slimsell_spmm, slimsell_spmv

WORK_LOG = 512  # max logged iterations


@dataclasses.dataclass(frozen=True, eq=False)
class FixpointSpec:
    """One algorithm as data."""
    name: str
    sr_name: str
    init_state: Callable[..., dict]
    frontier: Callable[..., torch.Tensor]
    update: Callable[..., tuple]
    source_bits: Callable[..., torch.Tensor]
    batched: bool = False


@dataclasses.dataclass
class EngineResult:
    """What the engine returns, before algorithm-specific post-processing."""
    state: dict
    iterations: int
    work_log: Optional[np.ndarray] = None  # active tiles per iteration


def _sweep(spec: FixpointSpec, tiled, x: torch.Tensor,
           tile_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One push sweep: SpMM for batched specs, SpMV otherwise."""
    sr = sm.get(spec.sr_name)
    if spec.batched:
        return slimsell_spmm(sr, tiled, x, tile_mask=tile_mask)
    return slimsell_spmv(sr, tiled, x, tile_mask=tile_mask)


def step(spec: FixpointSpec, tiled, state: dict, k: int, *,
         slimwork: bool = True):
    """Iteration ``k`` from ``state``: push mask, sweep, update.

    Returns ``(state, cont, used)``: the new state, the device bool
    "something changed", and the number of tiles swept (a device int32
    under SlimWork, else all tiles).
    """
    mask = None
    used = tiled.n_tiles
    if slimwork:
        mask = dm.push_tile_mask(tiled, spec.source_bits(state, k))
        used = mask.sum(dtype=torch.int32)
    y = _sweep(spec, tiled, spec.frontier(state, k), mask)
    state, cont = spec.update(state, y, k)
    return state, cont, used


def run_fused(spec: FixpointSpec, tiled, arg, *, slimwork: bool = True,
              max_iters: int, log_work: bool = False) -> EngineResult:
    """Run a spec to its fixpoint from ``spec.init_state(n, arg)``.

    Work logs follow the JAX package: single-source results keep the first
    ``iterations`` entries, batched ones the fixed ``WORK_LOG`` length (the
    caller stacks them across batches); entries are 0 without SlimWork.
    """
    device = tiled.cols.device
    state = spec.init_state(tiled.n, arg, device)
    work = torch.zeros(WORK_LOG if log_work else 1, dtype=torch.int32,
                       device=device)
    k, cont = 1, True
    while cont and k <= max_iters:
        state, cont_t, used = step(spec, tiled, state, k, slimwork=slimwork)
        if log_work and slimwork:
            work[min(k - 1, WORK_LOG - 1)] = used
        cont = bool(cont_t)  # the one device sync per iteration
        k += 1
    iters = k - 1
    wl = None
    if log_work:
        wl = work.cpu().numpy()
        if not spec.batched:
            wl = wl[:iters]
    return EngineResult(state=state, iterations=iters, work_log=wl)
