"""The port's public string options and its one engine-knob record.

Every public entry point funnels its option strings through ``check_choice``
so a bad value fails at the boundary with one message. The backend is not
an option here: the device of the tensors decides it (a CUDA tensor goes
through the hand-written kernel, a CPU tensor through the plain PyTorch
version).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

MODES = ("fused", "hostloop")
DIRECTIONS = ("push", "pull", "auto")

# the BFS engines accept exactly the paper's four semirings
BFS_SEMIRINGS = ("tropical", "real", "boolean", "selmax")

# every registered semiring, in the JAX package's order: "minplus" is the
# weighted SSSP operator over stored weights, rejected by the BFS engines;
# "boolean_packed" is SlimSell-B's word domain, boolean over packed words,
# reached through packed=True rather than named
SEMIRINGS = BFS_SEMIRINGS + ("minplus", "boolean_packed")


def check_choice(name: str, value, allowed: Sequence[str], *,
                 hint: str = ""):
    """Validate that ``value`` is one of ``allowed``; raise ValueError if not.

    Returns the value so call sites can validate inline.
    """
    if value not in allowed:
        opts = ", ".join(repr(a) for a in allowed)
        msg = f"unknown {name} {value!r}; expected one of: {opts}"
        if hint:
            msg += f" ({hint})"
        raise ValueError(msg)
    return value


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine knobs as one validated, hashable record.

    direction: "push" (top-down SpMV/SpMM over the frontier's tiles),
    "pull" (bottom-up sweep over the not-final rows) or "auto" (Beamer's
    alpha/beta switch between the two, chosen each iteration)
    mode: "fused" (the whole fixpoint on the device, one host sync per
    iteration) or "hostloop" (tile masks and the direction choice worked
    out in numpy on the host each iteration)
    """
    direction: str = "push"
    mode: str = "fused"

    def __post_init__(self):
        check_choice("direction", self.direction, DIRECTIONS)
        check_choice("mode", self.mode, MODES)
