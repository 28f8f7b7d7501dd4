"""The port's public string options and its one engine-knob record.

Every public entry point funnels its option strings through ``check_choice``
so a bad value fails at the boundary with one message. The backend is not
an option here: the device of the tensors decides it (a CUDA tensor goes
through the hand-written kernel, a CPU tensor through the plain PyTorch
version).
"""
from __future__ import annotations

import contextlib
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

# the distributed strategy's collective per iteration: one semiring
# all-reduce over every grid axis, or a reduce over the column axes and
# then over the row axes
COMMS = ("allreduce", "reduce_gather")

# connected components: sel-max label propagation or boolean BFS peeling
CC_SEMIRINGS = ("selmax", "boolean")

# the serving layer's query vocabulary: every query names one of these
ALGORITHMS = ("bfs", "sssp", "cc", "pagerank", "betweenness", "khop")

# query lifecycle states reported by serving.QueryResult.status: "shed"
# marks a query dropped at submit by the bounded-queue backpressure policy
QUERY_STATUSES = ("ok", "timeout", "shed")


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
    sanitize: run the engine calls under the sanitizer
    (``core.debug.checked()``), entered by ``applied()`` in the thread that
    runs the call
    """
    direction: str = "push"
    mode: str = "fused"
    sanitize: bool = False

    def __post_init__(self):
        check_choice("direction", self.direction, DIRECTIONS)
        check_choice("mode", self.mode, MODES)
        if not isinstance(self.sanitize, bool):
            raise ValueError(f"sanitize must be bool, got {self.sanitize!r}")

    def signature(self) -> tuple:
        """Hashable identity for handle-cache and bucket keys. ``sanitize``
        is not in it: the port compiles nothing per signature (its checks
        run eagerly around the same sweeps), so a handle built without the
        sanitizer serves a sanitized call unchanged."""
        return (self.direction, self.mode)

    @contextlib.contextmanager
    def applied(self):
        """Context manager applying the config's ambient knob, the
        sanitizer, around an engine call (direction and mode are passed
        explicitly by the front doors); a sanitizer already on stays on."""
        from . import debug
        with contextlib.ExitStack() as stack:
            if self.sanitize and not debug.enabled():
                stack.enter_context(debug.checked())
            yield
