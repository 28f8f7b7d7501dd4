"""The four BFS semirings of the paper (§III-A) as a PyTorch table.

A semiring S = (X, add, mul, zero, one): ``add`` is the reduction of the
sweep, named by ``reduction`` (identity ``zero``, also the contribution of
a padding slot); ``mul`` combines the implicit edge value with a gathered
frontier value.

============ ============================= ========================= ====
semiring     (add, mul, zero, one)         payload carried in-band   code
============ ============================= ========================= ====
``tropical`` (min, +,  inf, 0)             hop distances             0
``real``     (+,  *,   0,   1)             path counts               1
``boolean``  (max, *,  0,   1) on int32    reachability bits         2
``selmax``   (max, *,  0,   1)             parent ids (1-based)      3
============ ============================= ========================= ====

``boolean_packed`` (SlimSell-B, code 4) is boolean over packed words: add
is word-wise OR, mul word-wise AND, zero the empty word and ``one`` (and
the implicit edge value) the all-ones word, -1 in the int32 storage of
``core.packing``. It is reached through ``packed=True``, not by name.

``code`` is the integer the CUDA kernels switch on; the kernel sources
carry the four BFS cases (``kernels/csrc/semiring.cuh``), and the packed
sweeps have kernels of their own (``slimsell_spmv_packed.cu``,
``slimsell_spmm_packed.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import packing
from .options import SEMIRINGS as REGISTERED

_REDUCE = {"min": "amin", "max": "amax", "sum": "sum"}


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    dtype: torch.dtype
    zero: float  # additive identity == padding contribution
    one: float   # multiplicative identity
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    reduction: str  # add-monoid kind: "min" | "max" | "sum" | "or"
    code: int       # the kernels' switch value
    # the implicit SlimSell edge value the sweep multiplies in (derived
    # from ``cols``, never stored)
    edge_value: int = 1

    @property
    def scatter_reduce(self) -> str:
        """The ``torch.scatter_reduce`` name of the add-monoid (torch has
        none for "or": ``packing.segment_or`` combines packed words)."""
        if self.reduction == "or":
            raise ValueError(f"{self.name}: torch has no OR scatter; use "
                             "packing.segment_or")
        return _REDUCE[self.reduction]

    def reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Semiring-add over one axis."""
        if self.reduction == "min":
            return x.amin(dim=dim)
        if self.reduction == "max":
            return x.amax(dim=dim)
        if self.reduction == "or":
            return packing.or_reduce(x, (dim,))
        return x.sum(dim=dim)

    def edge(self, x: torch.Tensor) -> torch.Tensor:
        """``mul(edge_value, x)``: x+1 under tropical, x otherwise (the
        all-ones word under boolean_packed, which ANDs to x)."""
        return self.mul(torch.tensor(self.edge_value, dtype=x.dtype,
                                     device=x.device), x)


TROPICAL = Semiring(
    name="tropical", dtype=torch.float32, zero=float("inf"), one=0.0,
    mul=torch.add, reduction="min", code=0,
)

REAL = Semiring(
    name="real", dtype=torch.float32, zero=0.0, one=1.0,
    mul=torch.mul, reduction="sum", code=1,
)

BOOLEAN = Semiring(
    name="boolean", dtype=torch.int32, zero=0, one=1,
    mul=torch.mul,                # & on {0,1}
    reduction="max", code=2,      # max is | on {0,1}
)

SELMAX = Semiring(
    name="selmax", dtype=torch.float32, zero=0.0, one=1.0,
    mul=torch.mul, reduction="max", code=3,
)

# SlimSell-B: 32 reachability bits per int32 word; the implicit edge value
# is the all-ones word, so an edge passes every bit of the gathered word
BOOLEAN_PACKED = Semiring(
    name="boolean_packed", dtype=torch.int32, zero=0, one=packing.FULL_WORD,
    mul=torch.bitwise_and, reduction="or", code=4,
    edge_value=packing.FULL_WORD,
)

SEMIRINGS = {s.name: s for s in (TROPICAL, REAL, BOOLEAN, SELMAX,
                                 BOOLEAN_PACKED)}
assert tuple(SEMIRINGS) == REGISTERED, (tuple(SEMIRINGS), REGISTERED)


def get(name: str) -> Semiring:
    try:
        return SEMIRINGS[name]
    except KeyError:
        raise KeyError(f"unknown semiring {name!r}; available: "
                       f"{sorted(SEMIRINGS)}") from None
