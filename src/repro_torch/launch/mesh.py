"""Production meshes and elastic re-meshing, the port of the JAX package's
``repro/launch/mesh.py``.

A mesh here is a ``MeshShape``: axis names and sizes, and (for
``remesh``) which rank sits at each position. It launches nothing: the
specs of ``models.sharding`` and ``models.transformer.param_specs`` read
it as they read a world's ``distributed.Grid``, and
``distributed.launch(fn, mesh.shape, mesh.axis_names)`` starts a world of
that shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named axes of given sizes; ``ranks`` (int [*shape]), where given,
    the rank id at each position (``remesh``'s survivors), else the ranks
    in row-major order."""
    shape: tuple
    axis_names: tuple
    ranks: Optional[np.ndarray] = dataclasses.field(default=None,
                                                    compare=False)

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"{len(self.shape)} axis sizes for "
                             f"{len(self.axis_names)} axis names")
        if self.ranks is None:
            object.__setattr__(self, "ranks", np.arange(
                self.size, dtype=np.int64).reshape(self.shape))
        elif tuple(self.ranks.shape) != self.shape:
            raise ValueError(f"ranks of shape {self.ranks.shape} for a mesh "
                             f"of {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(data=16, model=16), or (pod=2, data=16, model=16)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(shape: Sequence[int], axes: Sequence[str]) -> MeshShape:
    """A small mesh for a world of ranks (``distributed.launch`` takes its
    ``shape`` and ``axis_names``)."""
    return MeshShape(tuple(shape), tuple(axes))


def remesh(failed: set, world, *, axes=("data", "model")) -> MeshShape:
    """Elastic restart: the largest rectangle of survivors.

    ``world`` is the rank ids in their order (or their count). The
    survivors keep that order; ``model`` is ``min(16, n)`` lowered until it
    divides the n survivors, ``data = n // model``, and the first ``data *
    model`` survivors fill the (data, model) grid row by row, as the JAX
    package does over ``jax.devices()``."""
    ids = range(world) if isinstance(world, int) else world
    alive = [int(r) for r in ids if int(r) not in failed]
    n = len(alive)
    if n == 0:
        raise ValueError("no rank survives")
    model = min(16, n)
    while n % model:
        model -= 1
    data = n // model
    grid = np.array(alive[: data * model], dtype=np.int64).reshape(data, model)
    return MeshShape((data, model), tuple(axes), grid)
