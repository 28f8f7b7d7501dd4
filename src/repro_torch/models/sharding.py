"""Logical -> mesh axis mapping and divisibility-aware partition specs, the
port of the JAX package's ``repro/models/sharding.py``.

The production mesh is (data=16, model=16), optionally with a leading
pod axis:

* ``dp``   -- batch / token parallelism          -> ("pod", "data")
* ``fsdp`` -- ZeRO-3 weight sharding             -> ("pod", "data")
* ``tp``   -- tensor / expert / sequence parallel -> "model"

A *spec* is a tuple with one entry a dimension, in ``PartitionSpec``'s
order: None (replicated), an axis name, or a tuple of axis names (the
dimension split over their product, the first axis major). ``shard_dim``
falls back to replication where a dimension is not divisible by its
axes' extent (smollm's 9 heads over model=16), as the JAX package's does.

A *mesh* here is anything with ``axis_names`` and ``axis_size(name)``:
a ``distributed.Grid`` (the ranks of a world) or a
``launch.mesh.MeshShape`` (a shape alone, to compute the production
meshes' specs with no ranks at all).

The JAX package lays a tensor out with ``named(mesh, shape, axes)`` and
lets GSPMD move it; here a rank holds its block explicitly:
``local_shard(full, spec, grid)`` cuts the rank's block out of a whole
tensor, ``gather_shard(local, spec, grid)`` rebuilds the whole tensor from
every rank's block (an all-gather a sharded dimension), and
``reshard(local, have, want, grid)`` moves a block from one spec to
another. Blocks follow the grid's row-major rank order and its
``index(axes)`` flattening.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .. import pytree


@dataclasses.dataclass(frozen=True)
class AxisRules:
    dp: tuple = ("data",)
    fsdp: tuple = ("data",)
    tp: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "AxisRules":
        if "pod" in mesh.axis_names:
            return AxisRules(dp=("pod", "data"), fsdp=("pod", "data"),
                             tp="model")
        return AxisRules(dp=("data",), fsdp=("data",), tp="model")


def entry_axes(entry) -> tuple:
    """The axis names of a spec entry (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_leaves(specs) -> list:
    """The specs of a tree of them (dicts and lists of tuples), in the
    order ``pytree.flatten`` lists the weights they describe."""
    return pytree.flatten(specs, is_leaf=lambda x: isinstance(x, tuple))[0]


def axis_size(mesh, axes) -> int:
    """The extent of ``axes`` (None, a name or names) on ``mesh``."""
    return math.prod(mesh.axis_size(a) for a in entry_axes(axes))


def shard_dim(mesh, dim: int, axes):
    """The spec entry for a dimension of size ``dim``: ``axes`` (a name
    stays a name, names a tuple) where their extent is above 1 and divides
    ``dim``, else None."""
    if axes is None:
        return None
    size = axis_size(mesh, axes)
    if size > 1 and dim % size == 0:
        return axes if isinstance(axes, str) else tuple(axes)
    return None


def spec(mesh, shape: Sequence[int], axes: Sequence) -> tuple:
    """The spec of a tensor of ``shape`` whose dimensions ask for ``axes``,
    non-divisible dimensions replicated."""
    return tuple(shard_dim(mesh, d, a) for d, a in zip(shape, axes))


def block(entry, dim: int, grid) -> slice:
    """The rank's slice of a dimension of (whole) size ``dim`` split by
    ``entry``."""
    axes = entry_axes(entry)
    if not axes:
        return slice(0, dim)
    n = axis_size(grid, axes)
    if dim % n:
        raise ValueError(f"a dimension of {dim} does not split over {axes} "
                         f"({n})")
    size = dim // n
    i = grid.index(axes)
    return slice(i * size, (i + 1) * size)


def _padded(spec_: Sequence, ndim: int) -> tuple:
    """``spec_`` with None for the dimensions past its entries, as a
    ``PartitionSpec`` shorter than the tensor reads."""
    if len(spec_) > ndim:
        raise ValueError(f"a spec of {len(spec_)} entries for a tensor of "
                         f"{ndim} dimensions")
    return tuple(spec_) + (None,) * (ndim - len(spec_))


def local_shard(full: torch.Tensor, spec_: Sequence, grid) -> torch.Tensor:
    """The rank's block of ``full`` under ``spec_`` (a view; ``.clone()``
    it to let the whole tensor go)."""
    spec_ = _padded(spec_, full.ndim)
    return full[tuple(block(e, n, grid) for e, n in zip(spec_, full.shape))]


def gather_shard(local: torch.Tensor, spec_: Sequence, grid) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec_``: one
    all-gather over each sharded dimension's axes (a collective: every
    rank of the grid calls it)."""
    spec_ = _padded(spec_, local.ndim)
    return reshard(local, spec_, (None,) * local.ndim, grid)


def reshard(local: torch.Tensor, have: Sequence, want: Sequence,
            grid) -> torch.Tensor:
    """The rank's block under spec ``want`` from its block under ``have``:
    each dimension whose entries differ is gathered over ``have``'s axes,
    then cut to ``want``'s block (a collective where any dimension is
    gathered)."""
    out = local
    for d, (h, w) in enumerate(zip(have, want)):
        if entry_axes(h) == entry_axes(w):
            continue
        if entry_axes(h):
            out = grid.all_gather_dim(out, d, entry_axes(h))
        if entry_axes(w):
            sl = block(w, out.shape[d], grid)
            out = out.narrow(d, sl.start, sl.stop - sl.start)
    return out


def local_shape(shape: Sequence[int], spec_: Sequence, mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape``."""
    return tuple(n // axis_size(mesh, e) for n, e in zip(shape, spec_))
