"""A grid of processes on ``torch.distributed``: the port's device mesh.

The JAX package runs its 2D-distributed strategy under ``shard_map`` over a
mesh with named axes, ``("data", "model")`` or ``("pod", "data",
"model")`` (``repro.compat.make_mesh``). Here every mesh position is a
process (a *rank*) and ``Grid`` gives the same names to the world's ranks:

* ``rank`` <-> coordinates: the ranks fill the grid in row-major order of
  the axes, as the devices fill a mesh; ``index(axes)`` flattens the
  coordinates along some axes (the row shard of ``("pod", "data")`` is
  ``pod * data_size + data``);
* one process group for each set of axes a collective reduces over: the
  ranks that share every other coordinate (made on first use, by every
  rank in the same order, as ``torch.distributed.new_group`` requires);
* the collectives of the strategy: ``pall``, the semiring add over some
  axes (MIN, MAX or SUM all-reduce, the counterpart of ``Semiring.pall``),
  whose "or" form is ``packing.por`` (all-gather, then an OR fold: NCCL
  has no OR), plus ``all_gather``, the paired send / receive of
  ``exchange`` and the ``all_to_all`` of the expert-parallel MoE's
  dispatch and return (``models.moe``).

Backends. NCCL takes the card's tensors in place, one rank per card; it
refuses two ranks on one device. Gloo takes host tensors only, so a
card's tensor crosses to the host and back around every gloo collective,
explicitly (``_host``), through a pinned buffer kept for each shape and
type (a pageable copy runs several times slower); those copies are timed
with the collective and on their own.
An all-gather receives every member's block into one buffer (pinned
under gloo: a gather of parts and a stack of them ran at half the rate),
and ``release_buffers`` drops the buffers kept. Neither backend reduces
or gathers int16, so an int16 tensor travels widened to int32 (exactly),
and its paired send / receive and its all-to-all as the raw two bytes of
a bfloat16 view. A bfloat16 tensor is gathered as it is, but reduced
widened to float32 and rounded back once: gloo's bfloat16 sum
(where its version has one) rounds after every add, in its ring's order,
and one rounding of the float32 sum is the value a single device's
float32-accumulated product rounds to (the sharded language model's
row-parallel partials, ``models.transformer``).

``all_gather_dim`` joins every member's block along a dimension (the
layer of ``models.sharding``); ``reduce_scatter`` is the SUM over some
axes of which a rank keeps its block along a dimension: one all-reduce,
then the rank's slice (gloo has no reduce-scatter, so the bytes on the
wire are the all-reduce's).

``CommStats`` counts every collective's calls, bytes (one rank's buffer
before the reduction) and seconds (host clock, the card synchronised
before and after), host copies included (``copy_seconds`` alone): the
time a loop spends outside its sweeps, waiting for the slowest rank
included.

``launch`` spawns a world of ranks with the ``spawn`` start method (a
``torch.multiprocessing`` context), a ``FileStore`` in a temporary
directory for the rendezvous (no port to collide with another world),
runs ``fn(grid, *args)`` in each (``fn`` importable by name, not a
closure; ``fn`` and ``args`` pickled once to a file in that directory,
so the ranks start together whatever the arguments' size) and returns
the ranks' results. Every rank is joined against one
deadline; a rank that raises, dies or overruns fails the launch, and the
others are stopped. A spawned rank inherits nothing of the caller's
threads, so ``launch`` hands each rank the caller's sanitizer state
(``core.debug.enabled()``): ``with debug.checked(): launch(...)``
sanitizes every rank, and a rank's ``SanitizerError`` fails the launch
with the rank's message.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .core import debug, packing
from .core.formats import resolve_device
from .core.options import check_choice

_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
        "sum": dist.ReduceOp.SUM}
# the process-group backends a world may take
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class CommStats:
    """Collectives of one rank since the last ``reset``."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    copy_seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes = 0, 0
        self.seconds = self.copy_seconds = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class Grid:
    """Named axes over the ranks of the initialised default process group.

    ``shape`` and ``axis_names`` are the mesh's (``(2, 2), ("data",
    "model")``); their product must be the world size. ``device`` is where
    the rank's tensors live.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} axis sizes for {len(axis_names)} "
                             "axis names")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = math.prod(self.shape)
        if dist.get_world_size() != self.size:
            raise ValueError(f"a grid of {self.shape} needs {self.size} ranks, "
                             f"the world has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(device)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 self.shape))))
        self.stats = CommStats()
        self._groups: dict = {}
        self._pinned: dict = {}

    # ------------------------------------------------------------ geometry

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's flat index along ``axes``, the first axis major."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.coords[a]
        return idx

    def rank_of(self, **coords) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced."""
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index([c[a] for a in self.axis_names],
                                         self.shape))

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes`` (None: the whole world)."""
        key = tuple(a for a in self.axis_names if a in set(axes))
        if len(key) != len(set(axes)):
            raise ValueError(f"unknown axes {axes}; the grid has "
                             f"{self.axis_names}")
        if key == self.axis_names:
            return None
        if key not in self._groups:
            # every rank makes every group of this axis set, in one order
            rest = [a for a in self.axis_names if a not in key]
            mine = None
            for fixed in itertools.product(*(range(self.axis_size(a))
                                             for a in rest)):
                pinned = dict(zip(rest, fixed))
                ranks = sorted(
                    self.rank_of(**pinned, **dict(zip(key, free)))
                    for free in itertools.product(*(range(self.axis_size(a))
                                                    for a in key)))
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]

    # --------------------------------------------------------- collectives

    def _timed(self, t: torch.Tensor):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()
        return time.perf_counter()

    def _done(self, t0: float, device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.stats.seconds += time.perf_counter() - t0

    def _host(self, t: torch.Tensor) -> bool:
        """Gloo reduces and gathers host tensors only: a card's tensor is
        copied to the host before and back after (the copies count in the
        collective's time)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        """What the backend takes for ``t``: its copy in this shape's pinned
        host buffer under gloo, else a copy on its device; int16 widened
        to int32 (neither backend reduces or gathers int16)."""
        if self._host(t):
            buf = self._pinned_buffer("send", t.shape, t.dtype)
            t0 = time.perf_counter()
            buf.copy_(t)
            self.stats.copy_seconds += time.perf_counter() - t0
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        return buf.to(torch.int32) if buf.dtype == torch.int16 else buf

    def _pinned_buffer(self, role: str, shape, dtype) -> torch.Tensor:
        """This role's pinned host buffer of this shape and type."""
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype,
                                                  pin_memory=True)
        return buf

    def release_buffers(self) -> None:
        """Drop the pinned host buffers kept for the collectives' shapes
        (they are made again at the next collective of a shape)."""
        self._pinned.clear()

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``buf`` on ``like``'s device in its type (the copy back from the
        host timed as a copy)."""
        if buf.device == like.device:
            return buf.to(like.dtype)
        t0 = time.perf_counter()
        out = torch.empty(buf.shape, dtype=like.dtype, device=like.device)
        out.copy_(buf)
        self.stats.copy_seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, op: str,
                   axes: Sequence[str]) -> torch.Tensor:
        """The MIN, MAX or SUM of ``t`` over ``axes``, as a new tensor in
        ``t``'s dtype (bfloat16 reduced in float32, rounded once)."""
        wide = t.float() if t.dtype == torch.bfloat16 else t
        t0 = self._timed(wide)
        buf = self._buffer(wide)
        dist.all_reduce(buf, op=_OPS[op], group=self.group(axes))
        out = self._back(buf, t)
        self._done(t0, t.device)
        return out

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """[size along axes, *t.shape]: every member's ``t``, in the order
        of their flat index along ``axes``."""
        t0 = self._timed(t)
        buf = self._buffer(t)
        shape = (math.prod(self.axis_size(a) for a in axes),) + buf.shape
        # one receive buffer (pinned under gloo): no parts to stack, and one
        # copy back at the pinned rate; the group's ranks are sorted, which
        # is the flat order along axes
        got = (self._pinned_buffer("gather", shape, buf.dtype)
               if self._host(t) else
               torch.empty(shape, dtype=buf.dtype, device=buf.device))
        _all_gather_into(got.view(-1), buf.view(-1), self.group(axes))
        out = self._back(got, t)
        self._done(t0, t.device)
        return out

    def _in_grid_order(self, axes: Sequence[str]) -> tuple:
        axes = tuple(axes)
        if axes != tuple(a for a in self.axis_names if a in axes):
            raise ValueError(f"axes {axes} must follow the grid's order "
                             f"{self.axis_names}")
        return axes

    def all_gather_dim(self, t: torch.Tensor, dim: int,
                       axes: Sequence[str]) -> torch.Tensor:
        """Every member's ``t`` along ``axes`` joined along ``dim``, in the
        order of their flat index (``axes`` in the grid's order, the first
        major), as a new tensor."""
        axes = self._in_grid_order(axes)
        n = math.prod(self.axis_size(a) for a in axes)
        if n == 1:
            return t.clone()
        parts = self.all_gather(t.contiguous(), axes).movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= n
        return parts.reshape(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       axes: Sequence[str]) -> torch.Tensor:
        """The SUM of ``t`` over ``axes``, of which this rank keeps its
        block along ``dim`` (block ``index(axes)`` of ``size(axes)``): one
        all-reduce, then the slice (gloo has no reduce-scatter)."""
        axes = self._in_grid_order(axes)
        n = math.prod(self.axis_size(a) for a in axes)
        if t.shape[dim] % n:
            raise ValueError(f"a dimension of {t.shape[dim]} does not split "
                             f"over {axes} ({n})")
        size = t.shape[dim] // n
        out = self.all_reduce(t, "sum", axes) if n > 1 else t
        return out.narrow(dim, self.index(axes) * size, size).contiguous()

    def all_to_all(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Block i of ``t``'s dimension 0 (of ``size(axes)`` blocks) sent to
        the member of flat index i along ``axes`` (``axes`` in the grid's
        order); block i of the result came from member i (the JAX
        package's ``lax.all_to_all(t, axis, 0, 0, tiled=False)``). int16
        travels as the two bytes of a bfloat16 view, as in ``exchange``."""
        axes = self._in_grid_order(axes)
        n = math.prod(self.axis_size(a) for a in axes)
        if t.shape[0] != n:
            raise ValueError(f"an all-to-all over {axes} takes {n} blocks "
                             f"along dimension 0, got {t.shape[0]}")
        if n == 1:
            return t.clone()
        t0 = self._timed(t)
        wire = t.contiguous()
        if wire.dtype == torch.int16:
            wire = wire.view(torch.bfloat16)
        buf = self._buffer(wire)
        got = (self._pinned_buffer("recv", wire.shape, wire.dtype)
               if self._host(wire) else torch.empty_like(buf))
        dist.all_to_all_single(got, buf, group=self.group(axes))
        out = self._back(got, wire).view(t.dtype)
        self._done(t0, t.device)
        return out

    def pall(self, reduction: str, t: torch.Tensor,
             axes: Sequence[str]) -> torch.Tensor:
        """The semiring add of ``t`` over ``axes`` (``Semiring.reduction``:
        "min", "max", "sum", or "or" for packed words)."""
        if reduction == "or":
            return packing.por(t, self, axes)
        return self.all_reduce(t, reduction, axes)

    def exchange(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        """Send ``t`` to rank ``peer`` and receive its tensor of the same
        shape and type (a paired ``batch_isend_irecv``); the rank itself
        keeps ``t``."""
        if peer == self.rank:
            return t.clone()
        t0 = self._timed(t)
        wire = t.contiguous()
        if wire.dtype == torch.int16:
            # neither backend sends int16: the same two bytes as bfloat16
            wire = wire.view(torch.bfloat16)
        buf = self._buffer(wire)
        got = (self._pinned_buffer("recv", wire.shape, wire.dtype)
               if self._host(wire) else torch.empty_like(buf))
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, peer),
                                           dist.P2POp(dist.irecv, got, peer)]):
            req.wait()
        out = self._back(got, wire).view(t.dtype)
        self._done(t0, t.device)
        return out


def _all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Every member's flat ``t`` into the flat ``out``, in group rank order
    (``all_gather_single`` where this PyTorch has it, else its older name)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)


# ------------------------------------------------------------------ launcher


def _rank_main(rank: int, world: int, tmp: str, backend: str, device: str,
               shape, axis_names, timeout_s: float, sanitize: bool) -> None:
    """One rank: join the world, run ``fn(grid, *args)`` (sanitized when
    the caller was), write its result (or the traceback) under ``tmp``,
    leave the world. A rank runs its PyTorch host work on one thread: the
    ranks of a world share the host's cores. The traceback is written
    before the rank leaves the world: leaving closes its connections, which
    fails its peers' next collective, and the launcher reports the error
    written first."""
    def failed():
        with open(os.path.join(tmp, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())

    try:
        torch.set_num_threads(1)
        if sanitize:
            debug.enable()
        else:
            debug.disable()
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA device")
            # ranks share the cards in turn: one card -> all on card 0
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(Grid(shape, axis_names, dev), *args)
            part = os.path.join(tmp, f"result-{rank}.part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, os.path.join(tmp, f"result-{rank}.pkl"))
        except BaseException:
            failed()
            raise
        finally:
            dist.destroy_process_group()
    except BaseException:
        if not os.path.exists(os.path.join(tmp, f"error-{rank}.txt")):
            failed()
        raise


def launch(fn: Callable, shape: Sequence[int], axis_names: Sequence[str],
           args: tuple = (), *, backend: str = "gloo", device=None,
           timeout: float = 600.0) -> list:
    """Run ``fn(grid, *args)`` on every rank of a fresh world of
    ``prod(shape)`` processes and return the results, by rank.

    ``device``: where the ranks' tensors live; None means the card, and
    raises at once when there is none. On one card the ranks share it, so
    ``backend`` must then be "gloo" for more than one rank (NCCL refuses
    two ranks on a device). ``fn`` and ``args`` are pickled; a result must
    be picklable without a card (numpy arrays, numbers). Raises
    ``TimeoutError`` when a rank outlives ``timeout`` seconds and
    ``RuntimeError`` when one fails; either way every rank is stopped.
    """
    check_choice("backend", backend, BACKENDS)
    dev = resolve_device(device)
    world = math.prod(int(s) for s in shape)
    if backend == "nccl" and dev.type == "cuda" \
            and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank a card: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        # the call goes through a file: a spawned process reads its start-up
        # arguments from a pipe only once it has imported the main module,
        # so arguments larger than the pipe's buffer would start the ranks
        # one after the other
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, backend, str(dev),
                                   tuple(shape), tuple(axis_names), timeout,
                                   debug.enabled()))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _join(procs, tmp, time.monotonic() + timeout)
            results = []
            for r in range(world):
                with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)


def _join(procs, tmp: str, deadline: float) -> None:
    """Wait for every rank until ``deadline``; raise at the first failure
    or at the deadline."""
    live = list(procs)
    while live:
        left = deadline - time.monotonic()
        if left <= 0:
            ranks = [procs.index(p) for p in live]
            raise TimeoutError(f"ranks {ranks} still running at the deadline")
        for sentinel in wait([p.sentinel for p in live], timeout=left):
            p = next(q for q in live if q.sentinel == sentinel)
            p.join()
            live.remove(p)
            if p.exitcode != 0:
                rank, text = _first_error(tmp, procs.index(p))
                procs[rank].join(10)   # it wrote its error and is leaving
                raise RuntimeError(f"rank {rank} exited with code "
                                   f"{procs[rank].exitcode}:\n{text}")


def _first_error(tmp: str, rank: int):
    """The rank whose error was written first, and its traceback: a rank
    that fails makes its peers fail in their next collective, and the
    first error is the cause (``rank``, the one seen exiting, when none
    was written)."""
    errs = [os.path.join(tmp, f) for f in os.listdir(tmp)
            if f.startswith("error-")]
    if not errs:
        return rank, ""
    first = min(errs, key=os.path.getmtime)
    with open(first) as f:
        return int(first.rsplit("-", 1)[1].split(".")[0]), f.read()
