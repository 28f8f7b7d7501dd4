"""Kernel contract registry: every kernel wrapper declares its launch contract.

A *kernel contract* is the set of facts about a kernel launch that the
type system cannot see but correctness depends on. The port's sweep
kernels take no Pallas grid: each block takes an item of a *work list*
(``kernels.ops.spmm_work`` / ``spmv_work``), reads a chunk's tiles through
``tile_ptr`` below its length ``cl``, its slots through ``cols``, and
writes its rows through ``row_vertex``, a split chunk's partial rows into
scratch slots that a second launch folds. The contract is what those
reads and writes need:

* **bounds**: every chunk id, tile id, partial slot and fold range of the
  list lies inside its operand, and every tile a piece reads lies in its
  chunk's ``[tile_ptr[c], tile_ptr[c + 1])``;
* **coverage**: each chunk's pieces cover its tiles below ``cl`` exactly
  once, in order (or form one empty piece);
* **race-freedom**: no two rows write one vertex, no two pieces write one
  partial slot, and each split chunk has one fold over its pieces' slots
  in piece order.

Kernel wrappers register their contract with ``@kernel_contract(cases)``;
``cases()`` builds the *real* work lists with the same builders the
wrapper calls (nothing is re-declared, so the contract cannot drift from
the code) over the handcrafted demo layouts below.
``repro_torch.analysis.contracts`` checks every case. This module holds
only the registry and the demo layouts, so the kernel wrappers can import
it without pulling in the checker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.formats import chunk_tile_ptr

#: registry of kernel-contract declarations, keyed by wrapper name
REGISTRY: Dict[str, "Registration"] = {}


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One concrete launch of a wrapper's kernel.

    kind:       "spmm" (``work`` is ``spmm_work``'s ``(pieces, folds,
                slots)``), "spmv" (``spmv_work``'s ``(items, class_items,
                folds, slots)``) or "tables" (``work`` is ``_table_args``'s
                ``(pointers, rows)`` for ``tables``)
    layout:     the layout the list was built for (a ``DemoLayout``, a
                ``SlimSellTiled`` or an ``engine.ShardTiled``)
    per_piece:  the most tiles of one piece the list was built with
    tables:     kernel 7's tables (kind "tables")
    """
    name: str
    kind: str
    work: tuple
    layout: Any = None
    per_piece: int = 0
    tables: Sequence[torch.Tensor] = ()


@dataclasses.dataclass(frozen=True)
class Registration:
    fn: Any
    cases: Callable[[], List[KernelCase]]


def kernel_contract(cases: Callable[[], List[KernelCase]]):
    """Decorator for kernel wrappers: registers the wrapper's contract
    cases. The lint pass fails any function in ``repro_torch/kernels``
    that launches a ``Kernel`` without this decorator."""
    def deco(fn):
        name = getattr(fn, "__name__", None) or repr(fn)
        REGISTRY[name] = Registration(fn=fn, cases=cases)
        fn.__kernel_contract__ = True
        return fn
    return deco


# ------------------------------------------------------------- demo layouts


@dataclasses.dataclass
class DemoLayout:
    """The fields of a layout the kernels read, as a layout carries them
    (int32 tensors on the CPU): ``n`` result rows, ``n_x`` operand rows."""
    n: int
    n_x: int
    C: int
    L: int
    cols: torch.Tensor        # int32[T, C, L], -1 padding
    row_block: torch.Tensor   # int32[T], each tile's chunk
    row_vertex: torch.Tensor  # int32[n_chunks, C], -1 padding rows
    tile_ptr: torch.Tensor    # int32[n_chunks + 1]
    cl: torch.Tensor          # int32[n_chunks]
    wts: Optional[torch.Tensor] = None
    owns_all_rows: bool = True

    @property
    def n_tiles(self) -> int:
        return int(self.cols.shape[0])

    @property
    def n_chunks(self) -> int:
        return int(self.row_vertex.shape[0])


def _demo(n: int, n_x: int, C: int, L: int, row_block, cl, row_vertex,
          seed: int, owns_all_rows: bool = True) -> DemoLayout:
    """A layout whose rows hold ids in [0, n_x) below their chunk's length
    (the first row of a chunk is as long as ``cl``, the others shorter);
    every other slot is padding, weights positive. ``tile_ptr`` comes from
    ``row_block`` through ``formats.chunk_tile_ptr``, as a shard's does."""
    rng = np.random.default_rng(seed)
    row_block = np.asarray(row_block, np.int32)
    cl = np.asarray(cl, np.int32)
    row_vertex = np.asarray(row_vertex, np.int32)
    tile_ptr = chunk_tile_ptr(row_block, cl.size)
    T = row_block.size
    cols = np.full((T, C, L), -1, np.int32)
    for c in range(cl.size):
        t0, t1 = int(tile_ptr[c]), int(tile_ptr[c + 1])
        buf = np.full((C, (t1 - t0) * L), -1, np.int32)
        for r in range(C):
            if row_vertex[c, r] < 0:
                continue
            k = int(cl[c]) if r == 0 else int(rng.integers(0, cl[c] + 1))
            buf[r, :k] = rng.integers(0, n_x, size=k)
        cols[t0:t1] = buf.reshape(C, t1 - t0, L).transpose(1, 0, 2)
    wts = rng.uniform(0.5, 2.0, size=cols.shape).astype(np.float32)
    t = torch.from_numpy
    return DemoLayout(n=n, n_x=n_x, C=C, L=L, cols=t(cols),
                      row_block=t(row_block), row_vertex=t(row_vertex),
                      tile_ptr=t(tile_ptr),
                      cl=t(cl), wts=t(wts), owns_all_rows=owns_all_rows)


def demo_layouts() -> Dict[str, DemoLayout]:
    """Handcrafted layouts that hold every structural feature the
    contracts care about (C = 2, L = 4):

    * "whole": 9 vertices in 5 chunks, the last with a padding row; chunk
      0 of 4 tiles whose ``cl`` = 13 ends inside its last tile, chunk 1
      with ``cl`` = 0 (one tile, all padding), chunk 2 with a padding tile
      after ``cl``, chunk 3 of 5 tiles (``cl`` = 20), chunk 4 of one;
      at 2 tiles a piece chunks 0 and 3 split into 2 and 3 pieces;
    * "shard": a block of a 2D partition, 9 vertices of which its 2
      chunks hold 3 (``owns_all_rows`` False), columns localized to a
      range of 5, and 2 padding tiles after the last chunk's that repeat
      its id (counted into its ``tile_ptr``, past its ``cl``);
    * "empty block": a block with no edge: every tile padding, counted
      into chunk 0, every ``cl`` 0.
    """
    return {
        "whole": _demo(9, 9, 2, 4, [0] * 4 + [1] + [2] * 2 + [3] * 5 + [4],
                       [13, 0, 4, 20, 3],
                       [[4, 0], [7, 2], [8, 1], [3, 6], [5, -1]], seed=0),
        "shard": _demo(9, 5, 2, 4, [0, 0, 1, 1, 1, 1], [6, 5],
                       [[4, 7], [1, -1]], seed=1, owns_all_rows=False),
        "empty block": _demo(9, 5, 2, 4, [0] * 6, [0, 0], [[2, 8], [0, -1]],
                             seed=2, owns_all_rows=False),
    }


def demo_tables() -> List[torch.Tensor]:
    """Kernel 7's demo tables: rows of one width d = 8, three of different
    row counts, one of them a view into a larger tensor."""
    g = torch.Generator().manual_seed(7)
    big = torch.randn(40, 8, generator=g)
    return [torch.randn(5, 8, generator=g), big[10:27],
            torch.randn(1, 8, generator=g)]
