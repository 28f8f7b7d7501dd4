"""Carry the JAX package's state across to the port, as numpy arrays.

``tiled_from_arrays`` builds the port's ``SlimSellTiled`` from the fields of
a layout the JAX package built; ``state_from_arrays`` does the same for a
BFS state dict. With these, one layout and one state go through both
packages unchanged. Nothing here imports the JAX package: the caller hands
over plain arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.formats import SlimSellTiled, chunk_tile_ptr, resolve_device

REQUIRED_ARRAYS = ("cols", "row_block", "row_vertex", "cl", "deg")
LAYOUT_ARRAYS = REQUIRED_ARRAYS + ("inc_src", "inc_tile", "inc_ptr", "wts")
LAYOUT_META = ("n", "m_undirected", "C", "L", "sigma", "n_chunks", "n_tiles")


def tiled_from_arrays(fields: Mapping[str, np.ndarray], meta: Mapping[str, int],
                      device=None) -> SlimSellTiled:
    """The port's layout from a layout's arrays (``LAYOUT_ARRAYS``; the push
    index and ``wts`` may be missing) and its sizes (``LAYOUT_META``), on
    ``device`` (default: the card; raises when there is none). ``tile_ptr``
    is worked out from ``row_block``."""
    missing = [k for k in LAYOUT_META if k not in meta] + \
        [k for k in REQUIRED_ARRAYS if fields.get(k) is None]
    if missing:
        raise ValueError(f"layout is missing {missing}")
    arrays = {k: (None if fields.get(k) is None else np.asarray(fields[k]))
              for k in LAYOUT_ARRAYS}
    host = SlimSellTiled(
        **{k: int(meta[k]) for k in LAYOUT_META},
        tile_ptr=chunk_tile_ptr(arrays["row_block"], int(meta["n_chunks"])),
        **arrays)
    if host.cols.shape != (host.n_tiles, host.C, host.L):
        raise ValueError(f"cols has shape {host.cols.shape}, expected "
                         f"{(host.n_tiles, host.C, host.L)}")
    # the kernels write their output only through row_vertex, so every
    # vertex must own exactly one chunk row
    rows = host.row_vertex.reshape(-1)
    rows = rows[rows >= 0]
    if host.row_vertex.shape != (host.n_chunks, host.C) or not np.array_equal(
            np.sort(rows), np.arange(host.n)):
        raise ValueError("row_vertex must be [n_chunks, C] and give every "
                         f"vertex of 0..{host.n - 1} exactly one chunk row")
    # and they read a chunk's slots only up to its length cl
    if host.cl.shape != (host.n_chunks,) or np.any(
            _chunk_extent(host) > host.cl):
        raise ValueError("cl must be int[n_chunks] and cover every slot of "
                         "its chunk that holds an edge")
    return host.to_torch(device)


def _chunk_extent(host: SlimSellTiled) -> np.ndarray:
    """int64[n_chunks]: one past the last slot of each chunk that holds an
    edge, counted across the chunk's tiles (0 for a chunk with none)."""
    filled = (host.cols >= 0).any(axis=1)               # [n_tiles, L]
    last = host.L - np.argmax(filled[:, ::-1], axis=1)  # one past, per tile
    nth = np.arange(host.n_tiles) - host.tile_ptr[host.row_block]
    ext = np.where(filled.any(axis=1), nth * host.L + last, 0)
    out = np.zeros(host.n_chunks, np.int64)
    np.maximum.at(out, host.row_block, ext)
    return out


def state_from_arrays(state: Mapping[str, np.ndarray], device=None) -> dict:
    """A BFS state dict (``d``, ``f``, ``visited``, ``x``, ``p``: whichever
    the semiring carries) as tensors on ``device`` (default: the card).
    Packed words (uint32 in the JAX package) arrive as int32 with the same
    bit patterns, the port's storage for them (``core.packing``)."""
    dev = resolve_device(device)
    out = {}
    for k, v in state.items():
        v = np.array(v, copy=True)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.from_numpy(v).to(dev)
    return out
