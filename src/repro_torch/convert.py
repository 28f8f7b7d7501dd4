"""Carry the JAX package's state across to the port, as numpy arrays.

``tiled_from_arrays`` builds the port's ``SlimSellTiled`` from the fields of
a layout the JAX package built; ``state_from_arrays`` does the same for a
BFS state dict. ``gcn_params_from_arrays`` and ``gcn_batch_from_arrays``
carry a GCN's weights and its input batch, ``dlrm_params_from_arrays`` and
``dlrm_batch_from_arrays`` a DLRM's. With these, one layout, one state and
one model go through both packages unchanged. Nothing here
imports the JAX package: the caller hands over plain arrays.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.formats import SlimSellTiled, chunk_tile_ptr, resolve_device
from .models.dlrm import DLRMConfig, top_sizes
from .models.gnn import GCNConfig, layer_shapes

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


def gcn_params_from_arrays(params: Mapping[str, Sequence[np.ndarray]],
                           cfg: Optional[GCNConfig] = None,
                           device=None) -> dict:
    """The port's GCN params from the JAX package's ``{"w": [array, ...]}``,
    on ``device`` (default: the card; raises when there is none), in
    ``cfg.dtype`` (float32 without a config). The weights must chain
    ([a, b] then [b, c]) and, with ``cfg``, have its layer shapes."""
    ws = [np.asarray(w) for w in params["w"]]
    shapes = [w.shape for w in ws]
    if not ws or any(len(s) != 2 for s in shapes) or any(
            a[1] != b[0] for a, b in zip(shapes, shapes[1:])):
        raise ValueError(f"GCN weights must be chained 2-D arrays, got {shapes}")
    if cfg is not None and shapes != layer_shapes(cfg):
        raise ValueError(f"GCN weights have shapes {shapes}, the config "
                         f"{cfg.name} wants {layer_shapes(cfg)}")
    dev = resolve_device(device)
    dtype = torch.float32 if cfg is None else cfg.dtype
    return {"w": [torch.from_numpy(np.array(w, dtype=np.float32)).to(
        device=dev, dtype=dtype) for w in ws]}


def gcn_batch_from_arrays(arrays: Mapping[str, np.ndarray],
                          layout: Optional[Tuple[Mapping, Mapping]] = None,
                          device=None) -> dict:
    """A GCN input batch on ``device`` (default: the card) from numpy
    arrays: ``node_feat`` [N, F] (float32), ``edge_index`` int[2, E] (-1
    pads; int32), ``deg`` [N] (int32). ``layout``, the ``(fields, meta)`` of
    a SlimSell layout of the same graph (``tiled_from_arrays``), adds
    ``tiled`` for the ``"slimsell"`` aggregation."""
    feat = np.asarray(arrays["node_feat"])
    edge_index = np.asarray(arrays["edge_index"])
    deg = np.asarray(arrays["deg"])
    if feat.ndim != 2:
        raise ValueError(f"node_feat must be [N, F], got {feat.shape}")
    n = feat.shape[0]
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    if deg.shape != (n,):
        raise ValueError(f"deg must be [{n}], got {deg.shape}")
    if edge_index.size and (edge_index.min() < -1 or edge_index.max() >= n):
        raise ValueError(f"edge_index holds ids outside -1..{n - 1}")
    dev = resolve_device(device)
    batch = {
        "node_feat": torch.from_numpy(np.array(feat, dtype=np.float32)).to(dev),
        "edge_index": torch.from_numpy(np.array(edge_index, dtype=np.int32)).to(dev),
        "deg": torch.from_numpy(np.array(deg, dtype=np.int32)).to(dev),
    }
    if layout is not None:
        tiled = tiled_from_arrays(*layout, device=dev)
        if tiled.n != n:
            raise ValueError(f"the layout has {tiled.n} vertices, node_feat {n}")
        batch["tiled"] = tiled
    return batch


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def dlrm_params_from_arrays(params: Mapping, cfg: Optional[DLRMConfig] = None,
                            device=None) -> dict:
    """The port's DLRM params from the JAX package's ``{"tables": [V_i x d],
    "bot": [{"w", "b"}, ...], "top": [...]}`` as numpy arrays, in float32 on
    ``device`` (default: the card; raises when there is none). Tables must
    share one width, MLP weights must chain, and with ``cfg`` every shape
    must be the config's."""
    tables = [np.asarray(t) for t in params["tables"]]
    mlps = {part: [(np.asarray(l["w"]), np.asarray(l["b"])) for l in params[part]]
            for part in ("bot", "top")}
    if not tables or any(t.ndim != 2 or t.shape[1] != tables[0].shape[1]
                         for t in tables):
        raise ValueError("DLRM tables must be 2-D arrays of one width, got "
                         f"{[t.shape for t in tables]}")
    for part, layers in mlps.items():
        shapes = [w.shape for w, _ in layers]
        if not layers or any(len(s) != 2 for s in shapes) or any(
                a[1] != b[0] for a, b in zip(shapes, shapes[1:])) or any(
                b.shape != (w.shape[1],) for w, b in layers):
            raise ValueError(f"the {part} MLP must be chained 2-D weights with "
                             f"matching biases, got {shapes}")
    if cfg is not None:
        want = {"tables": [(v, cfg.embed_dim) for v in cfg.vocabs],
                "bot": list(zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:])),
                "top": list(zip(top_sizes(cfg)[:-1], top_sizes(cfg)[1:]))}
        got = {"tables": [t.shape for t in tables],
               **{part: [w.shape for w, _ in layers]
                  for part, layers in mlps.items()}}
        for part in want:
            if [tuple(s) for s in got[part]] != want[part]:
                raise ValueError(f"DLRM {part} have shapes {got[part]}, the "
                                 f"config {cfg.name} wants {want[part]}")
    dev = resolve_device(device)
    return {"tables": [_tensor(t, np.float32, dev) for t in tables],
            **{part: [{"w": _tensor(w, np.float32, dev),
                       "b": _tensor(b, np.float32, dev)} for w, b in layers]
               for part, layers in mlps.items()}}


def dlrm_batch_from_arrays(arrays: Mapping[str, np.ndarray], device=None) -> dict:
    """A DLRM batch on ``device`` (default: the card) from numpy arrays:
    ``dense`` [B, n_dense] (float32), ``sparse`` [B, n_sparse, multi_hot]
    (-1 pads; int32) and, where given, ``label`` [B] (int32)."""
    dense = np.asarray(arrays["dense"])
    sparse = np.asarray(arrays["sparse"])
    if dense.ndim != 2:
        raise ValueError(f"dense must be [B, n_dense], got {dense.shape}")
    if sparse.ndim != 3 or sparse.shape[0] != dense.shape[0]:
        raise ValueError(f"sparse must be [{dense.shape[0]}, n_sparse, "
                         f"multi_hot], got {sparse.shape}")
    dev = resolve_device(device)
    batch = {"dense": _tensor(dense, np.float32, dev),
             "sparse": _tensor(sparse, np.int32, dev)}
    if "label" in arrays:
        label = np.asarray(arrays["label"])
        if label.shape != (dense.shape[0],):
            raise ValueError(f"label must be [{dense.shape[0]}], got {label.shape}")
        batch["label"] = _tensor(label, np.int32, dev)
    return batch
