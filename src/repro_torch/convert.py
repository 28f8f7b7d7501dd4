"""Carry the JAX package's state across to the port, as numpy arrays.

``tiled_from_arrays`` builds the port's ``SlimSellTiled`` from the fields of
a layout the JAX package built; ``state_from_arrays`` does the same for a
BFS state dict. ``gnn_params_from_arrays`` and ``gnn_batch_from_arrays``
carry the weights and the input batch of any of the four GNNs (GCN, GIN,
EGNN, NequIP; ``gcn_params_from_arrays`` is the GCN's weights),
``dlrm_params_from_arrays`` and ``dlrm_batch_from_arrays`` a DLRM's,
``lm_params_from_arrays`` and ``lm_cache_from_arrays`` a language model's
weights and KV cache, and
``opt_state_from_arrays`` an optimiser's or a train step's state. With
these, one layout, one state and one model go through both packages
unchanged, in training too. Nothing
here imports the JAX package: the caller hands over plain arrays.

On a mesh (a ``ShardCtx`` over the world's ``distributed.Grid``),
``lm_shards_from_arrays``, ``lm_cache_shards_from_arrays`` and
``dlrm_shards_from_arrays`` give a rank its blocks of the same arrays
(``transformer.param_specs`` / ``cache_specs``,
``configs.cells.dlrm_param_specs``; each leaf cut on the host, so no rank
holds a whole language model on its device), and ``*_arrays_from_shards``
gather them whole again (collectives: every rank calls them), as float32
arrays.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import pytree
from .core.formats import SlimSellTiled, chunk_tile_ptr, resolve_device
from .models import dlrm as dlrm_lib
from .models.dlrm import DLRMConfig, top_sizes
from .models.gnn import (GCNConfig, egnn_init, gin_init, layer_shapes,
                         nequip_init)
from .models.sharding import block, gather_shard, local_shape, spec_leaves
from .models.transformer import (LMConfig, ShardCtx, cache_spec, param_shapes,
                                 param_specs)

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


# the arrays of a GNN batch: dtype and shape, N the nodes, G the graphs
_BATCH_ARRAYS = {
    "node_feat": (np.float32, ("N", None)),
    "pos": (np.float32, ("N", 3)),
    "species": (np.int32, ("N",)),
    "deg": (np.int32, ("N",)),
    "graph_ids": (np.int32, ("N",)),
    "labels": (np.int32, ("N",)),
    "train_mask": (np.float32, ("N",)),
    "edge_index": (np.int32, (2, None)),
    "graph_labels": (np.int32, ("G",)),
    "energy": (np.float32, ("G",)),
}
_SHAPE_NAMES = {"node_feat": "[N, F]", "edge_index": "[2, E]"}


def gnn_batch_from_arrays(arrays: Mapping, layout: Optional[Tuple[Mapping,
                                                                  Mapping]] = None,
                          device=None) -> dict:
    """A batch of any of the four GNNs on ``device`` (default: the card)
    from numpy arrays, with whichever of these keys the model reads:
    ``node_feat`` [N, F], ``pos`` [N, 3], ``train_mask`` [N] and ``energy``
    [G] (float32); ``species``, ``deg``, ``graph_ids`` (-1 for none),
    ``labels`` [N], ``graph_labels`` [G] and ``edge_index`` [2, E] (-1
    pads; int32); ``n_graphs`` G, kept an int. N and G must agree across
    the arrays, ids must lie in range, and any other key is refused.
    ``layout``, the ``(fields, meta)`` of a SlimSell layout over the same
    N vertices (``tiled_from_arrays``), adds ``tiled``."""
    unknown = sorted(set(arrays) - set(_BATCH_ARRAYS) - {"n_graphs"})
    if unknown:
        raise ValueError(f"no GNN reads {unknown}; the batch keys are "
                         f"{sorted(_BATCH_ARRAYS)} and n_graphs")
    got = {k: np.asarray(v) for k, v in arrays.items() if k != "n_graphs"}
    sizes = {}
    if "n_graphs" in arrays:
        sizes["G"] = int(arrays["n_graphs"])
    for key, a in got.items():
        _, shape = _BATCH_ARRAYS[key]
        name = _SHAPE_NAMES.get(key, "[" + ", ".join(map(str, shape)) + "]")
        if a.ndim != len(shape):
            raise ValueError(f"{key} must be {name}, got {a.shape}")
        for dim, want in zip(a.shape, shape):
            if isinstance(want, int) and dim != want:
                raise ValueError(f"{key} must be {name}, got {a.shape}")
            if isinstance(want, str) and sizes.setdefault(want, dim) != dim:
                raise ValueError(f"{key} must be {name} with {want} = "
                                 f"{sizes[want]}, got {a.shape}")
    for key, (bound, what) in (("edge_index", ("N", "outside -1..N - 1")),
                               ("graph_ids", ("G", "outside -1..G - 1"))):
        if key in got and got[key].size:
            top = sizes.get(bound)
            if top is None:
                raise ValueError(f"{key} needs {bound}: pass "
                                 f"{'n_graphs' if bound == 'G' else 'the node arrays'}")
            if got[key].min() < -1 or got[key].max() >= top:
                raise ValueError(f"{key} holds ids {what} ({bound} = {top})")
    dev = resolve_device(device)
    batch = {k: _tensor(a, _BATCH_ARRAYS[k][0], dev) for k, a in got.items()}
    if "n_graphs" in arrays:
        batch["n_graphs"] = sizes["G"]
    if layout is not None:
        tiled = tiled_from_arrays(*layout, device=dev)
        if "N" in sizes and tiled.n != sizes["N"]:
            raise ValueError(f"the layout has {tiled.n} vertices, the batch "
                             f"{sizes['N']}")
        batch["tiled"] = tiled
    return batch


# the port's init of each GNN the JAX package's weight trees carry into
_GNN_INITS = {"gin": gin_init, "egnn": egnn_init, "nequip": nequip_init}


def gnn_params_from_arrays(kind: str, params, cfg=None, device=None):
    """The port's weights of a GNN (``kind`` "gcn", "gin", "egnn" or
    "nequip") from the JAX package's tree of them as numpy arrays
    (``jax.tree.map(np.asarray, params)``), on ``device`` (default: the
    card; raises when there is none), leaf for leaf in the same tree
    (GIN's 0-d ``eps`` a 0-d tensor). Every leaf must be floating; it
    arrives in float32, or with ``cfg`` in the dtype of the port's init for
    ``cfg``, whose tree and leaf shapes it must have. ``"gcn"`` is
    ``gcn_params_from_arrays``."""
    if kind == "gcn":
        return gcn_params_from_arrays(params, cfg, device)
    if kind not in _GNN_INITS:
        raise ValueError(f"kind must be gcn or one of {sorted(_GNN_INITS)}, "
                         f"got {kind!r}")
    pairs, treedef = pytree.flatten_with_paths(params)
    arrays = [(path, np.asarray(a)) for path, a in pairs]
    for path, a in arrays:
        if not np.issubdtype(a.dtype, np.floating):
            raise ValueError(f"{kind} weight {path} must be floating, got "
                             f"{a.dtype}")
    dtypes = [torch.float32] * len(arrays)
    if cfg is not None:
        want, want_def = pytree.flatten_with_paths(
            _GNN_INITS[kind](cfg, device="cpu"))
        if want_def != treedef:
            raise ValueError(f"the {kind} weights are {treedef}, the config "
                             f"{cfg.name} wants {want_def}")
        for (path, a), (_, w) in zip(arrays, want):
            if a.shape != tuple(w.shape):
                raise ValueError(f"{kind} weight {path} has shape {a.shape}, "
                                 f"the config {cfg.name} wants "
                                 f"{tuple(w.shape)}")
        dtypes = [w.dtype for _, w in want]
    dev = resolve_device(device)
    return pytree.unflatten(treedef, [
        torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)
        for (_, a), dt in zip(arrays, dtypes)])


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


# the dtypes of an optimiser's or a train step's state, by numpy name
_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}


def _state_leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    name = str(a.dtype)
    if name not in _STATE_DTYPES:
        raise ValueError(f"optimiser state leaves are float32, bfloat16 or "
                         f"int32, got {name}")
    if name == "bfloat16":  # ml_dtypes' type: carried as its bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def opt_state_from_arrays(state, device=None):
    """An optimiser's state (AdamW ``{"m", "v"}``, SGD's momentum tree,
    Muon's ``{"mom", "m", "v"}`` a weight) or a train step's (``{"opt",
    "step"[, "ef"]}``) from the JAX package's, its leaves numpy arrays
    (``jax.tree.map(np.asarray, state)``), as tensors on ``device``
    (default: the card; raises when there is none), the structure kept.
    float32, bfloat16 (Muon's momentum) and int32 (the step) leaves keep
    their dtype; any other is refused."""
    dev = resolve_device(device)
    return pytree.tree_map(lambda a: _state_leaf(a, dev), state)


# the dtypes a language model's weights and cache arrive in, by numpy name
_LM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lm_leaf(a, want: torch.Tensor, what: str, dev: torch.device):
    """A float32 or bfloat16 (``ml_dtypes``, carried as its bits) array as
    a tensor of ``want``'s shape and dtype on ``dev``."""
    a = np.asarray(a)
    if str(a.dtype) not in _LM_DTYPES:
        raise ValueError(f"{what} must be float32 or bfloat16, got {a.dtype}")
    if a.shape != tuple(want.shape):
        raise ValueError(f"{what} has shape {a.shape}, the config wants "
                         f"{tuple(want.shape)}")
    return _state_leaf(a, dev).to(want.dtype)


def lm_params_from_arrays(params, cfg: LMConfig, device=None) -> dict:
    """A language model's weights from the JAX package's tree of them as
    numpy arrays (``jax.tree.map(np.asarray, params)``), on ``device``
    (default: the card; raises when there is none), leaf for leaf: the tree
    and every shape must be those of the port's ``init_params`` for
    ``cfg``, and each leaf arrives in that init's dtype (bfloat16 arrays
    as ``torch.bfloat16``, bit for bit)."""
    pairs, treedef = pytree.flatten_with_paths(params)
    want, want_def = pytree.flatten_with_paths(param_shapes(cfg))
    if treedef != want_def:
        raise ValueError(f"the weights are {treedef}, the config {cfg.name} "
                         f"wants {want_def}")
    dev = resolve_device(device)
    return pytree.unflatten(treedef, [
        _lm_leaf(a, w, f"weight {path}", dev)
        for (path, a), (_, w) in zip(pairs, want)])


def lm_cache_from_arrays(cache: Mapping, cfg: Optional[LMConfig] = None,
                         device=None) -> dict:
    """A KV cache ``{"k", "v"}`` ([L, B, S, KV, Dh] each, float32 or
    bfloat16) from numpy arrays, on ``device`` (default: the card; raises
    when there is none). With ``cfg`` the layers, heads and head width
    must be the config's and the cache arrives in ``cfg.dtype``."""
    if set(cache) != {"k", "v"}:
        raise ValueError(f"a cache is {{'k', 'v'}}, got {sorted(cache)}")
    k, v = np.asarray(cache["k"]), np.asarray(cache["v"])
    if k.ndim != 5 or k.shape != v.shape:
        raise ValueError(f"k and v must be one [L, B, S, KV, Dh] shape, got "
                         f"{k.shape} and {v.shape}")
    dtype = _LM_DTYPES.get(str(k.dtype), torch.float32)
    if cfg is not None:
        want = (cfg.n_layers, cfg.n_kv, cfg.d_head)
        if (k.shape[0], k.shape[3], k.shape[4]) != want:
            raise ValueError(f"the cache is {k.shape}, the config {cfg.name} "
                             f"wants [{want[0]}, B, S, {want[1]}, {want[2]}]")
        dtype = cfg.dtype
    dev = resolve_device(device)
    like = torch.empty(k.shape, dtype=dtype, device="meta")
    return {name: _lm_leaf(a, like, f"cache[{name!r}]", dev)
            for name, a in (("k", k), ("v", v))}


def _host_block(a: np.ndarray, spec_, grid) -> np.ndarray:
    spec_ = tuple(spec_) + (None,) * (a.ndim - len(spec_))
    return a[tuple(block(e, n, grid) for e, n in zip(spec_, a.shape))]


def lm_shards_from_arrays(params, cfg: LMConfig, ctx: ShardCtx,
                          device=None) -> dict:
    """The rank's block (``param_specs``) of each of a language model's
    weights, given whole as numpy arrays (``lm_params_from_arrays``'
    input), on ``device`` (default: the grid's)."""
    pairs, treedef = pytree.flatten_with_paths(params)
    want, want_def = pytree.flatten_with_paths(param_shapes(cfg))
    if treedef != want_def:
        raise ValueError(f"the weights are {treedef}, the config {cfg.name} "
                         f"wants {want_def}")
    specs = spec_leaves(param_specs(cfg, ctx.grid, ctx.rules))
    dev = torch.device(ctx.grid.device) if device is None else \
        torch.device(device)
    out = []
    for (path, a), (_, w), sp in zip(pairs, want, specs):
        a = np.asarray(a)
        if a.shape != tuple(w.shape):
            raise ValueError(f"weight {path} has shape {a.shape}, the config "
                             f"wants {tuple(w.shape)}")
        like = torch.empty(local_shape(w.shape, sp, ctx.grid),
                           dtype=w.dtype, device="meta")
        out.append(_lm_leaf(_host_block(a, sp, ctx.grid), like,
                            f"weight {path}", dev))
    return pytree.unflatten(treedef, out)


def lm_cache_shards_from_arrays(cache: Mapping, cfg: LMConfig,
                                ctx: ShardCtx, device=None) -> dict:
    """The rank's block (``cache_specs`` for the cache's batch, with
    ``ctx.cache_seq_shard``) of a KV cache given whole as numpy arrays
    (``lm_cache_from_arrays``' input), in ``cfg.dtype``."""
    k = np.asarray(cache["k"])
    sp = cache_spec(cfg, ctx, k.shape[1], k.shape[2])
    whole = {n: _host_block(np.asarray(cache[n]), sp, ctx.grid)
             for n in ("k", "v")}
    dev = torch.device(ctx.grid.device) if device is None else device
    return lm_cache_from_arrays(whole, cfg, device=dev)


def lm_arrays_from_shards(params: dict, cfg: LMConfig,
                          ctx: ShardCtx) -> dict:
    """The whole weights as float32 numpy arrays from every rank's blocks
    (a collective)."""
    specs = spec_leaves(param_specs(cfg, ctx.grid, ctx.rules))
    leaves, treedef = pytree.flatten(params)
    return pytree.unflatten(treedef, [
        gather_shard(t, sp, ctx.grid).float().cpu().numpy()
        for t, sp in zip(leaves, specs)])


def lm_cache_arrays_from_shards(cache: Mapping, cfg: LMConfig,
                                ctx: ShardCtx, batch: int) -> dict:
    """The whole KV cache of a batch of ``batch`` as float32 numpy arrays
    from every rank's blocks (a collective)."""
    n = cache["k"].shape[2]
    sp = cache_spec(cfg, ctx, batch, n)
    return {name: gather_shard(cache[name], sp, ctx.grid).float().cpu()
            .numpy() for name in ("k", "v")}


def dlrm_shards_from_arrays(params: Mapping, cfg: DLRMConfig, ctx: ShardCtx,
                            *, hybrid: bool = False, device=None) -> dict:
    """The rank's DLRM weights from the JAX package's (checked as by
    ``dlrm_params_from_arrays``): each table padded with zero rows and cut
    to the rank's row block where ``configs.cells.dlrm_param_specs`` shards
    it, the MLPs whole, on ``device`` (default: the grid's)."""
    host = dlrm_params_from_arrays(params, cfg, device="cpu")
    dev = torch.device(ctx.grid.device) if device is None else \
        torch.device(device)
    return {"tables": [dlrm_lib.table_shard(t, ctx, hybrid).to(dev)
                       for t in host["tables"]],
            **{part: [{k: v.to(dev) for k, v in layer.items()}
                      for layer in host[part]] for part in ("bot", "top")}}


def dlrm_arrays_from_shards(params: dict, cfg: DLRMConfig, ctx: ShardCtx,
                            *, hybrid: bool = False) -> dict:
    """The whole DLRM weights as float32 numpy arrays from every rank's
    blocks (a collective), the pad rows dropped."""
    tp = ctx.grid.axis_size(ctx.rules.tp)
    tables = []
    for v, t in zip(cfg.vocabs, params["tables"]):
        if dlrm_lib.table_sharded(v, tp, hybrid):
            t = gather_shard(t, (ctx.rules.tp, None), ctx.grid)
        tables.append(t[:v].float().cpu().numpy())
    return {"tables": tables,
            **{part: [{k: w.float().cpu().numpy() for k, w in layer.items()}
                      for layer in params[part]] for part in ("bot", "top")}}
