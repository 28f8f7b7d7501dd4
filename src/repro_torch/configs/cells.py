"""The shapes and placements of the JAX package's ``repro/configs/cells.py``:
the graph shapes of its GNN cells (``GNN_SHAPES``), the training loss of
each of the four GNNs (``gnn_loss``, its ``_gnn_loss``) and their analytic
training FLOPs (``gnn_model_flops``); the shapes of its language-model
cells (``LM_SHAPES``) and their model FLOPs (``lm_model_flops``); the
shapes of its RecSys cells (``RECSYS_SHAPES``) and DLRM's table placement
over a mesh (``dlrm_param_specs``, lifted from its ``build_dlrm_cell``).
The ``build_*_cell`` builders themselves, which lay a whole cell out for
a dry run, are not ported yet (ROADMAP module queue 2.3).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..models import dlrm as dlrm_lib
from ..models import gnn
from ..models.dlrm import padded_rows as _pad_to   # the JAX package's name
from ..models.sharding import AxisRules
from ..models.transformer import LMConfig

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_graphs=1),
    # the block the neighbour sampler draws for 1024 seeds at fanouts
    # (15, 10): graphs.sampler.expected_block_sizes(1024, (15, 10))
    "minibatch_lg": dict(kind="train", n_nodes=169984, n_edges=168960,
                         d_feat=602, n_graphs=1, sampled=True),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_graphs=1),
    "molecule": dict(kind="train", n_nodes=30 * 128, n_edges=64 * 128,
                     d_feat=16, n_graphs=128),
}
KINDS = ("gcn", "gin", "egnn", "nequip")


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row log-softmax NLL against one-hot ``labels`` (a -1 label reads
    class 0, as the JAX package's ``one_hot(max(labels, 0))`` does)."""
    oh = F.one_hot(labels.clamp_min(0).long(), logits.shape[-1]).to(
        logits.dtype)
    return -torch.sum(F.log_softmax(logits, dim=-1) * oh, dim=-1)


def gnn_loss(kind: str, params: dict, batch: dict, cfg, *,
             device=None) -> torch.Tensor:
    """The training loss of the JAX package's GNN cells: ``"gcn"`` the
    masked node-classification NLL (``models.gnn.gcn_loss``), ``"gin"``
    the mean NLL of the graph logits against ``batch["graph_labels"]``,
    ``"egnn"`` and ``"nequip"`` the mean squared error of the energies
    against ``batch["energy"]``."""
    if kind == "gcn":
        return gnn.gcn_loss(params, batch, cfg, device=device)
    if kind == "gin":
        logits = gnn.gin_forward(params, batch, cfg, device=device)
        return _nll(logits, batch["graph_labels"]).mean()
    if kind == "egnn":
        e, _ = gnn.egnn_forward(params, batch, cfg, device=device)
        return torch.mean((e - batch["energy"]) ** 2)
    if kind == "nequip":
        e = gnn.nequip_forward(params, batch, cfg, device=device)
        return torch.mean((e - batch["energy"]) ** 2)
    raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def gnn_model_flops(kind: str, cfg, n_nodes: int, n_edges: int,
                    d_feat: int) -> float:
    """Analytic FLOPs of a training step, 3x the forward, as the JAX
    package counts them: GCN ``x @ w`` and the aggregation's multiply-add
    an edge and column; GIN the aggregation and the two-layer MLP at
    ``d_hidden`` (its first layer's ``d_feat`` is not counted); EGNN the
    edge, coordinate and node MLPs; NequIP the radial MLP, the tensor
    products and the three channel mixers."""
    if kind == "gcn":
        sizes = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        f = sum(2 * n_nodes * a * b + 2 * n_edges * b
                for a, b in zip(sizes[:-1], sizes[1:]))
    elif kind == "gin":
        h = cfg.d_hidden
        f = cfg.n_layers * (2 * n_edges * h + 2 * n_nodes * (h * h * 2))
    elif kind == "egnn":
        h = cfg.d_hidden
        f = cfg.n_layers * (2 * n_edges * (2 * h + 1) * h
                            + 2 * n_edges * h * h * 2
                            + 2 * n_nodes * 2 * h * h * 2)
    elif kind == "nequip":
        c = cfg.d_hidden
        f = cfg.n_layers * (2 * n_edges * (cfg.n_rbf * 32 + 32 * 9 * c)
                            + n_edges * c * (1 + 3 + 9 + 9 + 27)
                            + 2 * n_nodes * 3 * 2 * c * c)
    else:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return 3.0 * f


# ------------------------------------------------------------------ LM family


LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    # a variant of the JAX package's MoE study: tighter dispatch capacity
    "train_4k_cf125": dict(kind="train", seq=4096, batch=256,
                           cap_factor=1.25),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}


def lm_model_flops(cfg: LMConfig, batch: int, seq: int, kind: str) -> float:
    """Model FLOPs of a step: 6 N_active a token for ``"train"``, 2
    N_active for ``"prefill"`` (``batch * seq`` tokens) and ``"decode"``
    (``batch`` tokens), N_active the active weights (``active_params_e9``;
    attention's own products are not counted), as the JAX package counts
    them."""
    n_active = cfg.active_params_e9 * 1e9
    tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------- RecSys family


RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000000),
    # hybrid table placement (the DLRM paper's own hybrid parallelism):
    # tables below 1M rows whole on every rank (data-parallel lookups, no
    # collective), only the huge tables row-sharded over model
    "train_batch_hybrid": dict(kind="train", batch=65536, hybrid=True),
    "serve_bulk_hybrid": dict(kind="serve", batch=262144, hybrid=True),
    # the batch over both mesh axes (the MLPs purely data-parallel)
    "train_batch_dp256": dict(kind="train", batch=65536, hybrid=True,
                              dp_all=True),
}


def dlrm_param_specs(cfg: dlrm_lib.DLRMConfig, mesh, *,
                     hybrid: bool = False) -> dict:
    """The spec of each DLRM weight (the JAX package's ``build_dlrm_cell``,
    each ``PartitionSpec`` a tuple) over vocabularies padded to a multiple
    of the ``tp`` extent (``_pad_to``): a table ``(tp, None)`` where
    ``dlrm.table_sharded`` (every table, or with ``hybrid`` those of at
    least 1,000,000 padded rows), else ``()``, whole; the MLPs whole."""
    tp = AxisRules.for_mesh(mesh).tp
    n = mesh.axis_size(tp)
    return {"tables": [(tp, None) if dlrm_lib.table_sharded(v, n, hybrid)
                       else () for v in cfg.vocabs],
            "bot": [{"w": (None, None), "b": (None,)}
                    for _ in cfg.bot_mlp[:-1]],
            "top": [{"w": (None, None), "b": (None,)}
                    for _ in [0] + list(cfg.top_mlp[:-1])]}
