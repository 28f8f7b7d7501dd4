"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907], the port's copy of the JAX package's
``repro/configs/gcn_cora.py`` and of its ``GNN_SHAPES``. SlimSell-applicable
(SpMM regime): the aggregation backend is selectable (segment | slimsell).
"""
import dataclasses

from ..models.gnn import GCNConfig

ARCH_ID = "gcn-cora"
FAMILY = "gnn"
KIND = "gcn"

# the graph shapes of the JAX package's GNN cells (repro/configs/cells.py)
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_graphs=1),
    "minibatch_lg": dict(kind="train", n_nodes=169984, n_edges=168960,
                         d_feat=602, n_graphs=1, sampled=True),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_graphs=1),
    "molecule": dict(kind="train", n_nodes=3840, n_edges=8192,
                     d_feat=16, n_graphs=128),
}
SHAPES = list(GNN_SHAPES)


def gcn_model_flops(cfg: GCNConfig, n_nodes: int, n_edges: int,
                    d_feat: int) -> float:
    """Forward and backward FLOPs of a GCN training step (3x the forward):
    per layer ``x @ w`` and the aggregation's multiply-add an edge and
    column. The GCN branch of the JAX package's ``gnn_model_flops``
    (``repro/configs/cells.py``)."""
    sizes = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    f = sum(2 * n_nodes * a * b + 2 * n_edges * b
            for a, b in zip(sizes[:-1], sizes[1:]))
    return 3.0 * f


def make_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, n_classes=16)


def reduced_config() -> GCNConfig:
    return dataclasses.replace(make_config(), d_in=8, n_classes=4)
