"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907], the port's copy of the JAX package's
``repro/configs/gcn_cora.py``. SlimSell-applicable (SpMM regime): the
aggregation backend is selectable (segment | slimsell).
"""
import dataclasses

from ..models.gnn import GCNConfig
from .cells import GNN_SHAPES, gnn_model_flops

ARCH_ID = "gcn-cora"
FAMILY = "gnn"
KIND = "gcn"
SHAPES = list(GNN_SHAPES)


def gcn_model_flops(cfg: GCNConfig, n_nodes: int, n_edges: int,
                    d_feat: int) -> float:
    """Forward and backward FLOPs of a GCN training step (3x the forward):
    ``cells.gnn_model_flops("gcn", ...)``."""
    return gnn_model_flops(KIND, cfg, n_nodes, n_edges, d_feat)


def make_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, n_classes=16)


def reduced_config() -> GCNConfig:
    return dataclasses.replace(make_config(), d_in=8, n_classes=4)
