"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826], the port's copy of the JAX package's
``repro/configs/gin_tu.py``. SlimSell-applicable (sum-aggregation SpMM
regime): ``aggregation="slimsell"`` runs kernel 2's implicit real SpMM.
"""
import dataclasses

from ..models.gnn import GINConfig
from .cells import GNN_SHAPES

ARCH_ID = "gin-tu"
FAMILY = "gnn"
KIND = "gin"
SHAPES = list(GNN_SHAPES)


def make_config() -> GINConfig:
    return GINConfig(name=ARCH_ID, n_layers=5, d_hidden=64, n_classes=8)


def reduced_config() -> GINConfig:
    return dataclasses.replace(make_config(), d_in=8, d_hidden=16, n_classes=2)
