"""egnn [gnn] n_layers=4 d_hidden=64 equivariance=E(n) [arXiv:2102.09844],
the port's copy of the JAX package's ``repro/configs/egnn.py``. Edge-MLP
regime: the messages are per-edge MLPs, summed with ``index_add_``.
"""
import dataclasses

from ..models.gnn import EGNNConfig
from .cells import GNN_SHAPES

ARCH_ID = "egnn"
FAMILY = "gnn"
KIND = "egnn"
SHAPES = list(GNN_SHAPES)


def make_config() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64)


def reduced_config() -> EGNNConfig:
    return dataclasses.replace(make_config(), d_hidden=16, d_in=8)
