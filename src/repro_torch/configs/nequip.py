"""nequip [gnn] n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5
equivariance=E(3)-tensor-product [arXiv:2101.03164], the port's copy of
the JAX package's ``repro/configs/nequip.py``. Irreps are carried in
Cartesian form (scalars, vectors, traceless rank-2); see
``models/gnn.py``.
"""
import dataclasses

from ..models.gnn import NequIPConfig
from .cells import GNN_SHAPES

ARCH_ID = "nequip"
FAMILY = "gnn"
KIND = "nequip"
SHAPES = list(GNN_SHAPES)


def make_config() -> NequIPConfig:
    return NequIPConfig(name=ARCH_ID, n_layers=5, d_hidden=32, n_rbf=8,
                        cutoff=5.0)


def reduced_config() -> NequIPConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_hidden=8)
