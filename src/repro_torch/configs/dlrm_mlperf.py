"""dlrm-mlperf [recsys] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot
(MLPerf Criteo-1TB config) [arXiv:1906.00091], the port's copy of the JAX
package's ``repro/configs/dlrm_mlperf.py``; its cells' shapes are
``configs.cells.RECSYS_SHAPES`` and their table placement
``configs.cells.dlrm_param_specs`` (``build_cell`` is not ported yet).
"""
import dataclasses

from ..models.dlrm import DLRMConfig, top_sizes
from .cells import RECSYS_SHAPES

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"

SHAPES = list(RECSYS_SHAPES)


def mlp_flops(cfg: DLRMConfig) -> int:
    """FLOPs a sample of the forward's dense part: the bottom and top MLPs
    and the dot interaction of the (n_sparse + 1) vectors, as the JAX
    package counts them for its DLRM cells (``repro/configs/cells.py``,
    whose count writes 27 for n_sparse + 1, the MLPerf widths')."""
    bot, top = list(cfg.bot_mlp), top_sizes(cfg)
    f = cfg.n_sparse + 1
    return (sum(2 * a * b for a, b in zip(bot[:-1], bot[1:]))
            + sum(2 * a * b for a, b in zip(top[:-1], top[1:]))
            + 2 * f * f * cfg.embed_dim)


def train_flops(cfg: DLRMConfig, batch: int) -> int:
    """FLOPs of a training step at ``batch`` samples: 3x the forward's
    dense part (``3 * B * flops_mlp`` of the JAX package's ``train_batch``
    cell; the lookups and their scatter are bytes, not counted)."""
    return 3 * batch * mlp_flops(cfg)


def make_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID)


def reduced_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID, vocabs=(64, 32, 128, 16),
                      embed_dim=16, bot_mlp=(13, 32, 16),
                      top_mlp=(32, 1))


def capped_config(max_rows: int = 2 ** 24) -> DLRMConfig:
    """The MLPerf widths with every table cut to at most ``max_rows`` rows,
    the DLRM reference code's ``--max-ind-range`` (the mechanism that gave
    the MLPerf vocabularies from Criteo-1TB, there at 40M). At 2^24 it cuts
    five tables and leaves 87,950,072 rows: 45,030,436,864 bytes of float32
    tables, which fit one 80 GB card; the uncut 187,767,399 rows take
    96.14 GB. Ids are drawn below each cut vocabulary."""
    cfg = make_config()
    return dataclasses.replace(
        cfg, vocabs=tuple(min(v, max_rows) for v in cfg.vocabs))
