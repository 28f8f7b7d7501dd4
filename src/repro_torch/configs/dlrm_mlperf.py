"""dlrm-mlperf [recsys] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot
(MLPerf Criteo-1TB config) [arXiv:1906.00091], the port's copy of the JAX
package's ``repro/configs/dlrm_mlperf.py`` and of its ``RECSYS_SHAPES``.
The mesh and sharding of ``build_cell`` are not ported.
"""
import dataclasses

from ..models.dlrm import DLRMConfig

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"

# the shapes of the JAX package's RecSys cells (repro/configs/cells.py)
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000000),
    "train_batch_hybrid": dict(kind="train", batch=65536, hybrid=True),
    "serve_bulk_hybrid": dict(kind="serve", batch=262144, hybrid=True),
    "train_batch_dp256": dict(kind="train", batch=65536, hybrid=True,
                              dp_all=True),
}
SHAPES = list(RECSYS_SHAPES)


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
