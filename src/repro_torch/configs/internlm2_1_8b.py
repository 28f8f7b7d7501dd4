"""internlm2-1.8b [dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297], the port's copy of the JAX package's
``repro/configs/internlm2_1_8b.py``. The mesh and sharding of
``build_cell`` are not ported."""
import dataclasses

import torch

from ..models.transformer import LMConfig
from .cells import LM_SHAPES

ARCH_ID = "internlm2-1.8b"
FAMILY = "lm"
SHAPES = [s for s in LM_SHAPES if s != "train_4k_cf125"]
OPTIMIZER = "adamw"


def make_config() -> LMConfig:
    return LMConfig(name=ARCH_ID, n_layers=24, d_model=2048, n_heads=16,
                    n_kv=8, d_head=128, d_ff=8192, vocab=92544,
                    rope_theta=1e6, dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv=2, d_head=16, d_ff=128,
                               vocab=256, dtype=torch.float32,
                               q_chunk=32, kv_chunk=32)
