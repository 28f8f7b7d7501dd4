"""phi3-mini-3.8b [dense] 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU [arXiv:2404.14219], the port's copy of the JAX
package's ``repro/configs/phi3_mini.py``. The mesh and sharding of
``build_cell`` are not ported."""
import dataclasses

import torch

from ..models.transformer import LMConfig
from .cells import LM_SHAPES

ARCH_ID = "phi3-mini-3.8b"
FAMILY = "lm"
SHAPES = [s for s in LM_SHAPES if s != "train_4k_cf125"]
OPTIMIZER = "adamw"


def make_config() -> LMConfig:
    return LMConfig(name=ARCH_ID, n_layers=32, d_model=3072, n_heads=32,
                    n_kv=32, d_head=96, d_ff=8192, vocab=32064,
                    rope_theta=1e4, dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv=4, d_head=16, d_ff=128,
                               vocab=256, dtype=torch.float32,
                               q_chunk=32, kv_chunk=32)
