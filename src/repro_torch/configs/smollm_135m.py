"""smollm-135m [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M], the port's copy of the JAX package's
``repro/configs/smollm_135m.py``. The mesh and sharding of ``build_cell``
are not ported."""
import dataclasses

import torch

from ..models.transformer import LMConfig
from .cells import LM_SHAPES

ARCH_ID = "smollm-135m"
FAMILY = "lm"
SHAPES = [s for s in LM_SHAPES if s != "train_4k_cf125"]
OPTIMIZER = "adamw"


def make_config() -> LMConfig:
    return LMConfig(name=ARCH_ID, n_layers=30, d_model=576, n_heads=9,
                    n_kv=3, d_head=64, d_ff=1536, vocab=49152,
                    rope_theta=1e4, dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv=2, d_head=16, d_ff=128,
                               vocab=256, dtype=torch.float32,
                               q_chunk=32, kv_chunk=32)
