"""kimi-k2-1t-a32b [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE [arXiv:2501.kimi2], the
port's copy of the JAX package's ``repro/configs/kimi_k2.py``. Trains with
Muon (a single bfloat16 momentum state). The mesh and sharding of
``build_cell`` are not ported."""
import dataclasses

import torch

from ..models.transformer import LMConfig
from .cells import LM_SHAPES

ARCH_ID = "kimi-k2-1t-a32b"
FAMILY = "lm"
SHAPES = [s for s in LM_SHAPES if s != "train_4k_cf125"] + ["train_4k_cf125"]
OPTIMIZER = "muon"


def make_config() -> LMConfig:
    return LMConfig(name=ARCH_ID, n_layers=61, d_model=7168, n_heads=64,
                    n_kv=8, d_head=112, d_ff=2048, vocab=163840,
                    moe=True, n_experts=384, top_k=8, d_ff_expert=2048,
                    rope_theta=5e4, dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv=2, d_head=16, d_ff=128,
                               n_experts=8, top_k=2, d_ff_expert=64,
                               vocab=256, dtype=torch.float32,
                               q_chunk=32, kv_chunk=32)
