"""llama4-scout-17b-a16e [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E], the port's copy of the JAX
package's ``repro/configs/llama4_scout.py``. ``window=8192`` enables the
iRoPE-style chunked-attention option (off by default to match the
assigned spec). The mesh and sharding of ``build_cell`` are not ported."""
import dataclasses

import torch

from ..models.transformer import LMConfig
from .cells import LM_SHAPES

ARCH_ID = "llama4-scout-17b-a16e"
FAMILY = "lm"
SHAPES = [s for s in LM_SHAPES if s != "train_4k_cf125"]
OPTIMIZER = "adamw"


def make_config(chunked_attention: bool = False) -> LMConfig:
    return LMConfig(name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40,
                    n_kv=8, d_head=128, d_ff=8192, vocab=202048,
                    moe=True, n_experts=16, top_k=1, d_ff_expert=8192,
                    n_shared_experts=1,
                    window=8192 if chunked_attention else None,
                    rope_theta=5e5, dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return dataclasses.replace(make_config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv=2, d_head=16, d_ff=128,
                               n_experts=4, top_k=1, d_ff_expert=128,
                               n_shared_experts=1, vocab=256,
                               dtype=torch.float32, q_chunk=32, kv_chunk=32)
