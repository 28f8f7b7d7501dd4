"""Optimizers over trees of tensors (the port of the JAX package's
``repro/optim``): AdamW, Muon and SGD, the global-norm clip, and int8
error-feedback gradient compression. Each updates in place."""
from .compress import int8_compress_ef
from .optimizers import (Optimizer, adamw, clip_by_global_norm, global_norm,
                         muon, sgd)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "int8_compress_ef", "muon", "sgd"]
