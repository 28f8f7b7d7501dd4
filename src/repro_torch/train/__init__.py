"""The generic train step (the port of the JAX package's ``repro/train``)."""
from .step import make_train_step

__all__ = ["make_train_step"]
