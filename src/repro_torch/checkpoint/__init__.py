"""The checkpoint store (the port of the JAX package's
``repro/checkpoint``): atomic, resumable, in its on-disk layout."""
from .store import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
