"""Synthetic input pipelines (``data.pipeline``)."""
from .pipeline import CriteoPipeline, TokenPipeline

__all__ = ["CriteoPipeline", "TokenPipeline"]
