"""Synthetic input pipelines (``data.pipeline``)."""
