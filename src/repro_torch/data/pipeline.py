"""Deterministic synthetic batches, the port's copy of ``CriteoPipeline``
(DLRM) and ``TokenPipeline`` (language models) from the JAX package's
``repro/data/pipeline.py``.

A batch is a pure function of (seed, step, host_id), so hosts of a
multi-process launch draw disjoint shards without coordination, and the
two packages give the same numpy batches for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CriteoPipeline:
    """DLRM batches: log-normal dense features, uniform sparse ids."""
    vocabs: tuple
    batch: int
    multi_hot: int = 1
    seed: int = 0

    def get_batch(self, step: int, host_id: int = 0, n_hosts: int = 1):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        b = self.batch // n_hosts
        dense = rng.lognormal(0.0, 1.0, size=(b, 13)).astype(np.float32)
        sparse = np.stack(
            [rng.integers(0, v, size=(b, self.multi_hot)) for v in self.vocabs],
            axis=1).astype(np.int32)
        label = rng.integers(0, 2, size=b).astype(np.int32)
        return {"dense": np.log1p(dense), "sparse": sparse, "label": label}


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """LM batches: Zipf-distributed token ids (power-law like natural
    text), ``{"tokens", "labels"}`` int32 [batch // n_hosts, seq], the
    labels the tokens shifted by one."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def get_batch(self, step: int, host_id: int = 0, n_hosts: int = 1):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        b = self.batch // n_hosts
        z = rng.zipf(1.2, size=(b, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
