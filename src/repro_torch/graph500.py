"""Graph500 benchmark harness: 64-root BFS with validation and TEPS.

The paper's evaluation protocol (§IV) is the Graph500 one: build a Kronecker
graph, sample 64 search keys among non-isolated vertices, run one BFS per
key, validate every BFS tree, and report traversed edges per second (TEPS)
with the harmonic mean as the headline number.

Both harnesses run through one ``serving.GraphSession`` per run, as the
JAX package's do: the keys run in batches through the session's
shape-bucketed dispatch path (one resident layout, cached fixpoint
handles, the multi-source SpMM engine: one SpMM per iteration advances a
whole batch), so the harness and the serving layer exercise one path.

    from repro_torch.graph500 import run_graph500
    rep = run_graph500(scale=20, edge_factor=16, n_roots=64, batch_size=64)
    print(rep.summary())

``run_graph500_sssp`` is the weighted twin (Graph500's second kernel):
uniform weights on [2^-8, 1], delta-stepping from each key in turn (a
width-1 slot of the batched min-plus path), or with ``batched=True`` from
``batch_size`` keys at once (one min-plus SpMM per sweep), distances
validated against Dijkstra and parents by the tight-relaxation check.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .configs import sssp_graph500 as cfg
from .core.bfs_traditional import bfs_traditional
from .core.formats import CSRGraph, SlimSellTiled, build_slimsell, resolve_device
from .core.options import EngineConfig
from .core.sssp import dijkstra_reference
from .graphs.generators import kronecker, with_random_weights
from .serving import GraphSession


def sample_roots(csr: CSRGraph, n_roots: int = 64, *, seed: int = 2) -> np.ndarray:
    """Graph500 search keys: sampled without replacement from deg > 0 vertices."""
    candidates = np.nonzero(csr.deg > 0)[0]
    if candidates.size == 0:
        raise ValueError("graph has no edges; nothing to search")
    rng = np.random.default_rng(seed)
    k = min(int(n_roots), candidates.size)
    return rng.choice(candidates, k, replace=False).astype(np.int32)


def _require(ok, msg: str) -> None:
    # an explicit raise, not assert: the check must survive python -O
    if not ok:
        raise AssertionError(msg)


def validate_bfs_tree(csr: CSRGraph, root: int, d: np.ndarray,
                      parents: Optional[np.ndarray] = None, *,
                      d_ref: Optional[np.ndarray] = None) -> None:
    """Graph500 §5.2 validation; raises AssertionError on the first violation."""
    root = int(root)
    _require(d[root] == 0, f"root {root} has distance {d[root]}")
    if d_ref is None:
        d_ref, _ = bfs_traditional(csr, root)
    _require(np.array_equal(d, d_ref),
             f"distances differ from reference oracle at root {root}")
    if parents is None:
        return
    _require(parents[root] == root, "root must be its own parent")
    _require((parents[d < 0] == -1).all(),
             "unreachable vertices must have no parent")
    reach = d > 0
    pv = parents[reach]
    _require((pv >= 0).all(), "reached vertices must have a parent")
    _require((d[pv] == d[reach] - 1).all(),
             "tree levels must differ by exactly 1")
    # every tree edge must exist in the graph (spot-check bounded for speed)
    for v in np.nonzero(reach)[0][:200]:
        _require(parents[v] in csr.neighbors(v),
                 f"tree edge ({parents[v]}, {v}) not in graph")


def batch_teps(csr: CSRGraph, distances: np.ndarray,
               seconds: float) -> np.ndarray:
    """Per-root TEPS of one batch, as the spec counts them: the undirected
    edges with at least one endpoint reached from the root, over the
    batch's wall time divided by its width (the whole batch advances in the
    same sweeps). ``distances`` is int32[batch, n]."""
    per_root_s = seconds / distances.shape[0]
    # deg sums directed half-edges over reached vertices -> /2 per spec
    reached = np.array([max(1, int(csr.deg[d >= 0].sum()) // 2)
                        for d in distances], np.float64)
    return reached / per_root_s


@dataclasses.dataclass
class Graph500Report:
    scale: int
    edge_factor: int
    n: int
    m: int
    semiring: str
    device: str
    direction: str
    batch_size: int
    roots: np.ndarray
    teps: np.ndarray           # per-root TEPS (batch time amortized)
    batch_seconds: np.ndarray  # wall time per batch
    validated: int

    @property
    def harmonic_mean_teps(self) -> float:
        return float(1.0 / np.mean(1.0 / self.teps))

    def summary(self) -> str:
        return (f"graph500 scale={self.scale} ef={self.edge_factor} "
                f"n={self.n} m={self.m} semiring={self.semiring} "
                f"device={self.device} direction={self.direction} "
                f"batch={self.batch_size} "
                f"roots={len(self.roots)} validated={self.validated} "
                f"hmean_TEPS={self.harmonic_mean_teps:.3e} "
                f"max_TEPS={self.teps.max():.3e}")


def run_graph500(*, scale: int = 10, edge_factor: int = 16, n_roots: int = 64,
                 batch_size: int = 16, semiring: str = "tropical",
                 C: int = 8, L: int = 128,
                 seed: int = 1, validate: bool = True,
                 need_parents: bool = True,
                 csr: Optional[CSRGraph] = None,
                 tiled: Optional[SlimSellTiled] = None,
                 direction: Optional[str] = None,
                 config: Optional[EngineConfig] = None,
                 device=None) -> Graph500Report:
    """Build (or accept) the graph, run batched BFS from the sampled keys,
    validate, score. ``device`` None means the card (raises when there is
    none); a given ``tiled`` may be the host layout or one on that device
    (used as it is, not copied). A given ``csr`` must have the 2**scale
    vertices the report names, and a given ``tiled`` must be its layout.
    ``direction`` is a shorthand for ``config=EngineConfig(direction=...)``.

    Execution is one ``GraphSession`` per run (``max_batch`` = the batch
    size): each timed batch is a submit wave and a drain (``bfs_many``)
    through the serving layer's dispatch path.

    TEPS accounting follows the spec: the edges counted for a root are the
    undirected edges with at least one endpoint reached from it; the time
    charged to a root is its batch's wall time divided by the batch width
    (the whole batch advances in the same kernel sweeps).
    """
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if config is None:
        config = EngineConfig(direction=direction or "push")
    elif direction is not None:
        raise TypeError("pass either direction= or config=, not both")
    dev = resolve_device(device)
    if csr is None:
        csr = kronecker(scale, edge_factor, seed=seed)
    elif csr.n != 1 << scale:
        raise ValueError(f"csr has n={csr.n}, not the 2**{scale} vertices of "
                         f"scale {scale}")
    if tiled is None:
        tiled = build_slimsell(csr, C=C, L=L, sigma=csr.n)
    elif tiled.n != csr.n:
        raise ValueError(f"tiled has n={tiled.n}, csr has n={csr.n}")
    roots = sample_roots(csr, n_roots)

    teps = np.empty(roots.size, np.float64)
    batch_seconds = []
    validated = 0
    with GraphSession(tiled, config=config, max_batch=batch_size,
                      device=dev) as sess:
        for start in range(0, roots.size, batch_size):
            batch = roots[start:start + batch_size]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            # results come back as host arrays, so the window ends after
            # the device work of the batch
            results = sess.bfs_many(batch, semiring,
                                    need_parents=need_parents)
            dt = time.perf_counter() - t0
            batch_seconds.append(dt)
            teps[start:start + batch.size] = batch_teps(
                csr, np.stack([r.distances for r in results]), dt)
            if validate:
                for r, res in zip(batch, results):
                    validate_bfs_tree(csr, int(r), res.distances,
                                      res.parents if need_parents else None)
                    validated += 1
    return Graph500Report(
        scale=scale, edge_factor=edge_factor, n=csr.n, m=csr.m_undirected,
        semiring=semiring, device=str(dev), direction=config.direction,
        batch_size=batch_size, roots=roots, teps=teps,
        batch_seconds=np.asarray(batch_seconds), validated=validated)


# ------------------------------------------------------------- SSSP kernel


def validate_sssp_tree(csr: CSRGraph, root: int, d: np.ndarray,
                       parents: Optional[np.ndarray] = None, *,
                       d_ref: Optional[np.ndarray] = None,
                       rtol: float = 1e-4, atol: float = 1e-5) -> None:
    """Graph500-SSSP-style validation: distances match the Dijkstra oracle,
    every parent edge exists and is tight (d[p] + w == d[v]); raises
    AssertionError on the first violation."""
    root = int(root)
    _require(d[root] == 0, f"root {root} has distance {d[root]}")
    if d_ref is None:
        d_ref = dijkstra_reference(csr, root)
    _require(np.allclose(d, d_ref, rtol=rtol, atol=atol, equal_nan=False),
             f"distances differ from Dijkstra oracle at root {root}")
    if parents is None:
        return
    _require(parents[root] == root, "root must be its own parent")
    reach = np.isfinite(d) & (np.arange(csr.n) != root)
    _require((parents[~np.isfinite(d)] == -1).all(),
             "unreachable vertices must have no parent")
    v_r = np.nonzero(reach)[0]
    p_r = parents[v_r].astype(np.int64)
    _require((p_r >= 0).all(), "reached vertices must have a parent")
    # CSR rows are column-sorted, so the (v, p) keys are globally sorted and
    # one searchsorted finds every parent edge: existence and tightness are
    # checked for all vertices
    u_all = np.repeat(np.arange(csr.n, dtype=np.int64), csr.deg)
    keys = u_all * csr.n + csr.indices
    q = v_r * csr.n + p_r
    idx = np.searchsorted(keys, q)
    ok = (idx < keys.size) & (keys[np.minimum(idx, keys.size - 1)] == q)
    if not ok.all():
        raise AssertionError("tree edges not in graph, e.g. "
                             f"({p_r[~ok][0]}, {v_r[~ok][0]})")
    w = csr.weights[idx]
    tight = np.isclose(d[p_r] + w, d[v_r], rtol=rtol, atol=atol)
    if not tight.all():
        raise AssertionError("non-tight parent edge, e.g. "
                             f"({p_r[~tight][0]}, {v_r[~tight][0]})")


@dataclasses.dataclass
class Graph500SSSPReport:
    scale: int
    edge_factor: int
    n: int
    m: int
    device: str
    mode: str
    delta: float
    roots: np.ndarray
    teps: np.ndarray      # per-root TEPS-equivalent (reached edges / s)
    sweeps: np.ndarray    # relaxation sweeps per root
    buckets: np.ndarray   # delta buckets per root
    validated: int
    batched: bool = False  # min-plus SpMM batches across roots?
    batch_size: int = 1    # roots per SpMM batch when batched

    @property
    def harmonic_mean_teps(self) -> float:
        return float(1.0 / np.mean(1.0 / self.teps))

    def summary(self) -> str:
        batch = f"batch={self.batch_size} " if self.batched else ""
        return (f"graph500-sssp scale={self.scale} ef={self.edge_factor} "
                f"n={self.n} m={self.m} device={self.device} "
                f"mode={self.mode} {batch}delta={self.delta:.4g} "
                f"roots={len(self.roots)} validated={self.validated} "
                f"hmean_TEPS={self.harmonic_mean_teps:.3e} "
                f"sweeps/root={float(self.sweeps.mean()):.1f}")


def run_graph500_sssp(*, scale: int = 10, edge_factor: int = 16,
                      n_roots: int = 16, delta: Optional[float] = None,
                      batched: bool = False, batch_size: int = 16,
                      C: int = 8, L: int = 128, seed: int = 1,
                      weight_low: Optional[float] = None,
                      weight_high: Optional[float] = None,
                      validate: bool = True, need_parents: bool = True,
                      csr: Optional[CSRGraph] = None,
                      tiled: Optional[SlimSellTiled] = None,
                      config: Optional[EngineConfig] = None,
                      device=None) -> Graph500SSSPReport:
    """Weighted Graph500 kernel: delta-stepping from the sampled keys,
    validated, scored. Execution is one ``GraphSession`` per run:
    ``batched=False`` serves each key as its own width-1 slot of the
    batched min-plus path; ``batched=True`` submits the keys in waves of
    ``batch_size``, one min-plus SpMM sweep advancing every root of a
    batch. Per-root distances, sweeps and buckets are the same either way,
    and equal those of ``sssp`` from each key. ``device`` None means the
    card (raises when there is none); a given ``tiled`` may be the host
    layout or one on that device (used as it is, not copied), and must be
    the layout of the given weighted ``csr``.

    TEPS accounting mirrors the BFS harness: the edges charged to a root
    are the undirected edges with a reached endpoint; the time charged is
    its own call's wall time per root, or its batch's wall time divided by
    the batch width when batched (the results come back as host arrays).
    """
    config = config if config is not None else EngineConfig()
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    dev = resolve_device(device)
    if csr is None:
        csr = with_random_weights(
            kronecker(scale, edge_factor, seed=seed),
            low=cfg.WEIGHT_LOW if weight_low is None else weight_low,
            high=cfg.WEIGHT_HIGH if weight_high is None else weight_high,
            seed=seed + 1)
    elif csr.weights is None:
        raise ValueError("run_graph500_sssp needs a weighted CSR")
    elif csr.n != 1 << scale:
        raise ValueError(f"csr has n={csr.n}, not the 2**{scale} vertices of "
                         f"scale {scale}")
    if tiled is None:
        tiled = build_slimsell(csr, C=C, L=L, sigma=csr.n)
    elif tiled.n != csr.n:
        raise ValueError(f"tiled has n={tiled.n}, csr has n={csr.n}")
    roots = sample_roots(csr, n_roots)
    if roots.size == 0:
        raise ValueError(f"need at least one search key, got n_roots={n_roots}")

    teps = np.empty(roots.size, np.float64)
    sweeps = np.empty(roots.size, np.int32)
    buckets = np.empty(roots.size, np.int32)
    validated = 0
    delta_used = None
    step = batch_size if batched else 1
    with GraphSession(tiled, config=config, max_batch=step,
                      device=dev) as sess:
        for start in range(0, roots.size, step):
            batch = roots[start:start + step]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if batched:
                results = sess.sssp(batch, delta=delta,
                                    need_parents=need_parents, batch=True)
            else:
                results = [sess.sssp(int(batch[0]), delta=delta,
                                     need_parents=need_parents)]
            per_root_s = (time.perf_counter() - t0) / batch.size
            for i, (r, res) in enumerate(zip(batch, results), start):
                d = res.distances
                delta_used = res.delta
                sweeps[i], buckets[i] = res.sweeps, res.buckets
                teps[i] = max(1, int(csr.deg[np.isfinite(d)].sum()) // 2) \
                    / per_root_s
                if validate:
                    validate_sssp_tree(csr, int(r), d,
                                       res.parents if need_parents else None)
                    validated += 1
    return Graph500SSSPReport(
        scale=scale, edge_factor=edge_factor, n=csr.n, m=csr.m_undirected,
        device=str(dev), mode=config.mode, delta=float(delta_used),
        roots=roots, teps=teps, sweeps=sweeps, buckets=buckets,
        validated=validated, batched=batched,
        batch_size=batch_size if batched else 1)
