"""Synthetic graph generators (paper §IV benchmark inputs).

* Kronecker / R-MAT power-law graphs with Graph500 parameters
  (a=0.57, b=0.19, c=0.19, d=0.05) — the paper's "K" family.
* Erdős–Rényi G(n, p) uniform-degree graphs — the paper's "ER" family.
* ``with_random_weights`` decorates any CSR with symmetric random edge
  weights.
* ``molecules`` (the port's own; the JAX package has no generator for it)
  makes the inputs of the GNN ``molecule`` cell: small 3-D graphs of atoms,
  each joined to its closest neighbours, as a batch of numpy arrays.

All generators are deterministic in ``seed`` (numpy generators, drawn in
the same order as the JAX package's, so one seed gives one graph in both)
and return host-side CSR.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.formats import CSRGraph, build_csr


def kronecker(scale: int, edge_factor: int = 16, *, seed: int = 0,
              a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """Graph500 R-MAT generator: n = 2**scale vertices, m ≈ edge_factor * n."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r > ab                      # chose one of the two right quadrants
        r2 = rng.random(m)
        # within-quadrant split (Graph500 reference formulation)
        dst_bit = np.where(right, r2 < c / (c + (1 - abc)), r2 < b / (a + b))
        src |= right.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # Graph500 permutes vertex labels to kill locality artifacts
    perm = rng.permutation(n)
    edges = np.stack([perm[src], perm[dst]], axis=1)
    return build_csr(edges, n)


def erdos_renyi(n: int, avg_degree: float, *, seed: int = 0) -> CSRGraph:
    """G(n, p) with p chosen so the expected (undirected) degree is avg_degree."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    edges = rng.integers(0, n, size=(int(m * 1.05) + 8, 2))
    return build_csr(edges, n)


def ring_of_cliques(n_cliques: int, clique: int, *, seed: int = 0) -> CSRGraph:
    """High-diameter structured graph (road-network stand-in, paper 'rca')."""
    blocks = []
    for i in range(n_cliques):
        base = i * clique
        idx = np.arange(base, base + clique)
        u, v = np.meshgrid(idx, idx)
        blocks.append(np.stack([u.ravel(), v.ravel()], axis=1))
        nxt = ((i + 1) % n_cliques) * clique
        blocks.append(np.array([[base, nxt]]))
    edges = np.concatenate(blocks, axis=0)
    return build_csr(edges, n_cliques * clique)


def with_random_weights(csr: CSRGraph, *, low: float = 1.0, high: float = 10.0,
                        seed: int = 0, integer: bool = False) -> CSRGraph:
    """Attach symmetric uniform random weights in [low, high) to a CSR.

    Each undirected edge {u, v} draws one weight, assigned to both directed
    copies. ``integer=True`` floors the draws; weights stay non-negative.
    """
    if low < 0 or high < low:
        raise ValueError(f"need 0 <= low <= high, got [{low}, {high})")
    u = np.repeat(np.arange(csr.n, dtype=np.int64), np.diff(csr.indptr))
    v = csr.indices.astype(np.int64)
    key = np.minimum(u, v) * csr.n + np.maximum(u, v)
    uniq, inv = np.unique(key, return_inverse=True)
    rng = np.random.default_rng(seed)
    w = rng.uniform(low, high, uniq.size)
    if integer:
        w = np.floor(w)
    return dataclasses.replace(csr, weights=w.astype(np.float32)[inv])


def two_components(scale: int, edge_factor: int = 8, *, seed: int = 0) -> CSRGraph:
    """Two disjoint Kronecker graphs side by side — a disconnected input."""
    a = kronecker(scale, edge_factor, seed=seed)
    b = kronecker(scale, edge_factor, seed=seed + 1)
    ua = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    ub = np.repeat(np.arange(b.n, dtype=np.int64), np.diff(b.indptr))
    edges = np.concatenate([
        np.stack([ua, a.indices.astype(np.int64)], axis=1),
        np.stack([ub + a.n, b.indices.astype(np.int64) + a.n], axis=1),
    ])
    return build_csr(edges, a.n + b.n)


def star(n: int) -> CSRGraph:
    """Max-degree stress graph: vertex 0 joined to every other vertex."""
    edges = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    return build_csr(edges, n)


def molecules(n_mol: int, *, atoms: int = 30, pairs: int = 32,
              d_feat: int = 16, n_species: int = 4, seed: int = 0) -> dict:
    """A batch of ``n_mol`` synthetic molecules of ``atoms`` atoms, the
    inputs of the GNN ``molecule`` cell (``configs.cells.GNN_SHAPES``: 128
    molecules, 3,840 atoms, 8,192 edges): positions N(0, 1.5^2) per axis,
    species uniform on [0, n_species), features N(0, 1) [N, d_feat], and
    each molecule's ``pairs`` closest atom pairs as edges both ways
    (``edge_index`` int32[2, 2 pairs n_mol], molecule by molecule);
    ``graph_ids`` atom // atoms, ``n_graphs`` n_mol. numpy arrays, drawn
    from ``seed`` in that order."""
    rng = np.random.default_rng(seed)
    n = n_mol * atoms
    pos = (1.5 * rng.standard_normal((n, 3))).astype(np.float32)
    species = rng.integers(0, n_species, n).astype(np.int32)
    feat = rng.standard_normal((n, d_feat)).astype(np.float32)
    iu, ju = np.triu_indices(atoms, 1)
    p = pos.reshape(n_mol, atoms, 3)
    d2 = ((p[:, iu] - p[:, ju]) ** 2).sum(-1)                 # [n_mol, pairs]
    near = np.argsort(d2, axis=1, kind="stable")[:, :pairs]
    base = (np.arange(n_mol) * atoms)[:, None]
    a, b = iu[near] + base, ju[near] + base                   # [n_mol, pairs]
    src = np.concatenate([a, b], 1).reshape(-1)
    dst = np.concatenate([b, a], 1).reshape(-1)
    edge_index = np.stack([src, dst]).astype(np.int32)
    return {"node_feat": feat, "pos": pos, "species": species,
            "edge_index": edge_index,
            "graph_ids": (np.arange(n) // atoms).astype(np.int32),
            "n_graphs": n_mol}
