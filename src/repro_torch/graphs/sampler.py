"""GraphSAGE-style k-hop neighbour sampler (the ``minibatch_lg`` shape),
the port's copy of the JAX package's ``repro/graphs/sampler.py``.

Samples a fixed-fanout computation block hop by hop from a host CSR. Its
edge arrays are padded to static sizes (``expected_block_sizes``), so the
model sees one shape whatever the draw. numpy only: for the same
``np.random.Generator`` state it draws the same block as the JAX
package's, bit for bit.

A block edge ``(edge_index[0, k], edge_index[1, k])`` is ``(u, v)``: the
sampled neighbour u sends its message to the frontier vertex v, so a
layout whose row v holds u (``build_csr`` of the reversed pairs,
``undirected=False``; ``block_csr``) sums what ``seg_sum(gather(x, u), v)``
sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.formats import CSRGraph, build_csr


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    node_ids: np.ndarray     # int32[n_nodes_pad] global ids (-1 pad)
    edge_index: np.ndarray   # int32[2, n_edges_pad] LOCAL ids (-1 pad)
    n_seeds: int             # first n_seeds node slots are the seed nodes
    n_nodes: int
    n_edges: int


def sample_block(csr: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
                 *, rng: np.random.Generator,
                 n_nodes_pad: int, n_edges_pad: int) -> SampledBlock:
    """Uniform neighbour sampling, hop by hop: each frontier vertex keeps
    all its neighbours, or ``fan`` of them drawn without replacement; the
    neighbours not seen before are the next frontier. Returns the block in
    local ids, cut or padded (-1) to ``n_nodes_pad`` nodes and
    ``n_edges_pad`` edges; ``n_nodes`` and ``n_edges`` count the whole
    draw."""
    seeds = np.asarray(seeds, np.int64)
    local = {int(v): i for i, v in enumerate(seeds)}
    nodes = list(seeds)
    edges_src: list[int] = []
    edges_dst: list[int] = []
    frontier = seeds
    for fan in fanouts:
        nxt = []
        for v in frontier:
            nbr = csr.indices[csr.indptr[v]:csr.indptr[v + 1]]
            if nbr.size == 0:
                continue
            take = nbr if nbr.size <= fan else rng.choice(nbr, fan, replace=False)
            for u in take:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                edges_src.append(local[u])
                edges_dst.append(local[int(v)])
        frontier = np.asarray(nxt, np.int64)
    n_nodes, n_edges = len(nodes), len(edges_src)
    node_ids = np.full(n_nodes_pad, -1, np.int32)
    node_ids[:min(n_nodes, n_nodes_pad)] = np.asarray(nodes[:n_nodes_pad], np.int32)
    ei = np.full((2, n_edges_pad), -1, np.int32)
    ne = min(n_edges, n_edges_pad)
    ei[0, :ne] = np.asarray(edges_src[:ne], np.int32)
    ei[1, :ne] = np.asarray(edges_dst[:ne], np.int32)
    return SampledBlock(node_ids=node_ids, edge_index=ei,
                        n_seeds=len(seeds), n_nodes=n_nodes, n_edges=n_edges)


def expected_block_sizes(batch_nodes: int, fanouts: tuple[int, ...]):
    """Static padded sizes ``(n_nodes, n_edges)`` for a fanout schedule:
    the worst case, every draw full and no vertex drawn twice."""
    n_nodes = batch_nodes
    n_edges = 0
    frontier = batch_nodes
    for fan in fanouts:
        n_edges += frontier * fan
        frontier *= fan
        n_nodes += frontier
    return n_nodes, n_edges


def block_csr(block: SampledBlock) -> CSRGraph:
    """The block as a directed CSR over its ``node_ids.size`` node slots,
    row v holding the senders u of its edges u -> v: the operand of a
    SlimSell layout whose sweep is the block's neighbourhood sum. Its nnz
    is the count of edges the block keeps (a draw repeats no edge); a
    block whose node pad cuts its draw (an edge to a node past the pad) is
    refused."""
    n = block.node_ids.size
    ei = block.edge_index[:, block.edge_index[0] >= 0].astype(np.int64)
    if ei.size and ei.max() >= n:
        raise ValueError(f"the block's edges reach node slot {int(ei.max())} "
                         f"of {n}: its node pad is below its draw")
    return build_csr(np.stack([ei[1], ei[0]], 1), n, undirected=False)
