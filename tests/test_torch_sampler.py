"""The port's neighbour sampler against the JAX package's.

``sample_block`` is numpy only in both packages: for the same
``np.random.Generator`` state the port must draw the same block, bit for
bit (node ids, edges, counts, and the generator's state after the draw).
Then the block's directed layout (``block_csr``): its SlimSell sum equals
the segment sum over the block's edges, and GIN on it equals ``repro``'s
segment GIN on the block within 1e-4 of the largest logit (the bound of
``test_torch_gnn_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.graphs import generators as jg
from repro.graphs import sampler as jsampler
from repro.models import gnn as jgnn
from repro_torch import convert
from repro_torch.configs import cells as pcells
from repro_torch.configs import gin_tu as pgin_cfg
from repro_torch.core import formats as pf
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.graphs import sampler as psampler
from repro_torch.kernels import autograd as pag
from repro_torch.models import gnn as pgnn


def _graphs():
    """name -> (repro's CSR, the port's CSR of the same arrays)."""
    out = {}
    for name, csr in (("kron", jg.kronecker(9, 8, seed=3)),
                      ("er", jg.erdos_renyi(300, 4, seed=5)),
                      ("star", jg.star(60))):
        out[name] = (csr, pf.CSRGraph(n=csr.n, m_undirected=csr.m_undirected,
                                      indptr=csr.indptr.copy(),
                                      indices=csr.indices.copy()))
    return out


GRAPHS = _graphs()
FANOUTS = [(15, 10), (3,), (2, 2, 2), (50,)]


def _seeds(csr, k, rng_seed, isolated=False):
    rng = np.random.default_rng(rng_seed)
    seeds = rng.choice(csr.n, size=k, replace=False)
    if isolated:  # every vertex of degree 0 besides
        seeds = np.unique(np.concatenate([seeds, np.flatnonzero(csr.deg == 0)]))
    return seeds


def _both(graph, seeds, fanouts, seed, n_nodes_pad, n_edges_pad):
    jcsr, pcsr = GRAPHS[graph]
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jsampler.sample_block(jcsr, seeds, fanouts, rng=jrng,
                                 n_nodes_pad=n_nodes_pad,
                                 n_edges_pad=n_edges_pad)
    got = psampler.sample_block(pcsr, seeds, fanouts, rng=prng,
                                n_nodes_pad=n_nodes_pad,
                                n_edges_pad=n_edges_pad)
    assert jrng.bit_generator.state == prng.bit_generator.state
    return got, want


def _same_block(got, want):
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    for f in ("n_seeds", "n_nodes", "n_edges"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("node_ids", "edge_index"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), f


@pytest.mark.parametrize("pads", ["expected", "half", "double"])
@pytest.mark.parametrize("fanouts", FANOUTS)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sample_block_bit_equal_to_repro(graph, seed, fanouts, pads):
    jcsr, _ = GRAPHS[graph]
    seeds = _seeds(jcsr, 16, [seed, 1])
    n_nodes, n_edges = psampler.expected_block_sizes(len(seeds), fanouts)
    scale = {"expected": 1.0, "half": 0.5, "double": 2.0}[pads]
    got, want = _both(graph, seeds, fanouts, seed,
                      max(1, int(n_nodes * scale)), max(1, int(n_edges * scale)))
    _same_block(got, want)
    assert got.n_edges <= n_edges and got.n_nodes <= n_nodes


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_block_pads_below_the_block(seed):
    """Pads smaller than the draw cut the node and edge arrays alike."""
    jcsr, _ = GRAPHS["kron"]
    seeds = _seeds(jcsr, 32, [seed, 2])
    got, want = _both("kron", seeds, (15, 10), seed, 40, 50)
    _same_block(got, want)
    assert got.n_nodes > 40 and got.n_edges > 50
    assert (got.node_ids >= 0).all() and (got.edge_index >= 0).all()
    with pytest.raises(ValueError, match="node pad"):
        psampler.block_csr(got)


def test_sample_block_seeds_without_neighbours():
    jcsr, _ = GRAPHS["kron"]
    seeds = _seeds(jcsr, 8, 9, isolated=True)
    assert (jcsr.deg[seeds] == 0).any()
    n_nodes, n_edges = psampler.expected_block_sizes(len(seeds), (4, 3))
    got, want = _both("kron", seeds, (4, 3), 9, n_nodes, n_edges)
    _same_block(got, want)
    isolated = np.flatnonzero(jcsr.deg[seeds] == 0)
    assert not np.isin(isolated, got.edge_index[1]).any()
    # only isolated seeds: an empty block
    lone = seeds[jcsr.deg[seeds] == 0]
    got, want = _both("kron", lone, (4, 3), 9, 10, 10)
    _same_block(got, want)
    assert got.n_edges == 0 and got.n_nodes == len(lone)


@pytest.mark.parametrize("batch,fanouts", [(1024, (15, 10)), (16, (3,)),
                                           (5, (2, 2, 2)), (1, ())])
def test_expected_block_sizes_equal_repro(batch, fanouts):
    assert psampler.expected_block_sizes(batch, fanouts) == \
        jsampler.expected_block_sizes(batch, fanouts)


def test_minibatch_lg_is_the_expected_block():
    sh = pcells.GNN_SHAPES["minibatch_lg"]
    assert psampler.expected_block_sizes(1024, (15, 10)) == \
        (sh["n_nodes"], sh["n_edges"]) == (169984, 168960)


def _block(seed=4):
    jcsr, pcsr = GRAPHS["kron"]
    seeds = _seeds(jcsr, 24, seed)
    n_nodes, n_edges = psampler.expected_block_sizes(len(seeds), (6, 4))
    block = psampler.sample_block(pcsr, seeds, (6, 4),
                                  rng=np.random.default_rng(seed),
                                  n_nodes_pad=n_nodes, n_edges_pad=n_edges)
    assert block.n_edges < n_edges  # pads at the tail
    return block


@pytest.mark.parametrize("C,L", [(8, 128), (8, 16), (3, 4)])
def test_block_layout_sums_the_senders(C, L):
    """Row v of the block's layout holds the senders u of u -> v: its
    SlimSell sum is the segment sum over the block's edges."""
    block = _block()
    csr = psampler.block_csr(block)
    assert csr.nnz == block.n_edges and csr.n == block.node_ids.size
    tiled = pf.build_slimsell(csr, C=C, L=L).to_torch("cpu")
    assert not pf.is_symmetric(tiled)
    X = torch.from_numpy(np.random.default_rng(C + L).standard_normal(
        (csr.n, 7)).astype(np.float32))
    ei = torch.from_numpy(block.edge_index)
    want = pgnn.seg_sum(pgnn.gather_nodes(X, ei[0]), ei[1], csr.n)
    got = pspmv.slimsell_spmm(psr.REAL, tiled, X)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # the forward runs on the directed layout; its gradient needs A^T
    Xa = X.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="transposed sweep"):
        pag.spmm_aggregate(tiled, Xa).sum().backward()


def test_gin_on_the_block_matches_repro():
    """GIN (reduced widths) on a sampled block: the port's SlimSell and
    segment forwards against ``repro``'s segment forward."""
    block = _block(5)
    n = block.node_ids.size
    host = pf.build_slimsell(psampler.block_csr(block), C=8, L=32)
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((n, 8)).astype(np.float32)
    graph_ids = np.where(block.node_ids >= 0, 0, -1).astype(np.int32)
    jcfg = jgnn.GINConfig(d_in=8, d_hidden=16, n_classes=2)
    jp = jgnn.gin_init(jcfg, jax.random.PRNGKey(5))
    want = np.asarray(jgnn.gin_forward(jp, {
        "node_feat": jnp.asarray(feat), "edge_index": jnp.asarray(block.edge_index),
        "graph_ids": jnp.asarray(graph_ids), "n_graphs": 1}, jcfg))
    pcfg = pgin_cfg.reduced_config()
    pp = convert.gnn_params_from_arrays("gin", jax.tree.map(np.asarray, jp),
                                        pcfg, device="cpu")
    batch = convert.gnn_batch_from_arrays(
        {"node_feat": feat, "edge_index": block.edge_index,
         "graph_ids": graph_ids, "n_graphs": 1}, device="cpu")
    batch["tiled"] = host.to_torch("cpu")
    for aggregation in ("segment", "slimsell"):
        with torch.no_grad():
            got = pgnn.gin_forward(pp, batch, dataclasses.replace(
                pcfg, aggregation=aggregation), device="cpu").numpy()
        assert got.shape == want.shape == (1, 2)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert jcells.GNN_SHAPES["minibatch_lg"]["sampled"]
