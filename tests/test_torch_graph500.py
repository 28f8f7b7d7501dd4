"""The port's Graph500 harness against the JAX package's: the same search
keys, every tree validated, on the plain (CPU) path."""
import numpy as np
import pytest

from repro import graph500 as jg500
from repro.graphs.generators import kronecker as jkron
from repro_torch import graph500 as pg500
from repro_torch.graphs.generators import kronecker as pkron


def test_run_graph500_matches_jax_package():
    want = jg500.run_graph500(scale=8, edge_factor=16, n_roots=64, batch_size=16)
    got = pg500.run_graph500(scale=8, edge_factor=16, n_roots=64, batch_size=16,
                             device="cpu")
    assert np.array_equal(got.roots, want.roots)
    assert got.validated == want.validated == got.roots.size == 64
    assert (got.n, got.m) == (want.n, want.m)
    assert got.batch_seconds.size == 4 and (got.teps > 0).all()
    assert "validated=64" in got.summary()


def test_sample_roots_match_jax_package():
    a, b = jkron(9, 4, seed=3), pkron(9, 4, seed=3)
    assert np.array_equal(jg500.sample_roots(a, 32), pg500.sample_roots(b, 32))


def test_validate_bfs_tree_rejects_bad_trees():
    csr = pkron(7, 8, seed=1)
    root = int(pg500.sample_roots(csr, 1)[0])
    d, p = pg500.bfs_traditional(csr, root)
    pg500.validate_bfs_tree(csr, root, d, p)
    reached = np.nonzero(d > 1)[0][0]
    bad_d = d.copy()
    bad_d[reached] += 1
    with pytest.raises(AssertionError, match="oracle"):
        pg500.validate_bfs_tree(csr, root, bad_d, p)
    bad_p = p.copy()
    bad_p[reached] = root
    with pytest.raises(AssertionError, match="levels"):
        pg500.validate_bfs_tree(csr, root, d, bad_p)


def test_run_graph500_refuses_a_graph_of_another_scale():
    csr = pkron(6, 4, seed=1)
    with pytest.raises(ValueError, match="scale 7"):
        pg500.run_graph500(scale=7, csr=csr, device="cpu")
    other = pg500.build_slimsell(pkron(5, 4, seed=1), C=8, L=16)
    with pytest.raises(ValueError, match="tiled has n=32"):
        pg500.run_graph500(scale=6, csr=csr, tiled=other, device="cpu")
