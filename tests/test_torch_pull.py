"""The port's plain pull sweeps (what a CPU tensor runs) against two things.

1. A numpy transcription, in this file, of the TPU pull kernels' grid loop
   (``repro/kernels/slimsell_pull.py``: ``_pull_kernel`` and
   ``_pull_mm_kernel`` with the wrappers ``ops.pull`` / ``ops.pull_mm``
   around them): tile ids in SlimWork order, first-visit init of each
   output block, pending rows, add. It stands in for the Pallas kernels,
   which do not trace under the installed JAX. Compared exactly.
2. The JAX package's jnp ``slimsell_pull`` / ``slimsell_pull_mm``, which
   take the full reduction, under the pull contract: the same nonzero
   pattern, equal values on level-homogeneous tropical and on boolean
   frontiers, and each sel-max value one of its row's contributions.

Inputs are integers or +-inf, so every comparison is exact.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.graphs import generators as jg
from repro_torch.core import formats as pf
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

SEMIRINGS = ["tropical", "real", "boolean", "selmax"]
MASKS = ["none_given", "all_kept", "none_kept", "random"]
NF_KINDS = ["random", "all", "none"]
GRAPHS = {"kron": lambda g: g.kronecker(8, 8, seed=1),
          "two": lambda g: g.two_components(6, 6, seed=4)}

# (add, edge, zero) of each semiring, in numpy
_NP = {"tropical": (np.minimum, lambda g: g + 1, np.inf),
       "real": (np.add, lambda g: g, 0.0),
       "boolean": (np.maximum, lambda g: g, 0),
       "selmax": (np.maximum, lambda g: g, 0.0)}


def _reduce(name, a, axis):
    if name == "tropical":
        return a.min(axis=axis)
    if name == "real":
        return a.sum(axis=axis)
    return a.max(axis=axis)


def pallas_pull_grid(name, tiled, X, nf_v, tile_mask, chunk_blk=8, d_tile=128):
    """numpy transcription of ``ops.pull_mm`` -> ``slimsell_pull_mm_pallas``
    (grid (B // d_tile, T)) -> ``_scatter_blocks``; at B = 1 it is
    ``ops.pull`` -> ``_pull_kernel``, the same body without a lane axis.
    X [n, B], nf_v bool[n, B] -> Y [n, B]."""
    add, edge, zero = _NP[name]
    cols, rb, rv = tiled.cols, tiled.row_block, tiled.row_vertex
    T, C, L = cols.shape
    n_chunks = rv.shape[0]
    n, B = X.shape
    d_tile = min(d_tile, B)
    if B % d_tile:
        d_tile = math.gcd(B, d_tile)
    # SlimWork compaction (ops.compact_tile_ids): kept ids first, the tail
    # repeats the last kept id
    if tile_mask is None:
        ids, n_active = np.arange(T), T
    else:
        order = np.argsort(~tile_mask, kind="stable")
        n_active = int(tile_mask.sum())
        ids = np.where(np.arange(T) < n_active, order,
                       order[max(n_active - 1, 0)])
    # not-final bits in chunk-row space; padding rows never pend
    nf = nf_v[np.where(rv < 0, 0, rv)] & (rv >= 0)[..., None]
    n_blk = -(-n_chunks // chunk_blk)
    nf = np.concatenate([nf, np.zeros((n_blk * chunk_blk - n_chunks, C, B),
                                      bool)])
    garbage = 7 if name == "boolean" else np.nan  # never-visited blocks
    out = np.full((n_blk * chunk_blk, C, B), garbage, dtype=X.dtype)
    pad = cols < 0
    safe = np.where(pad, 0, cols)
    for dt in range(B // d_tile):
        lanes = slice(dt * d_tile, (dt + 1) * d_tile)
        for t in range(T):
            tid = ids[t]
            chunk = rb[tid]
            blk = chunk // chunk_blk
            if t == 0 or blk != rb[ids[max(t - 1, 0)]] // chunk_blk:
                out[blk * chunk_blk:(blk + 1) * chunk_blk, :, lanes] = zero
            row = blk * chunk_blk + chunk % chunk_blk
            cur = out[row, :, lanes]                            # [C, dt]
            pending = nf[row, :, lanes] & (cur == zero)
            if t < n_active and pending.any():
                g = X[safe[tid].reshape(-1), lanes].reshape(C, L, -1)
                contrib = np.where(pad[tid][..., None], zero, edge(g))
                red = _reduce(name, contrib, axis=1)            # [C, dt]
                out[row, :, lanes] = np.where(pending, add(cur, red), cur)
    # epilogue: zero the chunks no kept tile maps to, scatter to vertices
    covered = np.zeros(n_chunks, bool)
    covered[rb if tile_mask is None else rb[tile_mask]] = True
    y_blocks = np.where(covered[:, None, None], out[:n_chunks], zero)
    Y = np.full((n + 1, B), zero, dtype=X.dtype)
    Y[np.where(rv < 0, n, rv).reshape(-1)] = y_blocks.reshape(-1, B)
    return Y[:n]


def _host(graph):
    return pf.build_slimsell(GRAPHS[graph](pg), C=8, L=16)


@pytest.fixture(scope="module")
def kron():
    jt = jf.build_slimsell(GRAPHS["kron"](jg), C=8, L=16).to_jax()
    host = _host("kron")
    return jt, host, host.to_torch("cpu")


def _operand(name, shape, rng, *, level=False):
    """Integer-valued operands; ``level`` gives a level-homogeneous
    tropical frontier (every finite value the same)."""
    if name == "boolean":
        return rng.integers(0, 2, size=shape).astype(np.int32)
    x = rng.integers(0, 4, size=shape).astype(np.float32)
    if name == "tropical":
        if level:
            x[:] = 3.0
        x[rng.random(shape) < 0.6] = np.inf
    if name == "selmax":
        x *= rng.integers(1, 300, size=shape)
    return x


def _mask(kind, host, rng):
    T = host.n_tiles
    if kind == "none_given":
        return None
    if kind in ("all_kept", "none_kept"):
        return np.full(T, kind == "all_kept")
    keep_chunk = rng.random(host.n_chunks) < 0.65
    return (rng.random(T) < 0.5) & keep_chunk[host.row_block]


def _nf(kind, shape, rng):
    if kind == "random":
        return rng.random(shape) < 0.6
    return np.full(shape, kind == "all")


def _plain(name, pt, x, nf, mask, width):
    t = None if mask is None else torch.from_numpy(mask)
    if width is None:
        return pspmv.slimsell_pull(psr.get(name), pt, torch.from_numpy(x),
                                   row_mask=torch.from_numpy(nf),
                                   tile_mask=t).numpy()
    return pspmv.slimsell_pull_mm(psr.get(name), pt, torch.from_numpy(x),
                                  row_mask=torch.from_numpy(nf),
                                  tile_mask=t).numpy()


@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_pull_equals_pallas_grid(graph, name, mask_kind, width):
    host = _host(graph)
    pt = host.to_torch("cpu")
    rng = np.random.default_rng([len(graph), SEMIRINGS.index(name),
                                 MASKS.index(mask_kind), width or 0])
    shape = (host.n,) if width is None else (host.n, width)
    mask = _mask(mask_kind, host, rng)
    for nf_kind in NF_KINDS:
        x = _operand(name, shape, rng)
        nf = _nf(nf_kind, shape, rng)
        got = _plain(name, pt, x, nf, mask, width)
        want = pallas_pull_grid(name, host, x.reshape(host.n, -1),
                                nf.reshape(host.n, -1), mask).reshape(shape)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got, want), nf_kind
        if nf_kind == "none":
            assert (got == _NP[name][2]).all()


@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_plain_pull_meets_contract_with_jnp(kron, name, mask_kind, width):
    """Against the full reduction of the JAX package's jnp sweeps."""
    jt, host, pt = kron
    rng = np.random.default_rng([9, SEMIRINGS.index(name),
                                 MASKS.index(mask_kind), width or 0])
    shape = (host.n,) if width is None else (host.n, width)
    mask = _mask(mask_kind, host, rng)
    zero = _NP[name][2]
    jm = None if mask is None else jnp.asarray(mask)
    for nf_kind in NF_KINDS:
        x = _operand(name, shape, rng, level=True)
        nf = _nf(nf_kind, shape, rng)
        got = _plain(name, pt, x, nf, mask, width)
        fn = jspmv.slimsell_pull if width is None else jspmv.slimsell_pull_mm
        want = np.asarray(fn(jsr.get(name), jt, jnp.asarray(x),
                             row_mask=jnp.asarray(nf), tile_mask=jm,
                             backend="jnp"))
        assert np.array_equal(got != zero, want != zero), nf_kind
        if name in ("tropical", "boolean"):
            assert np.array_equal(got, want), nf_kind
        if name == "selmax":
            _check_selmax_values(host, x.reshape(host.n, -1),
                                 got.reshape(host.n, -1), mask)


def _check_selmax_values(host, X, Y, mask):
    """Each nonzero sel-max value is X[u, b] of a neighbour u of v whose
    slot lies in a kept tile of v's chunk."""
    keep = np.ones(host.n_tiles, bool) if mask is None else mask
    for v, b in zip(*np.nonzero(Y)):
        chunk, r = map(int, np.argwhere(host.row_vertex == v)[0])
        t0, t1 = host.tile_ptr[chunk], host.tile_ptr[chunk + 1]
        slots = host.cols[t0:t1][keep[t0:t1], r].reshape(-1)
        slots = slots[slots >= 0]
        assert Y[v, b] in X[slots, b]


def test_plain_pull_ranks_and_slicing(kron, monkeypatch):
    """The first-hit tile ranks agree with the values, and slicing the
    chunks (to bound the gather) changes neither."""
    _, host, pt = kron
    rng = np.random.default_rng(5)
    X = torch.from_numpy(_operand("tropical", (host.n, 5), rng))
    nf = torch.from_numpy(_nf("random", (host.n, 5), rng))
    Y, R = pspmv.pull_first_hits(psr.TROPICAL, pt, X, nf)
    assert torch.equal((R >= 0), torch.isfinite(Y))
    assert (R < np.diff(host.tile_ptr).max()).all()
    monkeypatch.setattr(pspmv, "_GATHER_BYTES", 3 * pt.C * pt.L * 5 * 4)
    Y2, R2 = pspmv.pull_first_hits(psr.TROPICAL, pt, X, nf)
    assert torch.equal(Y, Y2) and torch.equal(R, R2)


def test_cpu_pull_launches_no_kernel(kron):
    _, _, pt = kron
    before = ops.launch_counts()
    assert set(before) == {"slimsell_spmv", "slimsell_spmv_wts",
                           "slimsell_spmm", "slimsell_spmm_wts",
                           "slimsell_spmm_gcn", "slimsell_pull",
                           "slimsell_pull_mm", "slimsell_spmv_packed",
                           "slimsell_spmm_packed", "embedding_bag_grouped",
                           "semiring_probe"}
    rows = torch.ones(pt.n, dtype=torch.bool)
    pspmv.slimsell_pull(psr.REAL, pt, torch.zeros(pt.n), row_mask=rows)
    pspmv.slimsell_pull_mm(psr.REAL, pt, torch.zeros(pt.n, 3),
                           row_mask=torch.ones(pt.n, 3, dtype=torch.bool))
    assert ops.launch_counts() == before


def test_pull_wrappers_check_row_mask(kron):
    _, _, pt = kron
    x = torch.zeros(pt.n)
    with pytest.raises(ValueError, match="row_mask"):
        ops.pull(psr.TROPICAL, pt, x, torch.ones(pt.n, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_mask"):
        ops.pull(psr.TROPICAL, pt, x, torch.ones(pt.n + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="row_mask"):
        ops.pull_mm(psr.TROPICAL, pt, torch.zeros(pt.n, 2),
                    torch.ones(pt.n, dtype=torch.bool))
    with pytest.raises(ValueError, match="shape"):
        ops.pull_mm(psr.TROPICAL, pt, x, torch.ones(pt.n, dtype=torch.bool))
