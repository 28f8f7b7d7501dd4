"""The port's 2D partition against the JAX package's, and its shard views.

``partition_slimsell`` builds the same ``DistSlimSell`` as the JAX
package's, array for array, on four graph families (weighted and not),
three grids, slot space on and off and three (C, L) pairs; the grid
(2, 2, 2) partitions over its (pod, data) rows, R = 4. Each block cut out
as an ``engine.ShardTiled`` carries its own ``tile_ptr`` and ``cl``; the
sweeps over a shard equal the sweeps over the whole layout with the
operand cut to the shard's column range and the result to its rows
(first-hit pulls on level-homogeneous payloads, where the first hit is
the full reduction); the push mask drops the push index's padding pairs.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core.dist_bfs import partition_slimsell as jpartition
from repro.graphs import generators as jg
from repro_torch.core import direction as dm
from repro_torch.core import semiring
from repro_torch.core.dist_bfs import (load_shard, partition_slimsell,
                                       save_partition, shard)
from repro_torch.core.formats import build_slimsell
from repro_torch.core.spmv import (pull_mm_plain, pull_plain,
                                   spmm_packed_plain, spmm_plain, spmv_plain)
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

FAMILIES = {
    "kron": lambda g: g.kronecker(7, 8, seed=3),
    "er": lambda g: g.erdos_renyi(100, 3, seed=1),
    "star": lambda g: g.star(40),
    "two_components": lambda g: g.two_components(5, 6, seed=5),
}
# grid -> (R, Co): the row shards are the product of the row axes
GRIDS = {"2x2": (2, 2), "4x2": (4, 2), "2x2x2": (4, 2)}
CL = [(8, 16), (4, 8), (3, 5)]
ARRAYS = ("cols", "row_block", "row_vertex", "wts", "deg", "inc_src",
          "inc_tile")
STATICS = ("n", "C", "L", "R", "Co", "n_col", "chunks_per_shard", "t_max")


@functools.lru_cache(maxsize=None)
def graphs(name: str, weighted: bool):
    """(JAX CSR, port CSR) of one family, built by each package."""
    jcsr, pcsr = FAMILIES[name](jg), FAMILIES[name](pg)
    if weighted:
        jcsr = jg.with_random_weights(jcsr, seed=4)
        pcsr = pg.with_random_weights(pcsr, seed=4)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    return jcsr, pcsr


@pytest.mark.parametrize("CL", CL, ids=lambda c: f"C{c[0]}L{c[1]}")
@pytest.mark.parametrize("slot_space", [False, True])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_partition_equals_jax(name, weighted, grid, slot_space, CL):
    jcsr, pcsr = graphs(name, weighted)
    R, Co = GRIDS[grid]
    C, L = CL
    want = jpartition(jcsr, R, Co, C=C, L=L, slot_space=slot_space)
    got = partition_slimsell(pcsr, R, Co, C=C, L=L, slot_space=slot_space,
                             device="cpu")
    for f in STATICS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    # each chunk's length in each column range: its longest row there
    live = (want.cols >= 0).sum(axis=-1)                 # [R, Co, T, C]
    lengths = np.zeros((R, Co, want.chunks_per_shard, C), np.int64)
    for i in range(R):
        for j in range(Co):
            np.add.at(lengths[i, j], want.row_block[i, j], live[i, j])
    assert np.array_equal(got.chunk_len, lengths.max(axis=-1))


# ------------------------------------------------------------- shard views


@functools.lru_cache(maxsize=None)
def layouts(name: str, R: int, Co: int, C: int, L: int):
    """(partition, whole layout on the CPU) of a weighted family."""
    _, csr = graphs(name, True)
    return (partition_slimsell(csr, R, Co, C=C, L=L, device="cpu"),
            build_slimsell(csr, C=C, L=L).to_torch("cpu"))


SHARD_CASES = [("kron", 2, 2, 4, 8), ("kron", 4, 2, 8, 16),
               ("er", 2, 2, 3, 5), ("star", 2, 2, 4, 8),
               ("two_components", 4, 2, 4, 8)]


def shard_ids(case):
    return "{}-R{}Co{}-C{}L{}".format(*case)


def blocks(part):
    return [(i, j) for i in range(part.R) for j in range(part.Co)]


def restrict(part, i, j, whole_y, zero):
    """The whole layout's result kept on shard i's rows, zero elsewhere."""
    rows = part.row_vertex[i].reshape(-1)
    keep = torch.zeros(part.n, dtype=torch.bool)
    keep[torch.from_numpy(rows[rows >= 0]).long()] = True
    if whole_y.ndim > 1:
        keep = keep[:, None]
    return torch.where(keep, whole_y, torch.tensor(zero, dtype=whole_y.dtype))


def column_range(part, j, x, zero):
    """(the shard's operand: x's column range j padded with zero to n_col,
    x with every row outside that range set to zero)."""
    lo, hi = j * part.n_col, min((j + 1) * part.n_col, part.n)
    local = torch.full((part.n_col,) + tuple(x.shape[1:]), zero,
                       dtype=x.dtype)
    local[: hi - lo] = x[lo:hi]
    cut = torch.full_like(x, zero)
    cut[lo:hi] = x[lo:hi]
    return local, cut


def operand(sr, shape, rng, homogeneous=False):
    """A random operand of the semiring's type: small whole numbers (the
    real sums are then exact in any order), the zero in about half the
    rows; ``homogeneous`` keeps one non-zero value (level-homogeneous)."""
    vals = rng.integers(1, 6, size=shape)
    if homogeneous:
        vals[:] = 1
    live = rng.random(shape) < 0.5
    x = torch.from_numpy(np.where(live, vals, 0)).to(sr.dtype)
    if sr.zero != 0:
        x = torch.where(torch.from_numpy(live), x,
                        torch.tensor(sr.zero, dtype=sr.dtype))
    return x


@pytest.mark.parametrize("case", SHARD_CASES, ids=shard_ids)
def test_shard_layout(case):
    """tile_ptr covers every tile (the padding in the last real chunk),
    cl keeps the kernels' work lists off the padding tiles, and the push
    index's padding pairs point past the tiles."""
    part, _ = layouts(*case)
    for i, j in blocks(part):
        s = shard(part, i, j)
        n_t = -(-s.cl.astype(np.int64) // s.L)       # real tiles a chunk
        n_real = int(n_t.sum())
        assert (s.cols[n_real:] == -1).all()
        assert s.tile_ptr[0] == 0 and s.tile_ptr[-1] == s.n_tiles
        assert (np.diff(s.tile_ptr) >= n_t).all()
        for c in np.nonzero(n_t)[0]:
            first = s.tile_ptr[c]
            assert (s.row_block[first:first + n_t[c]] == c).all()
        t = s.to_torch("cpu")
        pieces, _, _ = ops.spmm_work(t.tile_ptr, t.cl, t.L, 2)
        swept = pieces[:, 2] > pieces[:, 1]   # an empty piece reads no tile
        assert (pieces[swept, 2] <= n_real).all()
        items, _, _, _ = ops.spmv_work(t.tile_ptr, t.cl, t.L, 2)
        read = items[:, 2] > 0
        last = items[:, 1] + (items[:, 2] + t.L - 1) // t.L
        assert (last[read] <= n_real).all()
        assert (s.inc_tile[s.inc_tile < s.n_tiles] < n_real).all()


@pytest.mark.parametrize("case", SHARD_CASES, ids=shard_ids)
def test_push_mask_drops_padding_pairs(case):
    part, _ = layouts(*case)
    rng = np.random.default_rng(1)
    for i, j in blocks(part):
        t = shard(part, i, j).to_torch("cpu")
        assert int((t.inc_tile == t.n_tiles).sum()) \
            == part.inc_src.shape[-1] - int((t.inc_tile < t.n_tiles).sum())
        sb = torch.from_numpy(rng.random(part.n_col) < 0.2)
        got = dm.push_tile_mask(t, sb)
        hit = (t.cols >= 0) & sb[t.cols.clamp_min(0).long()]
        assert torch.equal(got, hit.flatten(1).any(dim=1))


@pytest.mark.parametrize("case", SHARD_CASES, ids=shard_ids)
@pytest.mark.parametrize("name", ["tropical", "real", "boolean", "selmax"])
def test_shard_push_sweeps_equal_whole_layout(case, name):
    part, whole = layouts(*case)
    sr = semiring.get(name)
    rng = np.random.default_rng(2)
    for i, j in blocks(part):
        t = shard(part, i, j).to_torch("cpu")
        mask = torch.from_numpy(rng.random(t.n_tiles) < 0.7)
        for shape in ((part.n,), (part.n, 5)):
            x = operand(sr, shape, rng)
            local, cut = column_range(part, j, x, sr.zero)
            plain = spmv_plain if len(shape) == 1 else spmm_plain
            want = restrict(part, i, j, plain(sr, whole, cut), sr.zero)
            assert torch.equal(plain(sr, t, local), want), (i, j, shape)
            # through the wrappers too (a CPU tensor takes the plain version)
            sweep = ops.spmv if len(shape) == 1 else ops.spmm
            assert torch.equal(sweep(sr, t, local), want)
            # under a tile mask the rows outside the shard stay the zero
            outside = ~restrict(part, i, j, torch.ones(part.n,
                                                       dtype=torch.bool), False)
            got = plain(sr, t, local, mask)
            assert (got[outside] == torch.tensor(sr.zero, dtype=sr.dtype)).all()


@pytest.mark.parametrize("case", SHARD_CASES, ids=shard_ids)
def test_shard_weighted_and_packed_sweeps_equal_whole_layout(case):
    part, whole = layouts(*case)
    rng = np.random.default_rng(3)
    mp = semiring.MINPLUS
    for i, j in blocks(part):
        t = shard(part, i, j).to_torch("cpu")
        for shape in ((part.n,), (part.n, 5)):
            x = torch.from_numpy(np.where(rng.random(shape) < 0.4,
                                          rng.random(shape), np.inf)
                                 .astype(np.float32))
            local, cut = column_range(part, j, x, mp.zero)
            plain = spmv_plain if len(shape) == 1 else spmm_plain
            want = restrict(part, i, j, plain(mp, whole, cut, None, whole.wts),
                            mp.zero)
            assert torch.equal(plain(mp, t, local, None, t.wts), want)
        words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (part.n, 2))
                                 .astype(np.int32))
        local, cut = column_range(part, j, words, 0)
        want = restrict(part, i, j, spmm_packed_plain(whole, cut), 0)
        assert torch.equal(spmm_packed_plain(t, local), want)
        assert torch.equal(ops.spmm_packed(t, local), want)


@pytest.mark.parametrize("case", SHARD_CASES, ids=shard_ids)
@pytest.mark.parametrize("name", ["tropical", "real", "boolean", "selmax"])
def test_shard_pull_sweeps_equal_whole_layout(case, name):
    """The pulls over a shard on a level-homogeneous operand (one non-zero
    value) equal the whole layout's cut to the shard; under real the first
    hitting tile's sum differs between the two tilings, so there only the
    rows that hit agree."""
    part, whole = layouts(*case)
    sr = semiring.get(name)
    rng = np.random.default_rng(4)
    z = torch.tensor(sr.zero, dtype=sr.dtype)
    for i, j in blocks(part):
        t = shard(part, i, j).to_torch("cpu")
        for shape in ((part.n,), (part.n, 5)):
            x = operand(sr, shape, rng, homogeneous=True)
            nf = torch.from_numpy(rng.random(shape) < 0.6)
            local, cut = column_range(part, j, x, sr.zero)
            pull = pull_plain if len(shape) == 1 else pull_mm_plain
            want = restrict(part, i, j, pull(sr, whole, cut, nf), sr.zero)
            got = pull(sr, t, local, nf)
            if name == "real":
                assert torch.equal(got != z, want != z)
            else:
                assert torch.equal(got, want)
            wrapper = ops.pull if len(shape) == 1 else ops.pull_mm
            assert torch.equal(wrapper(sr, t, local, nf), got)


def test_empty_block_gives_zero():
    """star(40) at R = Co = 2: the leaves' rows (row shard 1) have their one
    neighbour, the centre, in column range 0, so block (1, 1) has no tile
    and its sweeps give the semiring zero everywhere."""
    _, csr = graphs("star", False)
    part = partition_slimsell(csr, 2, 2, C=4, L=8, device="cpu")
    t = shard(part, 1, 1).to_torch("cpu")
    assert int(t.cl.sum()) == 0 and (t.cols == -1).all()
    for name in ("tropical", "real", "boolean", "selmax"):
        sr = semiring.get(name)
        x = operand(sr, (part.n_col, 3), np.random.default_rng(5))
        y = ops.spmm(sr, t, x)
        assert y.shape == (part.n, 3)
        assert (y == torch.tensor(sr.zero, dtype=sr.dtype)).all()


def test_save_and_load_shard(tmp_path):
    part, _ = layouts("kron", 2, 2, 4, 8)
    save_partition(part, str(tmp_path))
    for i, j in blocks(part):
        a, b = shard(part, i, j), load_shard(str(tmp_path), i, j)
        for f in ("n", "n_x", "C", "L", "n_chunks", "row", "col"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("cols", "row_block", "row_vertex", "tile_ptr", "cl", "deg",
                  "inc_src", "inc_tile", "wts"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
