"""The batched pull kernel's pieces and first-hit fold, on the CPU.

The kernel (``kernels/csrc/slimsell_pull_mm.cu``) takes the SpMV's work
list (``kernels.ops.spmv_work``): each piece of a chunk writes, for each
pending (row, column), the first hit of its own kept tiles, and a split
chunk's pieces are folded by taking the first piece in piece order whose
value is not the semiring zero; that is not the semiring add. A numpy
emulation of it, piece by piece, equals ``pull_mm_plain`` and the
transcription of the TPU kernel's grid loop
(``test_torch_pull.pallas_pull_grid``) exactly, and ``repro``'s jnp
``slimsell_pull_mm`` (the full reduction) under the pull contract of
``test_torch_pull``: the same nonzero pattern, equal values on
level-homogeneous tropical and on boolean frontiers, and each sel-max
value one of its row's kept contributions. The graphs and layouts are
``test_torch_spmm_pieces``'s (a star, a Kronecker graph and a ring of
cliques; C=8 with L=128, 16 and 1, C=3 and sigma=1), with masks that drop
part of a split chunk. One case has two pieces of the star's hub chunk
hit the hub with different values under real and sel-max, where a fold by
add, by max or by the last piece gives another value than the plain
version.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pull import (_NP, _check_selmax_values, _operand, _reduce,
                             pallas_pull_grid)
from test_torch_spmm_pieces import (  # noqa: F401 (layouts: the fixture)
    GRAPHS, LAYOUTS, PER_PIECE, _per_piece, _split_mask, _work, layouts)

from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro_torch.core import semiring as psr
from repro_torch.core.spmv import pull_mm_plain, pull_plain
from repro_torch.kernels import ops

PULL_SEMIRINGS = sorted(_NP)


def _fold_pieces(kind, name, vals):
    """The values [pieces, C, B] of one chunk's pieces, folded in piece
    order: "first" takes the first that is not zero (the kernel's fold);
    "add" (the semiring add), "max" and "last" (the last that is not zero)
    are folds the kernel must not make."""
    add, _, zero = _NP[name]
    hit = vals != zero
    if kind == "first":
        first = np.take_along_axis(vals, hit.argmax(axis=0)[None], 0)[0]
        return np.where(hit.any(axis=0), first, zero)
    if kind == "last":
        idx = len(vals) - 1 - hit[::-1].argmax(axis=0)
        last = np.take_along_axis(vals, idx[None], 0)[0]
        return np.where(hit.any(axis=0), last, zero)
    return (add if kind == "add" else np.maximum).reduce(vals, axis=0)


def pull_pieces_then_fold(name, pt, X, nf, mask, per_piece, fold="first"):
    """numpy emulation of the batched pull kernel over ``ops.spmv_work``'s
    pieces at ``per_piece`` tiles: each piece walks its kept tiles below
    ``cl`` in order and keeps, for each pending (row, column), the
    reduction of its first tile that is not the semiring zero (zero if
    none), leaving the piece once no column of the chunk is pending; the
    pieces of a chunk are then folded in piece order by ``fold``. X [n, B],
    nf bool[n, B], mask bool[T] or None -> Y [n, B]."""
    _, edge, zero = _NP[name]
    pieces, _, _ = _work("spmv", pt, per_piece)
    cols, rv = pt.cols.numpy(), pt.row_vertex.numpy()
    tp, cl = pt.tile_ptr.numpy(), pt.cl.numpy()
    n, B = X.shape
    pending = nf[np.where(rv < 0, 0, rv)] & (rv >= 0)[..., None]  # [chunks, C, B]
    values = {}
    for chunk, t0, t1, _ in pieces.tolist():
        pend = pending[chunk].copy()
        val = np.full((pt.C, B), zero, dtype=X.dtype)
        for t in range(t0, t1):
            if not pend.any():
                break
            if mask is not None and not mask[t]:
                continue
            lim = min(pt.L, cl[chunk] - (t - tp[chunk]) * pt.L)
            c = cols[t, :, :lim]
            g = np.where((c < 0)[..., None], zero,
                         edge(X[np.where(c < 0, 0, c)]))        # [C, lim, B]
            red = _reduce(name, g, 1)
            hit = pend & (red != zero)
            val = np.where(hit, red, val)
            pend &= ~hit
        values.setdefault(chunk, []).append(val)
    Y = np.full((n + 1, B), zero, dtype=X.dtype)
    for chunk, vals in values.items():
        Y[np.where(rv[chunk] < 0, n, rv[chunk])] = _fold_pieces(
            fold, name, np.stack(vals))
    return Y[:n]


def _grid_host(pt):
    """The layout fields ``test_torch_pull``'s helpers read, as numpy
    arrays."""
    return SimpleNamespace(cols=pt.cols.numpy(), row_block=pt.row_block.numpy(),
                           row_vertex=pt.row_vertex.numpy(),
                           tile_ptr=pt.tile_ptr.numpy(), n_tiles=pt.n_tiles)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_piece", PER_PIECE)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pull_pieces_then_fold_equals_plain_grid_and_jnp(layouts, graph,
                                                         layout, per_piece,
                                                         masked):
    """The pull kernel's pieces and first-hit fold, emulated: exactly
    ``pull_mm_plain`` and the TPU grid loop's transcription; against
    ``repro``'s jnp pull (the full reduction), the same nonzero pattern,
    equal values on level-homogeneous tropical and on boolean frontiers,
    and each sel-max value one of its row's kept contributions."""
    _, jt, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, "spmv")
    pieces, _, _ = _work("spmv", pt, P)
    rng = np.random.default_rng([len(graph), len(layout), P, masked, 4])
    mask = _split_mask(pt, pieces, rng) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    host = _grid_host(pt)
    for name in PULL_SEMIRINGS:
        zero = _NP[name][2]
        for level in (False, True):
            X = _operand(name, (pt.n, 5), rng, level=level)
            nf = rng.random((pt.n, 5)) < 0.6
            got = pull_pieces_then_fold(name, pt, X, nf, mask, P)
            plain = pull_mm_plain(psr.get(name), pt, torch.from_numpy(X),
                                  torch.from_numpy(nf), tm).numpy()
            assert np.array_equal(got, plain), (name, level)
            assert np.array_equal(got, pallas_pull_grid(name, host, X, nf, mask))
            if not level and name == "tropical":
                continue  # the jnp contract holds on BFS's level frontiers
            # always a mask array (all true for every tile kept): the jnp
            # sweep's traces are then shared by both mask cases
            want = np.asarray(jspmv.slimsell_pull_mm(
                jsr.get(name), jt, jnp.asarray(X), row_mask=jnp.asarray(nf),
                tile_mask=jnp.asarray(np.ones(pt.n_tiles, bool)
                                      if mask is None else mask),
                backend="jnp"))
            assert np.array_equal(got != zero, want != zero), name
            if name in ("tropical", "boolean"):
                assert np.array_equal(got, want), name
            if name == "selmax":
                _check_selmax_values(host, X, got, mask)


@pytest.mark.parametrize("layout", ["C8L1", "C8L16", "C8L128"])
@pytest.mark.parametrize("name", ["real", "selmax"])
def test_pull_fold_takes_the_first_hitting_piece(layouts, name, layout):
    """Two pieces of the star's hub chunk (cut into about eight) hit the
    hub, in every column, with different values: the second piece with the
    smaller values, the last with larger ones. The kernel's fold (the
    first piece that is not zero) equals the plain version and the grid
    loop; a fold by the semiring add, by max or by the last piece that hit
    does not."""
    _, _, pt = layouts[("star", layout)]
    P = _per_piece("eighth", pt)
    pieces, _, _ = _work("spmv", pt, P)
    rv, cols = pt.row_vertex.numpy(), pt.cols.numpy()
    chunk, r = map(int, np.argwhere(rv == 0)[0])  # the hub's row
    hub = pieces[pieces[:, 0] == chunk].tolist()
    assert len(hub) >= 3
    u_a = int(cols[hub[1][1], r, 0])    # a leaf in the second piece
    u_b = int(cols[hub[-1][1], r, 0])   # and one in the last
    X = np.zeros((pt.n, 3), np.float32)
    X[u_a], X[u_b] = [1, 2, 3], [5, 7, 9]
    nf = np.ones((pt.n, 3), bool)
    got = pull_pieces_then_fold(name, pt, X, nf, None, P)
    plain = pull_mm_plain(psr.get(name), pt, torch.from_numpy(X),
                          torch.from_numpy(nf)).numpy()
    assert np.array_equal(got, plain) and np.array_equal(got[0], X[u_a])
    assert np.array_equal(got, pallas_pull_grid(name, _grid_host(pt), X, nf,
                                                None))
    for wrong in ("add", "max", "last"):
        bad = pull_pieces_then_fold(name, pt, X, nf, None, P, fold=wrong)
        assert not np.array_equal(bad, plain), wrong


def _tile_lanes(L):
    """Lanes a tile takes in the single-source pull kernel: the least power
    of two whose ``SPMV_GROUP`` slots a lane cover L, at most 32."""
    lanes = 1
    while lanes < 32 and ops.SPMV_GROUP * lanes < L:
        lanes *= 2
    return lanes


def pull_rows_then_fold(name, pt, x, nf, mask, per_piece, fold="first"):
    """numpy emulation of the single-source pull kernel over
    ``ops.spmv_work``'s items at ``per_piece`` tiles, in the list's
    (width-class) order. A row of an item with LANES lanes
    (``ops.spmv_lanes``) takes LANES // LT of its tiles a step, LT =
    min(LANES, ``_tile_lanes(L)``); each tile's value is the reduction of
    its slots below the row's slot count (zero for a masked tile or one
    past them), and the first tile of a step, in tile order, whose value
    is not the semiring zero is the row's hit, after which the row reads
    no more. A row that is not pending reads nothing and gives zero. A
    chunk of one piece writes y, the pieces of a split chunk a scratch
    [slots, C] that ``fold`` folds in piece order. y starts poisoned and
    every vertex is written exactly once. x [n], nf bool[n], mask bool[T]
    or None -> y [n]."""
    _, edge, zero = _NP[name]
    items, _, folds, slots = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L, per_piece)
    lanes = ops.spmv_lanes(items[:, 2]).tolist()
    cols, rv, L = pt.cols.numpy(), pt.row_vertex.numpy(), pt.L
    poison = 7 if name == "boolean" else np.nan
    y = np.full(pt.n, poison, dtype=x.dtype)
    partial = np.full((slots, pt.C), poison, dtype=x.dtype)
    writes = np.zeros(pt.n, int)
    for (chunk, t0, row_slots, slot), w in zip(items.tolist(), lanes):
        step = w // min(w, _tile_lanes(L))                    # tiles a step
        for r, v in enumerate(rv[chunk]):
            pending = bool(v >= 0 and nf[v])
            val, done = zero, 0
            while pending and done < row_slots:
                for d in range(done, done + step * L, L):
                    t = t0 + d // L
                    if d >= row_slots or (mask is not None and not mask[t]):
                        continue                              # zero
                    c = cols[t, r, :min(L, row_slots - d)]
                    c = c[c >= 0]
                    red = _reduce(name, edge(x[c]), 0) if c.size else zero
                    if red != zero:                           # the hit
                        val, pending = red, False
                        break
                done += step * L
            if slot >= 0:
                partial[slot, r] = val
            elif v >= 0:
                y[v] = val
                writes[v] += 1
    for chunk, s0, k, _ in folds.tolist():
        vals = _fold_pieces(fold, name, partial[s0:s0 + k])
        for r, v in enumerate(rv[chunk]):
            if v >= 0:
                y[v] = vals[r]
                writes[v] += 1
    assert (writes == 1).all()
    return y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_piece", PER_PIECE)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pull_rows_then_fold_equals_plain_grid_and_jnp(layouts, graph, layout,
                                                       per_piece, masked):
    """The single-source pull kernel's rows, per-tile exit and first-hit
    fold, emulated on a 1-D x: exactly ``pull_plain`` and the TPU grid
    loop's transcription; against ``repro``'s jnp ``slimsell_pull`` (the
    full reduction), the same nonzero pattern, equal values on
    level-homogeneous tropical and on boolean frontiers, and each sel-max
    value one of its row's kept contributions."""
    _, jt, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, "spmv")
    pieces, _, _ = _work("spmv", pt, P)
    rng = np.random.default_rng([len(graph), len(layout), P, masked, 6])
    mask = _split_mask(pt, pieces, rng) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    host = _grid_host(pt)
    for name in PULL_SEMIRINGS:
        zero = _NP[name][2]
        for level in (False, True):
            x = _operand(name, (pt.n,), rng, level=level)
            nf = rng.random(pt.n) < 0.6
            got = pull_rows_then_fold(name, pt, x, nf, mask, P)
            plain = pull_plain(psr.get(name), pt, torch.from_numpy(x),
                               torch.from_numpy(nf), tm).numpy()
            assert np.array_equal(got, plain), (name, level)
            grid = pallas_pull_grid(name, host, x[:, None], nf[:, None], mask)
            assert np.array_equal(got, grid[:, 0])
            if not level and name == "tropical":
                continue  # the jnp contract holds on BFS's level frontiers
            want = np.asarray(jspmv.slimsell_pull(
                jsr.get(name), jt, jnp.asarray(x), row_mask=jnp.asarray(nf),
                tile_mask=jnp.asarray(np.ones(pt.n_tiles, bool)
                                      if mask is None else mask),
                backend="jnp"))
            assert np.array_equal(got != zero, want != zero), name
            if name in ("tropical", "boolean"):
                assert np.array_equal(got, want), name
            if name == "selmax":
                _check_selmax_values(host, x[:, None], got[:, None], mask)


# the pieces of the star's hub chunk (cut into about eight) that hold the
# hub's hits; with two, the later one holds larger values
HUB_HITS = {"first": [0], "middle": [None], "last": [-1],
            "first_and_last": [0, -1], "middle_and_last": [None, -1]}


@pytest.mark.parametrize("where", sorted(HUB_HITS))
@pytest.mark.parametrize("layout", ["C8L1", "C8L16", "C8L128"])
@pytest.mark.parametrize("name", ["real", "selmax"])
def test_single_pull_fold_takes_the_first_hitting_piece(layouts, name, layout,
                                                        where):
    """The hub's neighbours in the first, a middle or the last piece of its
    chunk alone hold values (the rest the semiring zero), or those of two
    pieces, the later with larger ones: the single-source kernel's fold
    (the first piece that is not zero) equals ``pull_plain``, the grid
    loop and the hit piece's reduction; with two hitting pieces, a fold by
    the semiring add, by max or by the last piece that hit does not."""
    _, _, pt = layouts[("star", layout)]
    P = _per_piece("eighth", pt)
    pieces, _, _ = _work("spmv", pt, P)
    rv, cols = pt.row_vertex.numpy(), pt.cols.numpy()
    chunk, r = map(int, np.argwhere(rv == 0)[0])  # the hub's row
    hub = pieces[pieces[:, 0] == chunk].tolist()
    assert len(hub) >= 3
    x = np.zeros(pt.n, np.float32)
    for k, piece in enumerate(HUB_HITS[where]):
        _, t0, t1, _ = hub[len(hub) // 2 if piece is None else piece]
        leaves = cols[t0:t1, r].reshape(-1)
        x[leaves[leaves >= 0]] = 3 + 10 * k + np.arange((leaves >= 0).sum()) % 3
    nf = np.ones(pt.n, bool)
    got = pull_rows_then_fold(name, pt, x, nf, None, P)
    plain = pull_plain(psr.get(name), pt, torch.from_numpy(x),
                       torch.from_numpy(nf)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, pallas_pull_grid(
        name, _grid_host(pt), x[:, None], nf[:, None], None)[:, 0])
    # the hub's value is its first hitting tile's reduction
    _, t0, t1, _ = hub[len(hub) // 2 if HUB_HITS[where][0] is None
                       else HUB_HITS[where][0]]
    first = next(t for t in range(t0, t1)
                 if (x[cols[t, r][cols[t, r] >= 0]] != 0).any())
    leaves = cols[first, r][cols[first, r] >= 0]
    assert got[0] == _reduce(name, x[leaves], 0)
    for wrong in ("add", "max", "last"):
        bad = pull_rows_then_fold(name, pt, x, nf, None, P, fold=wrong)
        assert np.array_equal(bad, plain) == (len(HUB_HITS[where]) == 1), wrong


@pytest.mark.parametrize("layout", ["C8L1", "C8L16", "C8L128"])
@pytest.mark.parametrize("name", PULL_SEMIRINGS)
def test_single_pull_takes_the_first_tile_of_a_step(layouts, name, layout):
    """The star's hub chunk at the kernel's own piece size is one piece of
    1023 slots, a 32-lane row that takes several tiles a step (two at
    L=128, 16 at L=16, 32 at L=1). Hits in the second and third tile of
    the row, the third with other values: the row takes the second's
    reduction, as the plain version does, never the two tiles' add (but
    under boolean, whose hits are all 1)."""
    _, _, pt = layouts[("star", layout)]
    P = _per_piece("kernel", pt, "spmv")
    items, _, _, _ = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L, P)
    rv, cols = pt.row_vertex.numpy(), pt.cols.numpy()
    chunk, r = map(int, np.argwhere(rv == 0)[0])
    (hub,) = [it for it in items.tolist() if it[0] == chunk]
    assert int(ops.spmv_lanes(torch.tensor([hub[2]]))) == 32
    add, edge, zero = _NP[name]
    x = np.full(pt.n, zero, dtype=np.int32 if name == "boolean" else np.float32)
    second, third = (cols[hub[1] + k, r] for k in (1, 2))
    x[second[second >= 0]] = 1 if name == "boolean" else 2
    # the third tile's values win any add of the two tiles: smaller under
    # tropical's min, larger under sel-max's max, summed under real
    x[third[third >= 0]] = {"boolean": 1, "tropical": 1}.get(name, 5)
    nf = np.ones(pt.n, bool)
    got = pull_rows_then_fold(name, pt, x, nf, None, P)
    plain = pull_plain(psr.get(name), pt, torch.from_numpy(x),
                       torch.from_numpy(nf)).numpy()
    assert np.array_equal(got, plain)
    assert got[0] == _reduce(name, edge(x[second[second >= 0]]), 0)
    if name != "boolean":
        both = _reduce(name, edge(x[np.concatenate([second, third])[
            np.concatenate([second, third]) >= 0]]), 0)
        assert got[0] != both
