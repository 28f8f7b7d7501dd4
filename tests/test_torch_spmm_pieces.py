"""The SpMM's and SpMV's work lists (SlimChunk pieces) and their
split-then-fold order.

The SpMM kernel (``kernels/csrc/slimsell_spmm.cu``) cuts each chunk's
tiles below its length ``cl`` into pieces of at most P tiles
(``kernels.ops.spmm_work``), one block each, and folds the partial rows of
a chunk of several pieces in piece order. The SpMV kernel
(``kernels/csrc/slimsell_spmv.cu``) takes the same pieces at its own P
(``kernels.ops.spmv_work``), each item carrying its rows' slots below
``cl``, sorted by the lanes a row gets. On the CPU, for both ops (the
``op`` axis):

* the work list covers every tile below ``cl`` of every chunk exactly
  once, in order, in pieces of at most P tiles, one empty piece for a chunk
  with none, and numbers the partial slots of the split chunks as the
  folds say; the SpMV's items are sorted by width class, each with the
  least lanes that cover its rows;
* a plain emulation of split-then-fold (``spmm_plain`` / ``spmv_plain``
  over the tiles of each round of pieces, the rounds added in piece order)
  equals ``spmm_plain`` / ``spmv_plain`` and ``repro``'s jnp
  ``slimsell_spmm`` / ``slimsell_spmv``: exactly for tropical, boolean,
  sel-max, real (integer-valued operands) and min-plus, within rtol = atol
  = 1e-5 for the GCN weight (float32 sums in another order; SpMM only).
  The graphs are a star (one hub chunk of many tiles), a small Kronecker
  graph and a ring of cliques, at C=8 with L=128, 16 and 1, at C=3 and at
  sigma=1, with masks that drop part of a split chunk.

The packed SpMM (``kernels/csrc/slimsell_spmm_packed.cu``) takes the
SpMV's items and ORs a split chunk's pieces in piece order: a numpy
emulation of it, item by item, equals ``spmm_packed_plain`` and
``repro``'s jnp ``slimsell_spmm`` under ``boolean_packed`` exactly, at
B = 1, 33, 64 and 97; the packed SpMV (``slimsell_spmv_packed.cu``) takes
the same items with no fold, each piece ORing its rows' bits into the
zeroed bitmap: a numpy emulation of it, the items in a shuffled order,
equals ``spmv_packed_plain`` and ``repro``'s jnp ``slimsell_spmv_packed``
exactly (the pulls' pieces are held in ``test_torch_pull_pieces.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import packing as jpk
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.graphs import generators as jg
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import semiring as psr
from repro_torch.core.spmv import (spmm_packed_plain, spmm_plain,
                                   spmv_packed_plain, spmv_plain)
from repro_torch.kernels import ops

GRAPHS = {
    "star": lambda: jg.star(2 ** 10),
    "kron": lambda: jg.with_random_weights(jg.kronecker(8, 8, seed=1),
                                           low=1.0 / 256.0, high=1.0, seed=2),
    "cliques": lambda: jg.ring_of_cliques(12, 10),
}
# name -> (C, L, sigma): sigma None is n, the main path's sort
LAYOUTS = {"C8L128": (8, 128, None), "C8L16": (8, 16, None),
           "C8L1": (8, 1, None), "C3L16": (3, 16, None), "sigma1": (8, 16, 1)}
# "kernel" is the kernel's own piece size, ops.piece_tiles(L) for the SpMM
# and ops.spmv_piece_tiles(L) for the SpMV; "eighth" cuts the longest chunk
# into about eight pieces
PER_PIECE = ["kernel", "eighth"]
OPS = ["spmm", "spmv"]
SEMIRINGS = ["tropical", "real", "boolean", "selmax", "minplus", "gcn"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def layouts():
    """{(graph, layout): (csr, repro's layout, the port's, carried)}."""
    out = {}
    for g, make in GRAPHS.items():
        csr = make()
        if csr.weights is None:
            csr = jg.with_random_weights(csr, low=1.0 / 256.0, high=1.0, seed=3)
        for name, (C, L, sigma) in LAYOUTS.items():
            host = jf.build_slimsell(csr, C=C, L=L, sigma=sigma)
            out[(g, name)] = (csr, host.to_jax(), _port_layout(host))
    return out


def _port_layout(host):
    """``repro``'s host layout carried into the port, on the CPU."""
    return convert.tiled_from_arrays(
        {k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
        {k: getattr(host, k) for k in convert.LAYOUT_META}, device="cpu")


def _per_piece(per_piece, pt, op="spmm"):
    if per_piece == "kernel":
        return ops.piece_tiles(pt.L) if op == "spmm" \
            else ops.spmv_piece_tiles(pt.L)
    if per_piece == "eighth":
        return max(1, -(-int((-(-pt.cl.long() // pt.L)).max()) // 8))
    return per_piece


def _work(op, pt, P):
    """``(pieces, folds, slots)`` of the op's work list, the pieces as
    (chunk, first tile, end tile, partial slot) in chunk order: the SpMV's
    items turned back into pieces, end = first + ceil(row slots / L)."""
    if op == "spmm":
        return ops.spmm_work(pt.tile_ptr, pt.cl, pt.L, P)
    items, _, folds, slots = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L, P)
    chunk, first, length, slot = items.long().unbind(1)
    pieces = torch.stack([chunk, first, first - (-length // pt.L), slot], 1)
    order = torch.argsort(chunk * (pt.n_tiles + 1) + first)
    return pieces[order].to(torch.int32), folds, slots


def _ranks(pieces):
    """Each piece's rank within its chunk."""
    chunk = pieces[:, 0].long()
    first = torch.searchsorted(chunk, chunk, right=False)
    return torch.arange(chunk.numel()) - first


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("per_piece", PER_PIECE + [1, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_work_list_covers_tiles_below_cl(layouts, graph, layout, per_piece,
                                         op):
    _, _, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, op)
    pieces, folds, slots = _work(op, pt, P)
    assert pieces.dtype == folds.dtype == torch.int32
    assert pieces.shape[1] == folds.shape[1] == 4
    tp, cl = pt.tile_ptr.long().tolist(), pt.cl.long().tolist()
    by_chunk = {}
    for c, t0, t1, s in pieces.tolist():
        by_chunk.setdefault(c, []).append((t0, t1, s))
    assert list(by_chunk) == list(range(pt.n_chunks))  # chunk order, all
    split_slots, next_slot = [], 0
    for c, ps in by_chunk.items():
        live = -(-cl[c] // pt.L)
        tiles = [t for t0, t1, _ in ps for t in range(t0, t1)]
        # every tile below cl once, in order, none past it
        assert tiles == list(range(tp[c], tp[c] + live))
        assert all(t1 - t0 <= P for t0, t1, _ in ps)
        assert all(t1 - t0 >= 1 for t0, t1, _ in ps) or (live == 0
                                                         and len(ps) == 1)
        if len(ps) == 1:
            assert ps[0][2] == -1
        else:
            assert [s for _, _, s in ps] == list(
                range(next_slot, next_slot + len(ps)))
            split_slots.append([c, next_slot, len(ps), 0])
            next_slot += len(ps)
    assert folds.tolist() == split_slots and slots == next_slot


@pytest.mark.parametrize("op", OPS)
def test_work_list_splits_the_hub(layouts, op):
    """The star's hub chunk at the kernel's own piece size: for the SpMM
    the 2^10-vertex star's hub (1023 slots) is 1023 tiles at L=1, four
    pieces at P = 256, and at L=128 its 8 tiles are four pieces of 2; for
    the SpMV (1024 slots a piece) the 2^12-vertex star's hub (4095 slots)
    is four pieces at L=1, 16 and 128, each of the 32 lanes a row."""
    if op == "spmm":
        lay = {name: layouts[("star", name)][2]
               for name in ("C8L1", "C8L128", "C8L16")}
    else:
        star = jg.star(2 ** 12)
        lay = {f"C8L{L}": _port_layout(jf.build_slimsell(star, C=8, L=L))
               for L in (1, 128, 16)}
    for layout, pt in lay.items():
        pieces, folds, slots = _work(op, pt, _per_piece("kernel", pt, op))
        assert folds.tolist() == [[0, 0, 4, 0]] and slots == 4, layout
        assert (pieces[:, 1] <= pieces[:, 2]).all()
        if op == "spmv":
            items, class_items, _, _ = ops.spmv_work(
                pt.tile_ptr, pt.cl, pt.L, ops.spmv_piece_tiles(pt.L))
            hub = items[items[:, 0] == 0]
            assert hub[:, 2].tolist() == [1024, 1024, 1024, 1023]
            assert class_items[-1] == 4


@pytest.mark.parametrize("per_piece", PER_PIECE + [1, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_spmv_items_sorted_by_lanes(layouts, graph, layout, per_piece):
    """Each SpMV item carries the slots of its rows below ``cl`` and gets
    the least of 1, 2, ..., 32 lanes a row whose ``SPMV_GROUP`` (8) slots
    a lane cover them (32 past 256 slots); the items are sorted by that
    width, chunk order kept within a width, and ``class_items`` counts
    each width."""
    _, _, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, "spmv")
    items, class_items, _, _ = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L, P)
    assert items.dtype == torch.int32 and items.shape[1] == 4
    tp, cl = pt.tile_ptr.long(), pt.cl.long()
    chunk, first, length, _ = items.long().unbind(1)
    below = cl[chunk] - (first - tp[chunk]) * pt.L
    assert torch.equal(length, torch.minimum(below, P * pt.L * torch.ones_like(
        below)).clamp_min(0))
    lanes = ops.spmv_lanes(length)
    assert torch.equal(lanes, torch.sort(lanes, stable=True).values)
    assert class_items == [int((lanes == w).sum()) for w in ops.SPMV_LANES]
    assert sum(class_items) == items.shape[0]
    for w in ops.SPMV_LANES:
        rows = length[lanes == w]
        if w < 32:
            assert (rows <= ops.SPMV_GROUP * w).all()
        if w > 1:
            assert (rows > ops.SPMV_GROUP * w // 2).all()
        key = chunk[lanes == w] * (pt.n_tiles + 1) + first[lanes == w]
        assert (key[1:] > key[:-1]).all()  # chunk order within a width


def _operand(name, shape, rng):
    if name == "boolean":
        return rng.integers(0, 2, size=shape).astype(np.int32)
    if name == "gcn":
        return rng.standard_normal(shape).astype(np.float32)
    if name == "minplus":
        x = rng.uniform(0.0, 8.0, shape).astype(np.float32)
        x[rng.random(shape) >= 0.6] = np.inf
        return x
    x = rng.integers(0, 4, size=shape).astype(np.float32)
    if name == "tropical":
        x[rng.random(shape) < 0.4] = np.inf
    if name == "selmax":
        x *= rng.integers(1, 300, size=shape)
    return x


def _split_mask(pt, pieces, rng):
    """Half the tiles, always dropping part (not all) of each split chunk."""
    mask = rng.random(pt.n_tiles) < 0.5
    for c, t0, t1, s in pieces.tolist():
        if s >= 0 and t1 > t0:
            mask[t0] = False
            mask[t1 - 1] = True
    return mask


def split_then_fold(sr, pt, X, mask, per_piece, weights=None, deg=None,
                    op="spmm"):
    """``spmm_plain`` (``spmv_plain`` for an X of one dimension) over the
    tiles of each round of pieces (the j-th piece of every chunk), the
    rounds added in piece order: what the kernel's pieces and fold
    compute."""
    pieces, _, _ = _work(op, pt, per_piece)
    ranks = _ranks(pieces)
    Y = None
    for j in range(int(ranks.max()) + 1):
        keep = torch.zeros(pt.n_tiles, dtype=torch.bool)
        for _, t0, t1, _ in pieces[ranks == j].tolist():
            keep[t0:t1] = True
        if mask is not None:
            keep &= mask
        if X.ndim == 1:
            Yj = spmv_plain(sr, pt, X, keep, weights)
        else:
            Yj = spmm_plain(sr, pt, X, keep, weights, deg)
        Y = Yj if Y is None else sr.reduce(torch.stack([Y, Yj]), 0)
    return Y


def _jnp(name, csr, jt, X, mask):
    """``repro``'s jnp SpMM, or its SpMV for an X of one dimension."""
    jm = None if mask is None else jnp.asarray(mask.numpy())
    sweep = jspmv.slimsell_spmv if X.ndim == 1 else jspmv.slimsell_spmm
    if name == "gcn":
        return np.asarray(sweep(
            jsr.REAL, jt, jnp.asarray(X), tile_mask=jm, backend="jnp",
            edge_weight=jref.gcn_edge_weight(jnp.asarray(
                csr.deg.astype(np.float32)))))
    if name == "minplus":
        return np.asarray(sweep(
            jsr.MINPLUS, jt, jnp.asarray(X), weights=jt.wts, tile_mask=jm,
            backend="jnp"))
    return np.asarray(sweep(jsr.get(name), jt, jnp.asarray(X), tile_mask=jm,
                            backend="jnp"))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_piece", PER_PIECE)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_split_then_fold_equals_plain_and_jnp(layouts, graph, layout,
                                              per_piece, masked, op):
    """Exact for every semiring but the GCN weight (SpMM only), which is
    held within rtol = atol = 1e-5. The SpMV's frontier is one column."""
    csr, jt, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, op)
    pieces, _, _ = _work(op, pt, P)
    rng = np.random.default_rng([len(graph), len(layout), P, masked, len(op)])
    mask = torch.from_numpy(_split_mask(pt, pieces, rng)) if masked else None
    for name in SEMIRINGS if op == "spmm" else SEMIRINGS[:-1]:
        X = _operand(name, (pt.n, 5) if op == "spmm" else (pt.n,), rng)
        Xt = torch.from_numpy(X)
        sr = {"minplus": psr.MINPLUS, "gcn": psr.REAL}.get(name) \
            or psr.get(name)
        kw = {"minplus": dict(weights=pt.wts),
              "gcn": dict(deg=pt.deg.float())}.get(name, {})
        got = split_then_fold(sr, pt, Xt, mask, P, op=op, **kw)
        if op == "spmm":
            plain = spmm_plain(sr, pt, Xt, mask, **kw)
        else:
            plain = spmv_plain(sr, pt, Xt, mask, **kw)
        want = _jnp(name, csr, jt, X, mask)
        if name == "gcn":
            assert not torch.isnan(got).any()
            torch.testing.assert_close(got, plain, **TOL)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        else:
            assert torch.equal(got, plain), name
            assert np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("op", OPS)
def test_work_list_kept_per_layout(layouts, op):
    """The wrapper builds a layout's work list once and keeps it on the
    layout; a copy with the same ``tile_ptr`` and ``cl`` shares it, a
    layout with another ``tile_ptr`` gets its own. The SpMM's and the
    SpMV's lists are kept apart: building one leaves the other as it was."""
    import dataclasses
    _, _, pt = layouts[("star", "C8L16")]
    field, on_device, other_on_device = {
        "spmm": ("spmm_work", ops._spmm_work_on_device,
                 ops._spmv_work_on_device),
        "spmv": ("spmv_work", ops._spmv_work_on_device,
                 ops._spmm_work_on_device)}[op]
    other_first = other_on_device(pt)
    first = on_device(pt)
    assert on_device(pt) is first
    assert getattr(pt, field)[2] is first
    assert on_device(dataclasses.replace(pt)) is first
    assert other_on_device(pt) is other_first
    if op == "spmm":
        want = ops.spmm_work(pt.tile_ptr, pt.cl, pt.L, ops.piece_tiles(pt.L))
        assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
        assert first[2] == want[2]
    else:
        want = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L,
                             ops.spmv_piece_tiles(pt.L))
        assert torch.equal(first[0], want[0]) and list(first[1]) == want[1]
        assert torch.equal(first[2], want[2]) and first[3] == want[3]
    other = dataclasses.replace(pt, tile_ptr=pt.tile_ptr.clone())
    again = on_device(other)
    assert again is not first and getattr(other, field)[2] is again
    assert getattr(pt, field)[2] is first
    fold = {"spmm": 1, "spmv": 2}[op]
    assert torch.equal(again[0], first[0])
    assert torch.equal(again[fold], first[fold]) and again[-1] == first[-1]
    if op == "spmv":
        assert list(again[1]) == list(first[1])


def packed_items_then_fold(pt, X_words, mask, per_piece):
    """numpy emulation of the packed SpMM kernel over ``ops.spmv_work``'s
    items at ``per_piece`` tiles, in the list's (width-class) order: each
    item ORs the X words of the slots of its kept tiles below its rows'
    slot count, a chunk of one piece writes Y, a split chunk's pieces
    write scratch that the fold ORs in piece order. Y starts poisoned and
    every vertex's row must be written exactly once. X_words int32
    [n, Wb] -> Y int32 [n, Wb]."""
    items, _, folds, slots = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L,
                                           per_piece)
    cols, rv = pt.cols.numpy(), pt.row_vertex.numpy()
    X = X_words.view(np.uint32)
    n, Wb = X.shape
    poison = np.uint32(0xA5A5A5A5)
    Y = np.full((n, Wb), poison, np.uint32)
    partial = np.full((slots, pt.C, Wb), poison, np.uint32)
    writes = np.zeros(n, int)

    def write(chunk, val):
        for r, v in enumerate(rv[chunk]):
            if v >= 0:
                Y[v] = val[r]
                writes[v] += 1
    for chunk, t, row_slots, slot in items.tolist():
        val = np.zeros((pt.C, Wb), np.uint32)
        for done in range(0, row_slots, pt.L):
            if mask is None or mask[t]:
                c = cols[t, :, :min(pt.L, row_slots - done)]
                g = np.where((c >= 0)[..., None], X[np.where(c < 0, 0, c)], 0)
                val |= np.bitwise_or.reduce(g.astype(np.uint32), axis=1)
            t += 1
        if slot >= 0:
            partial[slot] = val
        else:
            write(chunk, val)
    for chunk, s0, k, _ in folds.tolist():
        write(chunk, np.bitwise_or.reduce(partial[s0:s0 + k], axis=0))
    assert (writes == 1).all()
    return Y.view(np.int32)


def _keep_low_bits(words, width):
    """Words [n, Wb] cut to the first ``width`` bits of each row."""
    out = words[:, :-(-width // 32)].copy()
    if width % 32:
        out[:, -1] &= np.uint32((1 << (width % 32)) - 1)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_packed_items_then_fold_equals_plain_and_jnp(layouts, graph, layout):
    """The packed SpMM kernel's items and OR fold, emulated at both piece
    sizes, with every tile kept and with a mask that drops part of each
    split chunk, at B = 1, 33, 64 and 97: exactly ``spmm_packed_plain``
    and ``repro``'s jnp packed SpMM, the padding bits above B zero. The
    frontiers of the narrower batches are the first B roots of the 97,
    and the jnp sweep runs once at B = 97 for each mask: its words cut to
    the first B bits are its result at B, each bit column being swept on
    its own (and each new shape costs the jnp sweep seconds of tracing)."""
    _, jt, pt = layouts[(graph, layout)]
    rng = np.random.default_rng([len(graph), len(layout), 5])
    for per_piece in PER_PIECE:
        P = _per_piece(per_piece, pt, "spmv")
        pieces, _, _ = _work("spmv", pt, P)
        for masked in (False, True):
            mask = _split_mask(pt, pieces, rng) if masked else None
            tm = None if mask is None else torch.from_numpy(mask)
            X97 = jpk.pack_bits_np(rng.random((pt.n, 97)) < 0.1, axis=1)
            want97 = np.asarray(jspmv.slimsell_spmm(
                jsr.BOOLEAN_PACKED, jt, jnp.asarray(X97), backend="jnp",
                tile_mask=jnp.asarray(np.ones(pt.n_tiles, bool)
                                      if mask is None else mask)))
            for width in (1, 33, 64, 97):
                X = _keep_low_bits(X97, width).view(np.int32)
                got = packed_items_then_fold(pt, X, mask, P)
                plain = spmm_packed_plain(pt, torch.from_numpy(X), tm)
                what = (width, per_piece, masked)
                assert np.array_equal(got, plain.numpy()), what
                assert np.array_equal(got.view(np.uint32),
                                      _keep_low_bits(want97, width)), what
                assert jpk.check_tail_zero_host(got.view(np.uint32), width)


def packed_spmv_items(pt, x_words, mask, per_piece, rng):
    """numpy emulation of the packed SpMV kernel over ``ops.spmv_work``'s
    items at ``per_piece`` tiles, in a shuffled item order (the blocks run
    in none): each item's rows OR bit (col & 31) of x[col >> 5] over the
    slots of its kept tiles below its rows' slot count, and a row that hit
    ORs bit (v & 31) into word v >> 5 of the zeroed y. No fold and no
    scratch. x_words int32 [ceil(n/32)] -> y of the same shape."""
    items, _, _, _ = ops.spmv_work(pt.tile_ptr, pt.cl, pt.L, per_piece)
    cols, rv = pt.cols.numpy(), pt.row_vertex.numpy()
    x = x_words.view(np.uint32)
    y = np.zeros_like(x)
    for chunk, t, row_slots, _ in items[rng.permutation(len(items))].tolist():
        hit = np.zeros(pt.C, bool)
        for done in range(0, row_slots, pt.L):
            if mask is None or mask[t]:
                c = cols[t, :, :min(pt.L, row_slots - done)]
                safe = np.where(c < 0, 0, c)
                bit = (x[safe >> 5] >> (safe & 31).astype(np.uint32)) & 1
                hit |= ((c >= 0) & (bit == 1)).any(axis=1)
            t += 1
        for v in rv[chunk][hit & (rv[chunk] >= 0)]:
            y[v >> 5] |= np.uint32(1) << np.uint32(v & 31)
    return y.view(np.int32)


@pytest.mark.parametrize("per_piece", PER_PIECE)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_packed_spmv_items_equal_plain_and_jnp(layouts, graph, layout,
                                               per_piece):
    """The packed SpMV kernel's items ORed into y in a shuffled order,
    emulated with every tile kept and with a mask that drops part of each
    split chunk, at two frontier densities: exactly ``spmv_packed_plain``
    and ``repro``'s jnp ``slimsell_spmv_packed``, the tail bits zero."""
    _, jt, pt = layouts[(graph, layout)]
    P = _per_piece(per_piece, pt, "spmv")
    pieces, _, _ = _work("spmv", pt, P)
    rng = np.random.default_rng([len(graph), len(layout), P, 7])
    for masked in (False, True):
        mask = _split_mask(pt, pieces, rng) if masked else None
        tm = None if mask is None else torch.from_numpy(mask)
        for density in (0.05, 0.5):
            xw = jpk.pack_bits_np(rng.random(pt.n) < density)
            got = packed_spmv_items(pt, xw.view(np.int32), mask, P, rng)
            plain = spmv_packed_plain(pt, torch.from_numpy(xw.view(np.int32)),
                                      tm)
            want = np.asarray(jspmv.slimsell_spmv_packed(
                jt, jnp.asarray(xw), backend="jnp",
                tile_mask=jnp.asarray(np.ones(pt.n_tiles, bool)
                                      if mask is None else mask)))
            what = (masked, density)
            assert np.array_equal(got, plain.numpy()), what
            assert np.array_equal(got.view(np.uint32), want), what
            assert jpk.check_tail_zero_host(got.view(np.uint32), pt.n)
