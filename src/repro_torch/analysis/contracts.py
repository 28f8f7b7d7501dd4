"""Kernel contract checker: prove the kernels' work lists safe.

For every registered kernel case (``repro_torch.analysis.registry``) the
checker reads the work list the wrapper's own builder made and proves the
three properties the kernels never check at run time, the port's
counterparts of the JAX package's index-map bounds, lockstep and chunk
contiguity:

1. **Bounds**: every chunk id, tile id, partial slot and fold range of
   ``pieces``, ``items`` and ``folds`` lies inside its operand; every tile
   a piece reads lies in its chunk's ``[tile_ptr[c], tile_ptr[c + 1])``;
   kernel 7's table pointers address each table's rows (a kernel reads
   what it is pointed at: a wrong pointer or length reads another
   tensor's memory without a word).
2. **Coverage**: each chunk's pieces cover its tiles below ``cl`` exactly
   once, in order, each of at most ``per_piece`` tiles, or form one empty
   piece (padding tiles past ``cl``, as a shard's, are not read);
   ``spmv_work``'s items are such pieces, each with its row slots below
   ``cl``, reordered stably by ``spmv_lanes`` with their class counts;
   ``wts``, where present, has ``cols``' shape.
3. **Race-freedom**: no two live rows share a vertex in ``row_vertex``
   (and where ``owns_all_rows`` holds every vertex has a row, because
   ``ops._out`` then leaves y uninitialised); each partial slot is
   written by one piece only; each split chunk has one fold, whose slots
   are its pieces' slots in piece order (the pulls' first-hit fold reads
   them in that order); a chunk of one piece has slot -1 and no fold.

The checks are vectorised (numpy over whole arrays), so a scale-20 work
list (~131k chunks) is checked in about a second; ``check_layout_work``
checks the lists a device layout keeps (``tiled.spmm_work`` /
``tiled.spmv_work``), copied back.

CLI::

    python -m repro_torch.analysis.contracts      # every registered case

Exit status 0 iff every case of every registered kernel passes.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .registry import REGISTRY, KernelCase


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _first(mask: np.ndarray) -> int:
    return int(np.flatnonzero(mask)[0])


def _layout_errors(name: str, lay) -> List[str]:
    """Race-freedom of the rows, and ``wts`` beside ``cols``."""
    errs = []
    rv = _np(lay.row_vertex).reshape(-1).astype(np.int64)
    live = rv[rv >= 0]
    if live.size and live.max() >= lay.n:
        errs.append(f"{name}: row_vertex holds vertex {int(live.max())} "
                    f">= n={lay.n}: a block would write past y")
        return errs
    count = np.bincount(live, minlength=lay.n)
    if (count > 1).any():
        v = _first(count > 1)
        errs.append(f"{name}: vertex {v} has {int(count[v])} live rows in "
                    "row_vertex: their blocks would race on y[v]")
    if lay.owns_all_rows and (count == 0).any():
        v = _first(count == 0)
        errs.append(f"{name}: vertex {v} has no row although the layout "
                    "owns all rows: ops._out leaves y[v] uninitialised")
    wts = getattr(lay, "wts", None)
    if wts is not None and tuple(wts.shape) != tuple(lay.cols.shape):
        errs.append(f"{name}: wts shape {tuple(wts.shape)} is not cols' "
                    f"{tuple(lay.cols.shape)}: weights would pair with the "
                    "wrong slots")
    return errs


def _pieces_errors(name: str, lay, chunk, first, end, slot, folds,
                   slots: int, per_piece: int,
                   what: str = "piece") -> List[str]:
    """Bounds, coverage and race-freedom of a piece list in piece order:
    int64 arrays ``chunk``, ``first``, ``end`` (tiles [first, end)),
    ``slot``; ``folds`` int [F, 4] (chunk, first slot, slots, 0)."""
    errs: List[str] = []
    tp = _np(lay.tile_ptr).astype(np.int64)
    L = int(lay.L)
    live = -(-_np(lay.cl).astype(np.int64) // L)      # tiles below cl
    n_chunks, T = tp.size - 1, int(lay.cols.shape[0])
    P = chunk.size
    folds = _np(folds).astype(np.int64).reshape(-1, 4)

    # ---- bounds
    bad = (chunk < 0) | (chunk >= n_chunks)
    if bad.any():
        i = _first(bad)
        return [f"{name}: {what} {i}: chunk id {int(chunk[i])} outside "
                f"[0, {n_chunks})"]
    bad = (first < 0) | (end > T) | (first > end)
    if bad.any():
        i = _first(bad)
        errs.append(f"{name}: {what} {i}: tiles [{int(first[i])}, "
                    f"{int(end[i])}) outside [0, {T}): tile id out of range")
    lo, hi = tp[chunk], tp[chunk + 1]
    bad = (first < lo) | (end > hi)
    if bad.any():
        i = _first(bad)
        errs.append(f"{name}: {what} {i} of chunk {int(chunk[i])}: tiles "
                    f"[{int(first[i])}, {int(end[i])}) outside the chunk's "
                    f"[{int(lo[i])}, {int(hi[i])})")
    bad = (slot < -1) | (slot >= slots)
    if bad.any():
        i = _first(bad)
        errs.append(f"{name}: {what} {i}: partial slot {int(slot[i])} "
                    f"outside [-1, {slots})")
    if folds.size:
        fbad = (folds[:, 0] < 0) | (folds[:, 0] >= n_chunks) \
            | (folds[:, 1] < 0) | (folds[:, 2] < 1) \
            | (folds[:, 1] + folds[:, 2] > slots)
        if fbad.any():
            f = folds[_first(fbad)]
            errs.append(f"{name}: fold {f.tolist()} outside chunks [0, "
                        f"{n_chunks}) or slots [0, {slots})")
            return errs
    if errs:
        return errs

    # ---- coverage: pieces in chunk order, each chunk's pieces back to back
    if P and (np.diff(chunk) < 0).any():
        i = _first(np.diff(chunk) < 0) + 1
        return errs + [f"{name}: {what} {i} (chunk {int(chunk[i])}) after a "
                       "piece of a later chunk: pieces are not in chunk order"]
    n_pieces = np.bincount(chunk, minlength=n_chunks)
    if (n_pieces == 0).any():
        c = _first(n_pieces == 0)
        errs.append(f"{name}: chunk {c} has no piece: its rows would never "
                    "be written")
        return errs
    head = np.r_[True, chunk[1:] != chunk[:-1]]
    tail = np.r_[chunk[1:] != chunk[:-1], True]
    size = end - first
    if (head & (first != tp[chunk])).any():
        i = _first(head & (first != tp[chunk]))
        errs.append(f"{name}: chunk {int(chunk[i])}'s first {what} starts at "
                    f"tile {int(first[i])}, not its first tile "
                    f"{int(tp[chunk[i]])}: tiles dropped")
    gap = ~tail[:-1] & (first[1:] != end[:-1])
    if gap.any():
        i = _first(gap)
        kind = "overlapping" if first[i + 1] < end[i] else "a gap between"
        errs.append(f"{name}: chunk {int(chunk[i])}: {kind} {what}s {i} and "
                    f"{i + 1} (tiles [{int(first[i])}, {int(end[i])}) then "
                    f"[{int(first[i + 1])}, {int(end[i + 1])})): a tile below "
                    "cl not covered exactly once")
    want_end = tp[chunk] + live[chunk]
    if (tail & (end != want_end)).any():
        i = _first(tail & (end != want_end))
        errs.append(f"{name}: chunk {int(chunk[i])}'s pieces end at tile "
                    f"{int(end[i])}, its tiles below cl at {int(want_end[i])}"
                    ": a tile dropped or one past cl read")
    empty_chunk = live[chunk] == 0
    bad = ~empty_chunk & ((size < 1) | (size > per_piece))
    if bad.any():
        i = _first(bad)
        errs.append(f"{name}: {what} {i} holds {int(size[i])} tiles, not "
                    f"1 to per_piece={per_piece}")
    bad = empty_chunk & ((size != 0) | (n_pieces[chunk] != 1))
    if bad.any():
        i = _first(bad)
        errs.append(f"{name}: chunk {int(chunk[i])} has no tile below cl "
                    "and must be one empty piece")

    # ---- race-freedom: partial slots and folds
    split = n_pieces[chunk] > 1
    if (~split & (slot != -1)).any():
        i = _first(~split & (slot != -1))
        errs.append(f"{name}: chunk {int(chunk[i])} of one piece has partial "
                    f"slot {int(slot[i])}: it must write y itself (slot -1)")
    if (split & (slot < 0)).any():
        i = _first(split & (slot < 0))
        errs.append(f"{name}: {what} {i} of split chunk {int(chunk[i])} has "
                    "no partial slot")
    used = slot[slot >= 0]
    if used.size:
        writers = np.bincount(used, minlength=slots)
        if (writers > 1).any():
            s = _first(writers > 1)
            errs.append(f"{name}: partial slot {s} is written by "
                        f"{int(writers[s])} pieces: they race")
    fold_of = np.bincount(folds[:, 0], minlength=n_chunks) if folds.size \
        else np.zeros(n_chunks, np.int64)
    want = (n_pieces > 1).astype(np.int64)
    if (fold_of != want).any():
        c = _first(fold_of != want)
        errs.append(f"{name}: chunk {c} of {int(n_pieces[c])} pieces has "
                    f"{int(fold_of[c])} folds (one for a split chunk, none "
                    "for a whole one)")
        return errs
    if folds.size:
        # each fold's slots are its chunk's pieces' slots in piece order
        order = np.argsort(folds[:, 0], kind="stable")
        f = folds[order]
        if (f[:, 2] != n_pieces[f[:, 0]]).any():
            k = _first(f[:, 2] != n_pieces[f[:, 0]])
            errs.append(f"{name}: the fold of chunk {int(f[k, 0])} reads "
                        f"{int(f[k, 2])} slots for {int(n_pieces[f[k, 0]])} "
                        "pieces")
            return errs
        got = slot[split]                      # split pieces in piece order
        ofs = np.repeat(f[:, 1] - np.r_[0, np.cumsum(f[:, 2])[:-1]], f[:, 2])
        want_slot = ofs + np.arange(got.size)
        if f[:, 2].sum() != got.size or (got != want_slot).any():
            i = _first(got != want_slot) if f[:, 2].sum() == got.size else 0
            c = int(chunk[split][i])
            errs.append(f"{name}: the fold of chunk {c} reads slots out of "
                        "its pieces' order: the first-hit fold would take "
                        "the wrong piece")
    return errs


def check_pieces(name: str, lay, work, per_piece: int) -> List[str]:
    """``spmm_work``'s ``(pieces, folds, slots)`` for ``lay``."""
    pieces, folds, slots = work
    p = _np(pieces).astype(np.int64).reshape(-1, 4)
    return _layout_errors(name, lay) + _pieces_errors(
        name, lay, p[:, 0], p[:, 1], p[:, 2], p[:, 3], folds, int(slots),
        per_piece)


def check_items(name: str, lay, work, per_piece: int) -> List[str]:
    """``spmv_work``'s ``(items, class_items, folds, slots)`` for ``lay``:
    the items in piece order are a piece list, each item's row slots
    those of its tiles below ``cl``, and the items sorted stably by their
    lanes a row with the class counts of those lanes."""
    from ..kernels.ops import SPMV_LANES, spmv_lanes
    items, class_items, folds, slots = work
    it = _np(items).astype(np.int64).reshape(-1, 4)
    class_items = [int(v) for v in class_items]
    errs = _layout_errors(name, lay)
    L = int(lay.L)
    lanes = spmv_lanes(torch.from_numpy(it[:, 2])).numpy()
    if (np.diff(lanes) < 0).any():
        errs.append(f"{name}: items not sorted by their lanes a row")
    counts = [int((lanes == w).sum()) for w in SPMV_LANES]
    if class_items != counts or sum(class_items) != it.shape[0]:
        errs.append(f"{name}: class counts {class_items} are not the items' "
                    f"{counts}: the kernel would give rows the wrong lanes")
    # stable: within a class the items keep piece order
    key = it[:, 0] * (int(lay.cols.shape[0]) + 1) + it[:, 1]
    same = lanes[1:] == lanes[:-1]
    if (same & (key[1:] <= key[:-1])).any():
        errs.append(f"{name}: items of one lane class out of piece order "
                    "(the sort by lanes is not stable)")
    if (it[:, 2] < 0).any():
        i = _first(it[:, 2] < 0)
        return errs + [f"{name}: item {i}: negative row slots"]
    order = np.lexsort((it[:, 1], it[:, 0]))
    p = it[order]
    chunk, first, row_slots = p[:, 0], p[:, 1], p[:, 2]
    end = first + -(-row_slots // L)
    errs += _pieces_errors(name, lay, chunk, first, end, p[:, 3], folds,
                           int(slots), per_piece, what="item")
    if errs:
        return errs
    tp = _np(lay.tile_ptr).astype(np.int64)
    cl = _np(lay.cl).astype(np.int64)
    want = np.minimum(cl[chunk] - (first - tp[chunk]) * L, (end - first) * L)
    if (row_slots != np.maximum(want, 0)).any():
        i = _first(row_slots != np.maximum(want, 0))
        errs.append(f"{name}: item of chunk {int(chunk[i])} at tile "
                    f"{int(first[i])} has {int(row_slots[i])} row slots, its "
                    f"tiles below cl hold {int(want[i])}")
    return errs


def check_tables(name: str, tables, work) -> List[str]:
    """Kernel 7's launch parameters: each table's pointer and row count
    address that table's rows, inside its storage."""
    ptrs, rows = (list(v) for v in work)
    errs = []
    if not (len(ptrs) == len(rows) == len(tables)):
        return [f"{name}: {len(ptrs)} pointers and {len(rows)} row counts "
                f"for {len(tables)} tables"]
    for t, (tab, p, r) in enumerate(zip(tables, ptrs, rows)):
        store = tab.untyped_storage()
        lo, hi = store.data_ptr(), store.data_ptr() + store.nbytes()
        nbytes = int(r) * tab.shape[1] * tab.element_size()
        if p != tab.data_ptr() or r != tab.shape[0]:
            errs.append(f"{name}: table {t}: pointer / rows ({p:#x}, {r}) "
                        f"are not the table's ({tab.data_ptr():#x}, "
                        f"{tab.shape[0]})")
        elif not (lo <= p and p + nbytes <= hi):
            errs.append(f"{name}: table {t}: rows [{p:#x}, {p + nbytes:#x}) "
                        f"pass its storage [{lo:#x}, {hi:#x})")
    return errs


def check_case(case: KernelCase) -> List[str]:
    """Every contract property of one case; returns the violations (empty:
    the case passes)."""
    if case.kind == "spmm":
        return check_pieces(case.name, case.layout, case.work, case.per_piece)
    if case.kind == "spmv":
        return check_items(case.name, case.layout, case.work, case.per_piece)
    if case.kind == "tables":
        return check_tables(case.name, case.tables, case.work)
    return [f"{case.name}: unknown case kind {case.kind!r}"]


def check_layout_work(name: str, tiled) -> List[str]:
    """The work lists a layout keeps for its kernels (``tiled.spmm_work``,
    ``tiled.spmv_work``, each with the ``tile_ptr`` and ``cl`` it was built
    from), copied back, against the layout; at least one must be kept."""
    from ..kernels.ops import piece_tiles, spmv_piece_tiles
    errs, seen = [], 0
    for field, check, per in (("spmm_work", check_pieces, piece_tiles),
                              ("spmv_work", check_items, spmv_piece_tiles)):
        memo = getattr(tiled, field, None)
        if memo is None:
            continue
        seen += 1
        if memo[0] is not tiled.tile_ptr or memo[1] is not tiled.cl:
            errs.append(f"{name} {field}: built from another tile_ptr / cl")
        errs += check(f"{name} {field}", tiled, memo[2], per(tiled.L))
    if not seen:
        errs.append(f"{name}: no work list kept (no kernel launched on it)")
    return errs


def check_all(verbose: bool = False) -> List[str]:
    """Check every case of every registered kernel; returns violations."""
    # importing the kernel wrappers populates the registry
    import repro_torch.kernels.ops  # noqa: F401
    errors: List[str] = []
    for name in sorted(REGISTRY):
        for case in REGISTRY[name].cases():
            errs = check_case(case)
            errors.extend(f"{name}: {e}" for e in errs)
            if verbose:
                print(f"  [{'FAIL' if errs else 'ok'}] {name}: {case.name}")
    return errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    errors = check_all(verbose=not args.quiet)
    if errors:
        print(f"\n{len(errors)} contract violation(s):")
        for e in errors:
            print(f"  {e}")
        return 1
    n = sum(len(REGISTRY[k].cases()) for k in REGISTRY)
    print(f"kernel contracts OK: {len(REGISTRY)} kernels, {n} cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
