"""Sanitizer mode: run any engine strategy with runtime invariant checks.

The kernels' correctness rests on data invariants the type system cannot
see. Every live column index must stay inside the sweep's operand (a
kernel reads ``x[col]`` without a bound, so a corrupt layout reads past
``x``), the work lists cut each chunk by ``tile_ptr`` and ``cl`` and write
through ``row_vertex``, and a sweep under a semiring whose zero is finite
must never produce NaN or inf (under tropical, +inf is the additive
identity and legitimate; under real or sel-max it means overflow or a
poisoned operand). ``checked()`` turns those conditions into hard errors:

    from repro_torch.core import debug
    with debug.checked():
        res = bfs(tiled, 0, config=EngineConfig(mode="fused"))

PyTorch runs eagerly, so there is no checked twin of a traced function to
build and cache, as the JAX package's checkify sanitizer has. A check is a
few reductions on the tensors' device whose result the host reads once,
and then raises ``SanitizerError`` with the JAX package's message. With
the sanitizer off a check returns at once: nothing is computed and
nothing is read.

Covered strategies:

* fused: the layout is checked once before the first sweep, and each
  sweep's check is a flag on the device that the loop ORs into its own
  sticky flag and reads together with the continue flag it already reads
  each iteration (a loop whose update made that read itself reads the
  flag once, after its last sweep); ``FixpointHandle.run`` the same;
* hostloop: the layout once, then each sweep checked as it ends;
* distributed: each ``make_dist_*`` runner checks ``enabled()`` when it
  is called, checks its shard once (columns against the shard's ``n_x``,
  rows against n) and each sweep as it ends; ``distributed.launch``
  hands its ranks the caller's state, so ``with checked(): launch(...)``
  sanitizes every rank.

The state is per thread: ``checked()`` in one thread does not reach a
thread it starts (``EngineConfig(sanitize=True)`` is entered by the thread
that runs the engine call). ``REPRO_SANITIZE=1`` in the environment, read
at import, turns it on for every thread that has not set its own.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import torch

SANITIZE_ENV = "REPRO_SANITIZE"

_STATE = threading.local()
# the process default, for threads that set nothing (REPRO_SANITIZE)
_DEFAULT = os.environ.get(SANITIZE_ENV, "").strip().lower() in ("1", "true",
                                                                 "yes")


class SanitizerError(AssertionError):
    """A sanitizer check failed: a corrupt layout or a poisoned sweep."""


def enabled() -> bool:
    """True when the current thread is inside ``checked()`` or ``enable()``
    (or set nothing, and the process was started with ``REPRO_SANITIZE=1``)."""
    on = getattr(_STATE, "on", None)
    return _DEFAULT if on is None else on


@contextlib.contextmanager
def _set(on: bool):
    prev = getattr(_STATE, "on", None)
    _STATE.on = on
    try:
        yield
    finally:
        _STATE.on = prev


def checked():
    """Context manager: run the enclosed engine calls sanitized."""
    return _set(True)


def suspended():
    """Context manager: run the enclosed calls with the sanitizer OFF,
    restoring the previous state on exit: the inverse of ``checked()``,
    for skipping a known-noisy region of a ``REPRO_SANITIZE=1`` run."""
    return _set(False)


def enable() -> None:
    """Turn the sanitizer on for the current thread until ``disable()``."""
    _STATE.on = True


def disable() -> None:
    _STATE.on = False


# ---------------------------------------------------------------- layouts


def _layout_stats(cols, row_vertex, tile_ptr, cl, wts, L: int):
    """The reductions the layout checks read, as one int64 vector:
    cols min / max, row_vertex min / max, bad weight slots, tile_ptr's
    first / last entries and its decreasing steps, chunks longer than
    their tiles, negative lengths. Works on numpy arrays and tensors."""
    t = torch.as_tensor
    cols, row_vertex, tile_ptr, cl = (t(a) for a in (cols, row_vertex,
                                                     tile_ptr, cl))
    dev = cols.device
    lo, hi = torch.aminmax(cols) if cols.numel() else (
        torch.tensor(-1, device=dev), torch.tensor(-1, device=dev))
    rv_lo, rv_hi = torch.aminmax(row_vertex) if row_vertex.numel() else (
        torch.tensor(-1, device=dev), torch.tensor(-1, device=dev))
    if wts is None:
        bad_w = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        w = t(wts)
        bad_w = ((cols >= 0) & (~torch.isfinite(w) | (w < 0))).sum()
    tp = tile_ptr.long()
    steps = tp[1:] - tp[:-1]
    # a tile_ptr of the wrong length fails its own check first
    cl_long = (cl.long() > steps * L).sum() if steps.shape == cl.shape \
        else torch.zeros((), dtype=torch.int64, device=dev)
    return torch.stack([
        lo.long(), hi.long(), rv_lo.long(), rv_hi.long(), bad_w.long(),
        tp[0], tp[-1], (steps < 0).sum(), cl_long,
        (cl < 0).sum()]).tolist()


def _raise_layout(stats, *, n: int, n_x: int, n_tiles: int, n_chunks: int,
                  tile_ptr_len: int) -> None:
    (lo, hi, rv_lo, rv_hi, bad_w, tp0, tp_last, tp_down, cl_long,
     cl_neg) = stats
    if lo < -1:
        raise SanitizerError("SlimSell cols contains ids < -1")
    if hi >= n_x:
        raise SanitizerError(
            f"SlimSell cols contains out-of-bounds vertex ids "
            f"(max {hi} >= n={n_x})")
    if bad_w:
        raise SanitizerError(
            "SlimSell-W wts has NaN/inf/negative weights on "
            f"{bad_w} non-padding slots")
    if rv_lo < -1 or rv_hi >= n:
        raise SanitizerError(
            f"SlimSell row_vertex contains ids outside [-1, {n}) "
            f"(min {rv_lo}, max {rv_hi}): the sweep would write past y")
    if tile_ptr_len != n_chunks + 1 or tp0 != 0 or tp_last != n_tiles \
            or tp_down:
        raise SanitizerError(
            f"SlimSell tile_ptr is not non-decreasing from 0 to "
            f"n_tiles={n_tiles} over {n_chunks} chunks (first {tp0}, last "
            f"{tp_last}, {tp_down} decreasing steps, {tile_ptr_len} entries)")
    if cl_long or cl_neg:
        raise SanitizerError(
            f"SlimSell cl has {cl_long} chunks longer than their tiles "
            f"hold (tiles * L) and {cl_neg} negative lengths")


def check_layout(tiled) -> None:
    """Structural layout invariants, checked once per run on the layout's
    device (one read): every column slot is -1 (padding) or an id below
    the operand's rows (``n_x``: n, or a shard's column range), stored
    weights are finite and non-negative on live slots, every
    ``row_vertex`` is -1 or a vertex id below n, ``tile_ptr`` runs
    non-decreasing from 0 to the tile count, and no chunk's length ``cl``
    passes its tiles (tiles * L). A no-op when the sanitizer is off."""
    if not enabled():
        return
    stats = _layout_stats(tiled.cols, tiled.row_vertex, tiled.tile_ptr,
                          tiled.cl, getattr(tiled, "wts", None), tiled.L)
    _raise_layout(stats, n=tiled.n, n_x=tiled.n_x,
                  n_tiles=int(tiled.cols.shape[0]),
                  n_chunks=int(tiled.row_vertex.shape[0]),
                  tile_ptr_len=int(tiled.tile_ptr.shape[0]))


def validate_layout_host(tiled) -> None:
    """Eager host twin of ``check_layout``, whatever the sanitizer's state:
    the same checks on the layout's arrays brought to the host (a host
    layout's numpy arrays, or a device layout's tensors copied back)."""
    def host(a):
        return None if a is None else torch.as_tensor(a).cpu()
    cols, rv, tp, cl = (host(getattr(tiled, f)) for f in
                        ("cols", "row_vertex", "tile_ptr", "cl"))
    stats = _layout_stats(cols, rv, tp, cl, host(getattr(tiled, "wts", None)),
                          tiled.L)
    _raise_layout(stats, n=tiled.n, n_x=tiled.n_x, n_tiles=int(cols.shape[0]),
                  n_chunks=int(rv.shape[0]), tile_ptr_len=int(tp.shape[0]))


# ----------------------------------------------------------------- sweeps

# the bits of a sweep flag
NAN, POISON, TAIL = 1, 2, 4


def sweep_flag(sr, y: torch.Tensor,
               n_bits: Optional[int] = None) -> Optional[torch.Tensor]:
    """The post-sweep checks as an int32 flag on ``y``'s device, without a
    read (0: clean; ``NAN`` / ``POISON`` / ``TAIL`` bits), or None when the
    sanitizer is off or nothing applies to ``y``'s type.

    Per semiring: a float sweep must never produce NaN; a semiring whose
    zero is finite must not overflow to the *poison* infinity. The
    reduction kind's own fill identity is allowed: a max-kind sweep only
    flags +inf, a min-kind only -inf, and a sum-kind both. Under tropical
    or min-plus (infinite zero) inf is the additive identity and no
    finiteness check applies.

    A packed (SlimSell-B) sweep passes ``n_bits``, the live-bit count of
    its word axis (the LAST axis: n for a bitmap, B for a batch's word
    planes), and gets the tail-word invariant instead: every padding bit
    above ``n_bits`` must be zero. A set padding bit would survive every
    OR downstream and resurface as a phantom vertex or root on unpack."""
    if not enabled():
        return None
    if n_bits is not None and sr.reduction == "or":
        from . import packing
        # only the last word has padding bits; its mask is a Python int, so
        # nothing is copied to the device
        tail = ~packing.tail_mask(int(n_bits))
        return ((y[..., -1] & tail) != 0).any().to(torch.int32) * TAIL
    if not y.is_floating_point():
        return None
    flag = torch.isnan(y).any().to(torch.int32) * NAN
    if np.isfinite(sr.zero):
        if sr.reduction == "max":
            bad = torch.isposinf(y)
        elif sr.reduction == "min":
            bad = torch.isneginf(y)
        else:
            bad = torch.isinf(y)
        flag = flag | bad.any().to(torch.int32) * POISON
    return flag


def raise_sweep(sr, flag: int, n_bits: Optional[int] = None) -> None:
    """Raise ``SanitizerError`` for a sweep flag read on the host."""
    flag = int(flag)
    if flag & TAIL:
        raise SanitizerError(
            f"packed {sr.name} sweep has nonzero tail padding bits (live "
            f"bits: {n_bits}) — the tail-word invariant is broken")
    if flag & NAN:
        raise SanitizerError(f"NaN in {sr.name}-semiring sweep output")
    if flag & POISON:
        raise SanitizerError(
            f"poison infinity in {sr.name}-semiring sweep (zero is finite, "
            f"reduction is {sr.reduction}: this means overflow or a "
            "corrupted operand)")


def check_sweep(sr, y: torch.Tensor, n_bits: Optional[int] = None) -> None:
    """Post-sweep value sanity (``sweep_flag``), read and raised at once;
    a no-op when the sanitizer is off."""
    flag = sweep_flag(sr, y, n_bits)
    if flag is not None:
        raise_sweep(sr, flag.item(), n_bits)


def check_gather(idx: torch.Tensor, n: int) -> None:
    """Gather-operand bound check: every index in [0, n) (an index past
    it reads another tensor's memory on the card, or raises on the host
    only when it is read). A no-op when the sanitizer is off."""
    if enabled() and idx.numel() and bool(((idx < 0) | (idx >= n)).any()):
        raise SanitizerError(f"gather index out of bounds [0, {n})")
