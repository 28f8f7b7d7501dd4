"""The 2D-distributed strategy on ``torch.distributed`` (Buluc-Madduri layout).

The port of ``repro/core/dist_bfs.py``. The adjacency is partitioned 2D:
chunk rows over the grid's row axes (``pod`` x ``data``) and vertex
columns over its column axis (``model``). Each rank owns the SlimSell
tiles of its (row range, column range) block, with column ids *localized*
to its column range.

``partition_slimsell`` builds the partition on the host, array for array
the JAX package's ``DistSlimSell`` (per-slot ``wts`` when the CSR is
weighted, the replicated ``deg``, the per-shard push index padded with
tile id ``t_max``), from the CSR in a few vectorised passes over the
edges (no loop over chunks). ``shard`` cuts one rank's block out of it as
an ``engine.ShardTiled`` with what the port's kernels read besides: the
shard's own ``tile_ptr`` and ``cl``. ``save_partition`` / ``load_shard``
pass the blocks to the ranks through files, so no rank receives the whole
partition.

Any ``FixpointSpec`` runs over the partition (``make_dist_fixpoint``):
each rank sweeps its block with the ordinary sweeps (a kernel on the
card, the plain version on the CPU), the ranks' partial results are
combined by a semiring all-reduce over the grid, and every rank applies
the spec's own update to the replicated state (``engine.dist_step``).
``direction="pull"`` sweeps the shard's not-final rows; ``"auto"`` runs
the replicated Beamer heuristic on the whole graph's degrees and picks
one direction an iteration (a batch included). The factories are spec
selection plus the JAX package's output tuples: ``make_dist_bfs``,
``make_dist_multi_bfs`` (lane, and ``packed=True``), ``make_dist_sssp``,
``make_dist_multi_sssp``, ``make_dist_cc``, ``make_dist_pagerank``,
``make_dist_brandes``, ``make_dist_khop``. Each returns ``fn(local,
*args)``, ``local`` the rank's shard (moved to the factory's device if it
is a host shard); every rank calls it, and every rank gets the replicated
result.

``make_dist_bfs_sliced`` is the separately tuned slot-space BFS: state
sharded by row range, a MIN reduce of the own row slice over the column
(and pod) axes, and the (data, model) grid transpose as a paired send /
receive; a plain torch loop, as in the JAX package.

``run_cases`` is a rank function for ``distributed.launch``: it runs a
list of factory calls over saved partitions and returns their outputs
with the launches and collective time each took.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import debug
from . import engine as eng
from .betweenness import BRANDES_FORWARD_SPEC, brandes_backward_spec
from .bfs import bfs_spec, on_device
from .cc import CC_SPEC
from .engine import ShardTiled
from .formats import CSRGraph, chunk_tile_ptr, resolve_device, \
    sellcs_order
from .multi_bfs import multi_bfs_spec, packed_multi_bfs_spec
from .multi_sssp import multi_sssp_spec
from .options import COMMS, DIRECTIONS, check_choice
from .pagerank import PAGERANK_MAX_ITERS, pagerank_spec, pagerank_views
from .sssp import sssp_spec


@dataclasses.dataclass
class DistSlimSell:
    """2D-partitioned SlimSell; the leading [R, Co] axes are the grid.

    ``wts`` (the weight slots, aligned with ``cols``) is present only for a
    weighted CSR. ``inc_src`` / ``inc_tile`` are the per-shard push index:
    the deduplicated (localized column, tile) pairs of each block, padded
    to the widest block's count with (0, ``t_max``).
    """
    n: int
    C: int
    L: int
    R: int                  # row shards (pod * data)
    Co: int                 # column shards (model)
    n_col: int              # vertices per column range (padded)
    chunks_per_shard: int
    t_max: int
    cols: np.ndarray        # int32[R, Co, T, C, L] localized (-1 pad)
    row_block: np.ndarray   # int32[R, Co, T] chunk index within the shard
    row_vertex: np.ndarray  # int32[R, chunks_per_shard, C] global vertex ids
    wts: Optional[np.ndarray] = None       # float32[R, Co, T, C, L]
    deg: Optional[np.ndarray] = None       # int64[n]
    inc_src: Optional[np.ndarray] = None   # int32[R, Co, K]
    inc_tile: Optional[np.ndarray] = None  # int32[R, Co, K]
    # not in the JAX package's record: each chunk's length in each column
    # range (the kernels' cl), int32[R, Co, chunks_per_shard]
    chunk_len: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)


def _exclusive_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(a, dim=dim) - a


def partition_slimsell(csr: CSRGraph, R: int, Co: int, *, C: int = 8,
                       L: int = 128, sigma: Optional[int] = None,
                       slot_space: bool = False, device=None) -> DistSlimSell:
    """2D partition of the SlimSell layout; the arrays come back on the
    host (numpy), worked out on ``device`` (None: the card, raising when
    there is none; "cpu" on the host).

    Rows are the Sell-C-sigma order cut into chunks of C; chunk c goes to
    row shard ``c // chunks_per_shard``. A row's neighbours keep their CSR
    order; those in column range j (``[j * n_col, (j + 1) * n_col)``)
    are localized and packed from the left into the chunk's tiles of block
    (i, j), as many tiles of L as the chunk's longest row there needs (a
    chunk with none there has no tile). Blocks are padded to ``t_max``
    tiles of -1 that keep the last real chunk's id. Each edge's slot comes
    from a few passes over the edge list; the push index is one sorted
    unique of the (block, column, tile) keys of the edges, which orders
    each block's pairs by column, then tile, as the layout builder's.

    slot_space=True renumbers vertices by their sorted-row slot: row shard
    i then owns the contiguous slots ``[i * cps * C, (i + 1) * cps * C)``
    (the sliced BFS's exchange); ``row_vertex`` still maps slots back to
    vertex ids.
    """
    dev = resolve_device(device)
    n, deg = csr.n, csr.deg
    weighted = csr.weights is not None
    sigma = n if sigma is None else max(1, min(int(sigma), n))
    perm = sellcs_order(deg, sigma)
    n_chunks = math.ceil(n / C)
    cps = math.ceil(n_chunks / R)           # chunks per row shard
    n_rows = R * cps * C
    n_pad = n_rows if slot_space else n
    n_col = math.ceil(n_pad / Co)

    rv = np.full(n_rows, -1, np.int32)
    rv[:n] = perm
    row_vertex = rv.reshape(R, cps, C)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the edges row by row: row s holds vertex perm[s]'s neighbours
    counts = on(deg[perm])
    E = int(counts.sum())
    src_row = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    row_first = _exclusive_cumsum(counts)                 # per row
    eidx = on(csr.indptr[perm])[src_row] \
        + (torch.arange(E, device=dev) - row_first[src_row])
    nbr = on(csr.indices)[eidx].long()
    if slot_space:
        inv_perm = torch.empty(n, dtype=torch.long, device=dev)
        inv_perm[on(perm)] = torch.arange(n, device=dev)
        nbr = inv_perm[nbr]
    j_e = nbr // n_col
    loc = (nbr - j_e * n_col).to(torch.int32)

    # each edge's place within its row's part in column range j: the edges
    # of range j before it in the row
    pos = torch.empty(E, dtype=torch.long, device=dev)
    sizes = torch.zeros((n_rows, Co), dtype=torch.long, device=dev)
    for j in range(Co):
        m = j_e == j
        before = torch.cumsum(m, 0) - m.long()            # range-j edges before e
        pos[m] = (before - before[row_first[src_row]])[m]
        sizes[:n, j] = torch.bincount(src_row[m], minlength=n)
    length = sizes.reshape(R, cps, C, Co).amax(dim=2)     # [R, cps, Co]
    n_t = -(-length // L)                                  # tiles a chunk
    base = _exclusive_cumsum(n_t, dim=1)                   # first tile
    n_real = n_t.sum(dim=1)                                # [R, Co]
    t_max = max(1, int(n_real.max()))

    chunk = src_row // C
    i_e, c_e, r_e = chunk // cps, chunk % cps, src_row % C
    tile = base[i_e, c_e, j_e] + pos // L
    flat = (((i_e * Co + j_e) * t_max + tile) * C + r_e) * L + pos % L
    cols = torch.full((R, Co, t_max, C, L), -1, dtype=torch.int32,
                      device=dev)
    cols.view(-1)[flat] = loc
    wts = None
    if weighted:
        wts = torch.zeros((R, Co, t_max, C, L), device=dev)
        wts.view(-1)[flat] = on(csr.weights)[eidx]
    row_block = torch.zeros((R, Co, t_max), dtype=torch.int32, device=dev)
    chunk_ids = torch.arange(cps, dtype=torch.int32, device=dev)
    for i in range(R):
        for j in range(Co):
            rb = torch.repeat_interleave(chunk_ids, n_t[i, :, j])
            row_block[i, j, :rb.numel()] = rb
            # padding tiles keep the last real chunk id, so the ids stay
            # non-decreasing (the chunks' tiles stay contiguous)
            if rb.numel():
                row_block[i, j, rb.numel():] = rb[-1]
    # per-shard push index: the deduplicated (column, tile) pairs of each
    # block by column, then tile, padded to one common K with tile t_max
    blk = i_e * Co + j_e
    key = torch.unique((blk * n_col + loc) * t_max + tile)
    pair_tile = key % t_max
    pair_src = (key // t_max) % n_col
    per = torch.bincount(key // (t_max * n_col), minlength=R * Co)
    K = max(1, int(per.max()))
    slot = torch.arange(key.numel(), device=dev) \
        - (_exclusive_cumsum(per))[key // (t_max * n_col)]
    at = (key // (t_max * n_col)) * K + slot
    inc_src = torch.zeros(R * Co * K, dtype=torch.int32, device=dev)
    inc_tile = torch.full((R * Co * K,), t_max, dtype=torch.int32,
                          device=dev)
    inc_src[at] = pair_src.to(torch.int32)
    inc_tile[at] = pair_tile.to(torch.int32)

    def host(t):
        return t.cpu().numpy()

    return DistSlimSell(
        n=n, C=C, L=L, R=R, Co=Co, n_col=n_col, chunks_per_shard=cps,
        t_max=t_max, cols=host(cols), row_block=host(row_block),
        row_vertex=row_vertex, wts=None if wts is None else host(wts),
        deg=deg, inc_src=host(inc_src).reshape(R, Co, K),
        inc_tile=host(inc_tile).reshape(R, Co, K),
        chunk_len=host(length.transpose(1, 2).to(torch.int32)))


# ----------------------------------------------------------- rank shards


def shard(part: DistSlimSell, i: int, j: int) -> ShardTiled:
    """Block (i, j) of the partition as a host ``ShardTiled``: its tiles,
    its chunks' global rows, its own ``tile_ptr`` (the padding tiles
    counted into the last real chunk) and ``cl`` (each chunk's length in
    column range j, which keeps the kernels off the padding tiles)."""
    cps = part.chunks_per_shard
    return ShardTiled(
        n=part.n, n_x=part.n_col, C=part.C, L=part.L, n_chunks=cps, row=i,
        col=j, cols=part.cols[i, j], row_block=part.row_block[i, j],
        row_vertex=part.row_vertex[i],
        tile_ptr=chunk_tile_ptr(part.row_block[i, j], cps),
        cl=part.chunk_len[i, j], deg=part.deg,
        inc_src=part.inc_src[i, j], inc_tile=part.inc_tile[i, j],
        wts=None if part.wts is None else part.wts[i, j])


_SHARD_ARRAYS = ("cols", "row_block", "row_vertex", "tile_ptr", "cl",
                 "inc_src", "inc_tile", "wts")


def save_partition(part: DistSlimSell, path: str) -> None:
    """Write the partition under ``path``: one ``.npz`` a block and the
    static fields with the degree vector, so that each rank reads only its
    own block (``load_shard``)."""
    os.makedirs(path, exist_ok=True)
    meta = {k: getattr(part, k) for k in ("n", "C", "L", "R", "Co", "n_col",
                                           "chunks_per_shard", "t_max")}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.save(os.path.join(path, "deg.npy"), part.deg)
    for i in range(part.R):
        for j in range(part.Co):
            s = shard(part, i, j)
            np.savez(os.path.join(path, f"shard-{i}-{j}.npz"),
                     **{k: getattr(s, k) for k in _SHARD_ARRAYS
                        if getattr(s, k) is not None})


def load_meta(path: str) -> dict:
    """The static fields ``save_partition`` wrote."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_shard(path: str, i: int, j: int) -> ShardTiled:
    """Block (i, j) of a saved partition, as a host ``ShardTiled``."""
    meta = load_meta(path)
    with np.load(os.path.join(path, f"shard-{i}-{j}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return ShardTiled(n=meta["n"], n_x=meta["n_col"], C=meta["C"],
                      L=meta["L"], n_chunks=meta["chunks_per_shard"], row=i,
                      col=j, deg=np.load(os.path.join(path, "deg.npy")),
                      **arrays)


# --------------------------------------------- generic engine-backed runner


def _get(meta, key: str):
    """A static field of a ``DistSlimSell`` or of ``load_meta``'s dict."""
    return meta[key] if isinstance(meta, dict) else getattr(meta, key)


def _check_axes(grid, meta, row_axes, col_axes) -> None:
    R = math.prod(grid.axis_size(a) for a in row_axes)
    Co = math.prod(grid.axis_size(a) for a in col_axes)
    if (R, Co) != (_get(meta, "R"), _get(meta, "Co")):
        raise ValueError(f"the grid's row and column axes hold {R} x {Co} "
                         f"ranks; the partition is {_get(meta, 'R')} x "
                         f"{_get(meta, 'Co')}")


def make_dist_fixpoint(grid, meta, spec, *,
                       row_axes: Sequence[str] = ("data",),
                       col_axes: Sequence[str] = ("model",),
                       max_iters: int = 64, comm: str = "allreduce",
                       direction: str = "push", slimwork: bool = False,
                       device=None):
    """The distributed strategy: run a spec over the 2D partition.

    ``meta`` is the partition (a ``DistSlimSell``, or the static fields
    ``load_meta`` returns); ``spec`` a ``FixpointSpec`` or a factory
    ``(local, *ctx_args) -> FixpointSpec`` of one that holds per-run
    constants (SSSP's delta, PageRank's damping). Returns ``fn(local, arg,
    ctx_args=()) -> (state, iterations)``, ``local`` this rank's shard:
    the loop iterates while the update says so and ``k <= max_iters``
    from k = 1, as the single-device engine. ``slimwork=True`` masks push
    sweeps to the tiles holding a source column (the shard's push index)
    and pull sweeps to the chunks holding a not-final row. Under the
    sanitizer (``debug.enabled()`` when ``fn`` is called) the shard is
    checked once a call, its columns against ``n_x`` and its rows against
    n, and every sweep as it ends (``engine.dist_step``).
    ``device``: None means the card, and raises at once when there is
    none.
    """
    dev = resolve_device(device)
    check_choice("direction", direction, DIRECTIONS)
    check_choice("comm", comm, COMMS)
    _check_axes(grid, meta, row_axes, col_axes)
    n = _get(meta, "n")

    def fn(local, arg, ctx_args=()):
        local = on_device(local, dev)
        if (local.row, local.col) != (grid.index(row_axes),
                                      grid.index(col_axes)):
            raise ValueError(f"rank {grid.rank} holds block "
                             f"({grid.index(row_axes)}, "
                             f"{grid.index(col_axes)}), given "
                             f"({local.row}, {local.col})")
        debug.check_layout(local)
        s = spec if isinstance(spec, eng.FixpointSpec) \
            else spec(local, *ctx_args)
        state = s.init_state(n, arg, dev)
        pull = direction == "pull"
        d = torch.tensor(int(pull), dtype=torch.int32, device=dev)
        k, cont = 1, True
        while cont and k <= max_iters:
            if direction == "auto":
                d = eng.dist_choose_direction(s, local.deg, state, k, d, n)
                pull = bool(d)
            state, cont_t = eng.dist_step(
                s, local, state, k, pull=pull, grid=grid,
                row_axes=row_axes, col_axes=col_axes, comm=comm,
                slimwork=slimwork)
            cont = bool(cont_t)  # the one device sync of an iteration
            k += 1
        return state, k - 1
    return fn


# ---------------------------------------------------- per-algorithm factories


def make_dist_bfs(grid, meta, sr_name: str = "tropical", *,
                  row_axes: Sequence[str] = ("data",),
                  col_axes: Sequence[str] = ("model",), max_iters: int = 64,
                  comm: str = "allreduce", direction: str = "push",
                  slimwork: bool = False, device=None):
    """Distributed BFS: ``fn(local, root) -> (distances int32[n],
    iterations)``."""
    run = make_dist_fixpoint(grid, meta, bfs_spec(sr_name), row_axes=row_axes,
                             col_axes=col_axes, max_iters=max_iters,
                             comm=comm, direction=direction,
                             slimwork=slimwork, device=device)

    def fn(local, root):
        state, iters = run(local, int(root))
        return state["d"], iters
    return fn


def make_dist_multi_bfs(grid, meta, sr_name: str = "tropical", *,
                        row_axes: Sequence[str] = ("data",),
                        col_axes: Sequence[str] = ("model",),
                        max_iters: int = 64, comm: str = "allreduce",
                        direction: str = "push", slimwork: bool = False,
                        packed: bool = False,
                        batch_width: Optional[int] = None, device=None):
    """Distributed multi-source BFS over the [n, B] frontier matrix:
    ``fn(local, roots[B]) -> (distances int32[B, n], iterations)``. Under
    "auto" the whole batch switches together.

    ``packed=True`` is SlimSell-B on the grid: the batch travels as
    ``ceil(B/32)`` word planes and the all-reduce ORs words
    (``packing.por``). It needs ``sr_name="boolean"``, the push direction
    and ``batch_width`` (the plane count is fixed by the spec)."""
    if packed:
        check_choice("sr_name", sr_name, ("boolean",),
                     hint="packed=True is the bit-packed boolean push path")
        check_choice("direction", direction, ("push",),
                     hint="the packed sweep is push-only")
        if batch_width is None:
            raise ValueError("packed=True needs a static batch_width "
                             "(the packed plane count is ceil(B/32))")
        spec = packed_multi_bfs_spec(int(batch_width))
    else:
        spec = multi_bfs_spec(sr_name)
    run = make_dist_fixpoint(grid, meta, spec, row_axes=row_axes,
                             col_axes=col_axes, max_iters=max_iters,
                             comm=comm, direction=direction,
                             slimwork=slimwork, device=device)

    def fn(local, roots):
        roots = torch.as_tensor(np.asarray(roots, np.int64))
        if packed and roots.numel() != batch_width:
            raise ValueError(f"{roots.numel()} roots for batch_width "
                             f"{batch_width}")
        state, iters = run(local, roots)
        return state["d"].T, iters
    return fn


def make_dist_sssp(grid, meta, *, row_axes: Sequence[str] = ("data",),
                   col_axes: Sequence[str] = ("model",),
                   max_iters: int = 512, comm: str = "allreduce",
                   slimwork: bool = False, device=None):
    """Distributed delta-stepping over the weighted partition:
    ``fn(local, root, delta) -> (distances float32[n], sweeps, buckets)``.
    The light / heavy views are cut from the shard's own weights."""
    run = make_dist_fixpoint(grid, meta, sssp_spec, row_axes=row_axes,
                             col_axes=col_axes, max_iters=max_iters,
                             comm=comm, slimwork=slimwork, device=device)

    def fn(local, root, delta):
        state, iters = run(local, int(root), (float(np.float32(delta)),))
        return state["dist"], iters, state["buckets"]
    return fn


def make_dist_multi_sssp(grid, meta, *, row_axes: Sequence[str] = ("data",),
                         col_axes: Sequence[str] = ("model",),
                         max_iters: int = 512, comm: str = "allreduce",
                         slimwork: bool = False, device=None):
    """Distributed batched delta-stepping over the column-sharded distance
    matrix: ``fn(local, roots[B], delta) -> (distances float32[B, n],
    iterations, sweeps int32[B], buckets int32[B])``."""
    run = make_dist_fixpoint(grid, meta, multi_sssp_spec, row_axes=row_axes,
                             col_axes=col_axes, max_iters=max_iters,
                             comm=comm, slimwork=slimwork, device=device)

    def fn(local, roots, delta):
        roots = torch.as_tensor(np.asarray(roots, np.int64))
        state, iters = run(local, roots, (float(np.float32(delta)),))
        return state["dist"].T, iters, state["sweeps"], state["buckets"]
    return fn


def make_dist_cc(grid, meta, *, row_axes: Sequence[str] = ("data",),
                 col_axes: Sequence[str] = ("model",),
                 max_iters: Optional[int] = None, comm: str = "allreduce",
                 slimwork: bool = False, device=None):
    """Distributed connected components (sel-max label propagation):
    ``fn(local) -> (labels int32[n], iterations)``, ``labels[v]`` the
    largest vertex id of v's component."""
    cap = int(max_iters) if max_iters is not None else _get(meta, "n") + 1
    run = make_dist_fixpoint(grid, meta, CC_SPEC, row_axes=row_axes,
                             col_axes=col_axes, max_iters=cap, comm=comm,
                             slimwork=slimwork, device=device)

    def fn(local):
        state, iters = run(local, 0)
        return state["x"].to(torch.int32) - 1, iters
    return fn


def make_dist_pagerank(grid, meta, *, row_axes: Sequence[str] = ("data",),
                       col_axes: Sequence[str] = ("model",),
                       max_iters: int = PAGERANK_MAX_ITERS,
                       comm: str = "allreduce", slimwork: bool = False,
                       device=None):
    """Distributed PageRank: ``fn(local, damping, tol) -> (ranks
    float32[n], iterations, resid_log float32[WORK_LOG])``. ``inv_deg`` and
    ``dangling`` come from the whole graph's degrees the shard carries."""
    n = _get(meta, "n")

    def spec(local, damping, tol):
        inv_deg, dangling = pagerank_views(local.deg)
        return pagerank_spec(n, damping, tol, inv_deg, dangling)

    run = make_dist_fixpoint(grid, meta, spec, row_axes=row_axes,
                             col_axes=col_axes, max_iters=max_iters,
                             comm=comm, slimwork=slimwork, device=device)

    def fn(local, damping, tol):
        state, iters = run(local, 0, (float(damping), float(tol)))
        return state["r"], iters, state["resid_log"]
    return fn


def make_dist_brandes(grid, meta, *, row_axes: Sequence[str] = ("data",),
                      col_axes: Sequence[str] = ("model",),
                      max_iters: Optional[int] = None,
                      comm: str = "allreduce", slimwork: bool = False,
                      device=None):
    """Distributed Brandes sweeps: ``fn(local, roots[B]) -> (delta
    float32[n, B], d int32[n, B], fwd_iters, bwd_iters)``: the forward
    path-count batch, then the dependency back-propagation over its
    levels. ``betweenness.brandes_accumulate`` folds ``delta`` into
    scores (halve them for the undirected doubling)."""
    cap = int(max_iters) if max_iters is not None else _get(meta, "n") + 1
    common = dict(row_axes=row_axes, col_axes=col_axes, max_iters=cap,
                  comm=comm, slimwork=slimwork, device=device)
    fwd = make_dist_fixpoint(grid, meta, BRANDES_FORWARD_SPEC, **common)
    bwd = make_dist_fixpoint(grid, meta,
                             lambda local, d, sigma:
                             brandes_backward_spec(d, sigma), **common)

    def fn(local, roots):
        roots = torch.as_tensor(np.asarray(roots, np.int64))
        state, it_f = fwd(local, roots)
        d, sigma = state["d"], state["sigma"]
        del state
        levels0 = d.amax(dim=0)          # each column's eccentricity
        state, it_b = bwd(local, levels0, (d, sigma))
        return state["delta"], d, it_f, it_b
    return fn


def make_dist_khop(grid, meta, k: int, *,
                   row_axes: Sequence[str] = ("data",),
                   col_axes: Sequence[str] = ("model",),
                   comm: str = "allreduce", direction: str = "push",
                   slimwork: bool = False, packed: bool = False,
                   batch_width: Optional[int] = None, device=None):
    """Distributed k-hop: ``fn(local, roots[B]) -> (distances int32[B, n],
    iterations)``, -1 past depth ``k``; the boolean multi-source BFS with
    ``max_iters=k``."""
    if k < 0:
        raise ValueError(f"make_dist_khop: k must be >= 0, got {k}")
    return make_dist_multi_bfs(grid, meta, "boolean", row_axes=row_axes,
                               col_axes=col_axes, max_iters=int(k),
                               comm=comm, direction=direction,
                               slimwork=slimwork, packed=packed,
                               batch_width=batch_width, device=device)


# ------------------------------------------------ optimized sliced exchange


_SLICED_DTYPES = (torch.float32, torch.bfloat16, torch.int16)


def make_dist_bfs_sliced(grid, meta, *, row_axis: str = "data",
                         col_axis: str = "model",
                         pod_axis: Optional[str] = None, max_iters: int = 64,
                         frontier_dtype: torch.dtype = torch.float32,
                         device=None):
    """Tropical BFS over the slot-space partition with the frontier
    exchange cut to the own row slice: ``fn(cols, row_block, root_slot) ->
    (distances int32[R, cps * C] in slot space, iterations)``, ``cols`` /
    ``row_block`` this rank's block of tiles (with ``pod_axis``, the pod's
    share of the block's tiles: A is the sum of the pods' blocks).

    Rows over ``row_axis`` and columns over ``col_axis`` (R == Co). An
    iteration on rank (i, j): the local sweep of x_j (the frontier of
    column range j), a MIN reduce of the own row slice over ``col_axis``
    (and ``pod_axis``), and the grid transpose: rank (i, j) sends its new
    f_i to rank (j, i), whose next x is f_i. The frontier is float32,
    bfloat16 or int16 (hop counts are small integers, exact in each; int16
    keeps "unreached" as 30,000, which drifts up by one an iteration below
    int16's limit). ``row_vertex`` maps the slots back to vertex ids.
    """
    dev = resolve_device(device)
    if frontier_dtype not in _SLICED_DTYPES:
        raise ValueError(f"frontier_dtype must be one of {_SLICED_DTYPES}, "
                         f"got {frontier_dtype}")
    R, Co = _get(meta, "R"), _get(meta, "Co")
    if R != Co:
        raise ValueError("the sliced BFS uses a square (data x model) grid, "
                         f"got R={R}, Co={Co}")
    if (grid.axis_size(row_axis), grid.axis_size(col_axis)) != (R, Co):
        raise ValueError(f"the grid's {row_axis} x {col_axis} is not "
                         f"{R} x {Co}")
    cps, C = _get(meta, "chunks_per_shard"), _get(meta, "C")
    n_row = cps * C                           # slots a row shard
    reduce_axes = (pod_axis, col_axis) if pod_axis else (col_axis,)
    integer = not frontier_dtype.is_floating_point
    inf = 30_000 if integer else float("inf")

    def fn(cols, row_block, root_slot):
        cols = torch.as_tensor(cols).to(dev)
        row_block = torch.as_tensor(row_block).to(dev).long()
        i, j = grid.coord(row_axis), grid.coord(col_axis)
        peer = grid.rank_of(**{row_axis: j, col_axis: i})
        slots = torch.arange(n_row, device=dev)
        root_slot = int(root_slot)
        f_i = torch.where(i * n_row + slots == root_slot, 0, inf).to(
            frontier_dtype)
        x_j = torch.where(j * n_row + slots == root_slot, 0, inf).to(
            frontier_dtype)
        pad = cols < 0
        safe = cols.clamp_min(0).long()
        # the sanitizer's bounds of the two index operands below
        debug.check_gather(safe, n_row)
        debug.check_gather(row_block, cps)
        seg = row_block[:, None].expand(-1, C).contiguous()
        one = torch.ones((), dtype=frontier_dtype, device=dev)
        fill = torch.full((), inf, dtype=frontier_dtype, device=dev)
        k, changed = 1, True
        while changed and k <= max_iters:
            contrib = torch.where(pad, fill, x_j[safe] + one)
            tile_red = contrib.amin(dim=-1)                        # [T, C]
            y = torch.full((cps, C), inf, dtype=frontier_dtype, device=dev)
            y.scatter_reduce_(0, seg, tile_red, "amin", include_self=True)
            # (1) the partial minima of the own rows, over model (and pod)
            y = grid.all_reduce(y.reshape(n_row), "min", reduce_axes)
            f_new = torch.minimum(f_i, y)
            moved = (f_new < f_i).any().to(torch.int32)
            # (2) the grid transpose: the next x of rank (j, i) is f_i
            x_j = grid.exchange(f_new, peer)
            f_i = f_new
            changed = bool(grid.all_reduce(moved, "max",
                                           grid.axis_names) > 0)
            k += 1
        unreached = f_i >= inf
        d_i = torch.where(unreached, -1, f_i.float().to(torch.int32))
        # every rank returns all row slices, as the mesh's output is
        return grid.all_gather(d_i, (row_axis,)), k - 1
    return fn


# ------------------------------------------------------------ rank function


_FACTORIES = {
    "bfs": make_dist_bfs, "multi_bfs": make_dist_multi_bfs,
    "sssp": make_dist_sssp, "multi_sssp": make_dist_multi_sssp,
    "cc": make_dist_cc, "pagerank": make_dist_pagerank,
    "brandes": make_dist_brandes, "khop": make_dist_khop,
    "bfs_sliced": make_dist_bfs_sliced,
}


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x


def _digest(outputs) -> str:
    """sha256 over the outputs' dtypes, shapes and bytes: equal on every
    rank when the replicated results are."""
    h = hashlib.sha256()
    for a in outputs:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def run_cases(grid, cases: Sequence[dict]) -> list:
    """A rank function for ``distributed.launch``: run each case on this
    rank. Returns, for each case, rank 0's outputs as numpy (None on the
    other ranks), a digest of the outputs (to show every rank holds the
    same), the call's wall time (the card synchronised around it; a
    shard's first call also builds its kernels' work lists), its kernel
    launches, counted from zero, and its collectives (``grid.stats``).

    A case is a dict: ``factory`` (a key of the factories: "bfs",
    "multi_bfs", "sssp", "multi_sssp", "cc", "pagerank", "brandes",
    "khop", "bfs_sliced"), ``partition`` (a ``save_partition`` directory),
    ``args`` (after the shard), ``kwargs`` (the factory's, besides the
    grid, the partition and the device; ``frontier_dtype`` by name), and
    for "bfs_sliced" ``pods`` (the pod share of the block's tiles is
    every ``pods``-th tile from the pod's index). Shards are loaded once
    a partition and kept on the device. A case's optional ``signal`` is a
    path that rank 0 creates once every rank has ended the case, so that
    the caller can start other work at that point. A case's optional
    ``sanitize`` (True or False) runs its call with the sanitizer on or
    off (``core.debug``), whatever the world's state.
    """
    from ..kernels import ops
    dev = grid.device
    shards, out = {}, []

    def local_of(path, i, j):
        if (path, i, j) not in shards:
            shards[path, i, j] = load_shard(path, i, j).to_torch(dev)
        return shards[path, i, j]

    for case in cases:
        kwargs = dict(case.get("kwargs", {}))
        meta = load_meta(case["partition"])
        if case["factory"] == "bfs_sliced":
            kwargs["frontier_dtype"] = getattr(torch, kwargs.get(
                "frontier_dtype", "float32"))
            local = local_of(case["partition"],
                             grid.coord(kwargs.get("row_axis", "data")),
                             grid.coord(kwargs.get("col_axis", "model")))
            pod = kwargs.get("pod_axis")
            p, P = (grid.coord(pod), case["pods"]) if pod else (0, 1)
            call_args = (local.cols[p::P], local.row_block[p::P])
        else:
            local = local_of(
                case["partition"],
                grid.index(tuple(kwargs.get("row_axes", ("data",)))),
                grid.index(tuple(kwargs.get("col_axes", ("model",)))))
            call_args = (local,)
        fn = _FACTORIES[case["factory"]](grid, meta, device=dev, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ops.reset_launches()
        grid.stats.reset()
        sanitize = case.get("sanitize")
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if sanitize is None else
              debug.checked() if sanitize else debug.suspended()):
            res = fn(*call_args, *case.get("args", ()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        res = _numpy(res)
        out.append({"result": res if grid.rank == 0 else None,
                    "digest": _digest(res), "seconds": wall,
                    "launches": {k: v for k, v in ops.launch_counts().items()
                                 if v},
                    "comm": grid.stats.snapshot()})
        del res
        if case.get("signal"):
            torch.distributed.barrier()
            if grid.rank == 0:
                open(case["signal"], "w").close()
    return out
