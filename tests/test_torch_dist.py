"""The port's 2D-distributed factories against the JAX package's
single-device jnp path, in gloo worlds of CPU processes.

One world a grid shape, (2, 2) and (4, 2) over ("data", "model") and
(2, 2, 2) over ("pod", "data", "model") with the rows over (pod, data),
spawned once for the module (``distributed.launch``), runs every case of
its grid in one go (``dist_bfs.run_cases``); each case is then one test.
The cases are those of the JAX package's distributed parity tests: BFS in
four semirings x push / pull / auto, multi-source BFS likewise, packed
multi-source BFS, the SlimWork push masks, SSSP and batched SSSP at the
default delta and at inf, CC on three families, PageRank at two
dampings, Brandes, k-hop lane (three directions) and packed; each under
both comm modes. The sliced BFS runs on (2, 2) and (2, 2, 2) (edges split
over the pods) in float32, bfloat16 and int16.

Held: distances, levels, labels, iterations, SSSP sweeps and buckets and
Brandes depths bit-equal to ``repro``'s single-device jnp results on the
same inputs; PageRank within ``TOLERANCES["pagerank"]`` (sweep counts and
the residual log too, on a graph whose residual floor lies far below
tol); betweenness within rtol 1e-5; every rank's outputs equal.
"""
import functools
import time

import numpy as np
import pytest
import torch

from oracles import TOLERANCES
from repro.core import formats as jf
from repro.core.betweenness import betweenness as jbetweenness
from repro.core.bfs import bfs as jbfs
from repro.core.cc import cc as jcc
from repro.core.khop import khop_many as jkhop_many
from repro.core.multi_bfs import multi_source_bfs as jmulti_bfs
from repro.core.multi_sssp import multi_source_sssp as jmulti_sssp
from repro.core.options import EngineConfig as JConfig
from repro.core.pagerank import pagerank as jpagerank
from repro.core.sssp import default_delta as jdefault_delta
from repro.core.sssp import sssp as jsssp
from repro.graphs import generators as jg
from repro_torch.core.betweenness import brandes_accumulate
from repro_torch.core.dist_bfs import (partition_slimsell, run_cases,
                                       save_partition)
from repro_torch.core.formats import sellcs_order
from repro_torch.distributed import launch
from repro_torch.graphs import generators as pg

GRIDS = {
    "2x2": ((2, 2), ("data", "model"), ("data",)),
    "4x2": ((4, 2), ("data", "model"), ("data",)),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
}
SEMIRINGS = ("tropical", "real", "boolean", "selmax")
DIRECTIONS = ("push", "pull", "auto")
COMMS = ("allreduce", "reduce_gather")
WORLD_TIMEOUT_S = 300.0

# graph name -> (builder over a generators module, C, L)
GRAPHS = {
    "kron8": (lambda g: g.kronecker(8, 8, seed=3), 8, 16),
    "kron7": (lambda g: g.kronecker(7, 8, seed=5), 4, 8),
    "er128": (lambda g: g.erdos_renyi(128, 6, seed=1), 4, 8),
    "er140": (lambda g: g.erdos_renyi(140, 5, seed=7), 4, 8),
    "w_kron8": (lambda g: g.with_random_weights(g.kronecker(8, 8, seed=3),
                                                seed=13), 8, 16),
    "w_er128": (lambda g: g.with_random_weights(g.erdos_renyi(128, 6, seed=1),
                                                seed=11), 8, 16),
    "two_comp": (lambda g: g.two_components(6, 6, seed=5), 4, 8),
    "star64": (lambda g: g.star(64), 4, 8),
    "er96_2": (lambda g: g.erdos_renyi(96, 2, seed=4), 4, 8),
    "kron8_pr": (lambda g: g.kronecker(8, 8, seed=3), 4, 8),
    "er96_5": (lambda g: g.erdos_renyi(96, 5, seed=2), 4, 8),
}
MULTI_ROOTS = [0, 5, 17, 101]
SSSP_ROOTS = [0, 5, 17, 101, 33]          # 5: a width no tile divides
PACKED_ROOTS = sorted(int(r) for r in np.random.default_rng(2).choice(
    140, 33, replace=False))              # 33 roots: two word planes
SW_ROOTS = [0, 9, 41, 77]
BC_ROOTS = [0, 7, 23, 55, 80]
KHOP_ROOTS = [0, 9, 41, 77, 130]


@functools.lru_cache(maxsize=None)
def csrs(name: str):
    """(JAX CSR, port CSR) of one graph, each package's own generator."""
    build = GRAPHS[name][0]
    jcsr, pcsr = build(jg), build(pg)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    return jcsr, pcsr


@functools.lru_cache(maxsize=None)
def jtiled(name: str):
    jcsr, _ = csrs(name)
    _, C, L = GRAPHS[name]
    return jf.build_slimsell(jcsr, C=C, L=L).to_jax()


def root_of(name: str) -> int:
    return int(np.argmax(csrs(name)[1].deg))


@functools.lru_cache(maxsize=None)
def jdelta(name: str) -> float:
    """The JAX package's default delta, passed to both sides."""
    return float(jdefault_delta(jtiled(name)))


# ------------------------------------------------------------------ cases


def grid_cases(grid: str) -> list:
    """(case id, case) pairs of one grid; a case names its graph,
    factory, kwargs (comm and axes included) and call arguments, and the
    check that holds it to the reference."""
    _, _, row_axes = GRIDS[grid]
    out = []

    def add(cid, graph, factory, args, check, **kwargs):
        kwargs["row_axes"] = row_axes
        out.append((cid, dict(graph=graph, factory=factory, args=list(args),
                              kwargs=kwargs, check=check)))

    for comm in COMMS:
        for sr in SEMIRINGS:
            for d in DIRECTIONS:
                add(f"bfs-{sr}-{d}-{comm}", "kron8", "bfs", [root_of("kron8")],
                    "bfs", sr_name=sr, direction=d, comm=comm)
                add(f"multi_bfs-{sr}-{d}-{comm}", "er128", "multi_bfs",
                    [MULTI_ROOTS], "multi_bfs", sr_name=sr, direction=d,
                    comm=comm)
        for sr in ("tropical", "boolean"):
            add(f"bfs-slimwork-{sr}-{comm}", "kron7", "bfs",
                [root_of("kron7")], "bfs", sr_name=sr, slimwork=True,
                comm=comm)
        add(f"multi_bfs-slimwork-boolean-{comm}", "kron7", "multi_bfs",
            [SW_ROOTS], "multi_bfs", sr_name="boolean", slimwork=True,
            comm=comm)
        for sw in (False, True):
            add(f"multi_bfs-packed-slimwork{int(sw)}-{comm}", "er140",
                "multi_bfs", [PACKED_ROOTS], "packed", sr_name="boolean",
                packed=True, batch_width=len(PACKED_ROOTS), slimwork=sw,
                comm=comm)
        for g in ("w_kron8", "w_er128"):
            for delta in ("default", "inf"):
                add(f"sssp-{g}-{delta}-{comm}", g, "sssp",
                    [root_of(g), delta], "sssp", comm=comm)
        for delta in ("default", "inf"):
            add(f"multi_sssp-{delta}-{comm}", "w_kron8", "multi_sssp",
                [SSSP_ROOTS, delta], "multi_sssp", comm=comm)
        for g in ("two_comp", "star64", "er96_2"):
            add(f"cc-{g}-{comm}", g, "cc", [], "cc", comm=comm)
        for damping in (0.85, 0.3):
            add(f"pagerank-{damping}-{comm}", "kron8_pr", "pagerank",
                [damping, 1e-6], "pagerank", comm=comm)
        add(f"brandes-{comm}", "er96_5", "brandes", [BC_ROOTS], "brandes",
            comm=comm)
        for d in DIRECTIONS:
            add(f"khop-lane-{d}-{comm}", "er140", "khop", [KHOP_ROOTS],
                "khop", k=2, direction=d, comm=comm)
        add(f"khop-packed-{comm}", "er140", "khop", [KHOP_ROOTS], "khop",
            k=2, packed=True, batch_width=len(KHOP_ROOTS), comm=comm)
    if grid in ("2x2", "2x2x2"):
        for dtype in ("float32", "bfloat16", "int16"):
            kwargs = {"frontier_dtype": dtype}
            if grid == "2x2x2":
                kwargs["pod_axis"] = "pod"
            out.append((f"bfs_sliced-{dtype}", dict(
                graph="kron8", factory="bfs_sliced", args=["root_slot"],
                kwargs=kwargs, check="sliced", sliced=True)))
    return out


CASES = {g: grid_cases(g) for g in GRIDS}


def _partition_dir(root, graph: str, R: int, Co: int, slot: bool) -> str:
    path = root / f"{graph}-R{R}-Co{Co}-slot{int(slot)}"
    if not path.exists():
        _, csr = csrs(graph)
        _, C, L = GRAPHS[graph]
        save_partition(partition_slimsell(csr, R, Co, C=C, L=L,
                                          slot_space=slot, device="cpu"),
                       str(path))
    return str(path)


def _runnable(root, grid: str) -> list:
    """The grid's cases as ``run_cases`` takes them."""
    shape, _, row_axes = GRIDS[grid]
    R = int(np.prod(shape[:len(row_axes)]))
    out = []
    for _, case in CASES[grid]:
        sliced = case.get("sliced", False)
        Rp = shape[-2] if sliced else R
        args = list(case["args"])
        if case["factory"] in ("sssp", "multi_sssp"):
            args[1] = jdelta(case["graph"]) if args[1] == "default" \
                else float("inf")
        if sliced:
            csr = csrs(case["graph"])[1]
            perm = sellcs_order(csr.deg, csr.n)
            args = [int(np.nonzero(perm == root_of(case["graph"]))[0][0])]
        out.append(dict(factory=case["factory"], args=args,
                        kwargs=case["kwargs"], pods=shape[0],
                        partition=_partition_dir(root, case["graph"], Rp,
                                                 shape[-1], sliced)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """grid -> every rank's outputs of its cases, one world a grid, spawned
    at the grid's first test."""
    root = tmp_path_factory.mktemp("dist_partitions")
    done = {}

    def get(grid: str):
        if grid not in done:
            shape, names, _ = GRIDS[grid]
            done[grid] = launch(run_cases, shape, names,
                                (_runnable(root, grid),), device="cpu",
                                timeout=WORLD_TIMEOUT_S)
        return done[grid]
    return get


# ----------------------------------------------------------------- checks


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def check_bfs(case, got):
    d, iters = got
    kw = case["kwargs"]
    ref = jbfs(jtiled(case["graph"]), case["args"][0], kw["sr_name"],
               config=JConfig(direction=kw.get("direction", "push")))
    assert _eq(d, ref.distances)
    assert int(iters) == ref.iterations


def check_multi_bfs(case, got):
    d, iters = got
    kw = case["kwargs"]
    ref = jmulti_bfs(jtiled(case["graph"]), np.asarray(case["args"][0],
                                                       np.int32),
                     kw["sr_name"],
                     config=JConfig(direction=kw.get("direction", "push")))
    assert _eq(d, ref.distances)
    assert int(iters) == int(ref.iterations[0])


def check_packed(case, got):
    d, iters = got
    ref = jmulti_bfs(jtiled(case["graph"]), np.asarray(case["args"][0],
                                                       np.int32),
                     "boolean", packed=True)
    assert _eq(d, ref.distances)
    assert int(iters) == int(ref.iterations[0])


def check_sssp(case, got):
    dist, sweeps, buckets = got
    g, (root, delta) = case["graph"], case["args"]
    ref = jsssp(jtiled(g), root, delta=jdelta(g) if delta == "default"
                else float("inf"))
    assert _eq(dist, ref.distances)
    assert int(sweeps) == ref.sweeps and int(buckets) == ref.buckets


def check_multi_sssp(case, got):
    dist, iters, sweeps, buckets = got
    g, (roots, delta) = case["graph"], case["args"]
    ref = jmulti_sssp(jtiled(g), np.asarray(roots, np.int32),
                      delta=jdelta(g) if delta == "default" else float("inf"))
    assert _eq(dist, ref.distances)
    assert _eq(sweeps, ref.sweeps.astype(np.int32))
    assert _eq(buckets, ref.buckets.astype(np.int32))
    assert int(iters) == int(ref.iterations[0])


def check_cc(case, got):
    labels, iters = got
    ref = jcc(jtiled(case["graph"]))
    assert _eq(labels, ref.labels)
    assert int(iters) == ref.iterations


def check_pagerank(case, got):
    ranks, iters, resid_log = got
    damping, tol = case["args"]
    ref = jpagerank(jtiled(case["graph"]), damping=damping, tol=tol)
    np.testing.assert_allclose(ranks, ref.ranks, **TOLERANCES["pagerank"])
    # kronecker(8, 8): the residual floor lies far below tol, so the sweep
    # counts agree; the residual log as the JAX package's parity test holds it
    assert int(iters) == ref.iterations
    np.testing.assert_allclose(resid_log[:int(iters)], ref.residuals,
                               rtol=1e-3, atol=1e-7)


def check_brandes(case, got):
    delta, d, it_f, it_b = got
    roots = np.asarray(case["args"][0], np.int64)
    tiled = jtiled(case["graph"])
    ref = jbetweenness(tiled, sources=roots)
    scores = brandes_accumulate(delta, roots) / 2.0
    np.testing.assert_allclose(scores, ref.scores, rtol=1e-5, atol=1e-6)
    depths = jmulti_bfs(tiled, roots.astype(np.int32), "tropical")
    assert _eq(d.T, depths.distances)
    assert int(it_f) == int(depths.iterations[0])
    assert int(it_b) == int(d.max())


def check_khop(case, got):
    d, iters = got
    kw = case["kwargs"]
    ref = jkhop_many(jtiled(case["graph"]), np.asarray(case["args"][0],
                                                       np.int32), kw["k"],
                     packed=kw.get("packed", False),
                     config=JConfig(direction=kw.get("direction", "push")))
    assert _eq(d, ref.distances)
    assert _eq(d >= 0, ref.mask)


def check_sliced(case, got):
    d_slots, iters = got
    _, csr = csrs(case["graph"])
    perm = sellcs_order(csr.deg, csr.n)
    d = np.full(csr.n, -1, np.int32)
    d[perm] = np.asarray(d_slots).reshape(-1)[:csr.n]
    ref = jbfs(jtiled(case["graph"]), root_of(case["graph"]), "tropical")
    assert _eq(d, ref.distances)
    assert int(iters) == ref.iterations


CHECKS = {"bfs": check_bfs, "multi_bfs": check_multi_bfs,
          "packed": check_packed, "sssp": check_sssp,
          "multi_sssp": check_multi_sssp, "cc": check_cc,
          "pagerank": check_pagerank, "brandes": check_brandes,
          "khop": check_khop, "sliced": check_sliced}

PARAMS = [pytest.param(g, i, id=f"{g}-{cid}")
          for g in GRIDS for i, (cid, _) in enumerate(CASES[g])]


@pytest.mark.parametrize("grid,idx", PARAMS)
def test_factory_matches_jax(world, grid, idx):
    ranks = world(grid)
    case = CASES[grid][idx][1]
    got = ranks[0][idx]["result"]
    assert {r[idx]["digest"] for r in ranks} == {ranks[0][idx]["digest"]}, \
        "the ranks' outputs differ"
    CHECKS[case["check"]](case, got)


def test_every_grid_ran_its_collectives(world):
    """Each case's collectives were counted on every rank (the strategy
    all-reduces once or twice an iteration), and the CPU ranks launched
    no kernel."""
    for grid in GRIDS:
        for rank in world(grid):
            for out in rank:
                assert out["comm"]["calls"] >= 1
                assert out["launches"] == {}


# ------------------------------------------------------------- the launcher
# rank functions, importable by name as the spawned ranks need


def _geometry(grid):
    out = grid.all_gather(torch.tensor([grid.rank]), ("data",))
    return (grid.rank, dict(grid.coords), grid.index(("pod", "data")),
            grid.rank_of(model=0), out.reshape(-1).tolist())


def _fail_on_rank_one(grid):
    if grid.rank == 1:
        raise ValueError("rank one fails")
    return grid.rank


def _sleep(grid, seconds):
    time.sleep(seconds)


def test_launch_grid_geometry():
    """Ranks fill the grid row-major over its axes; the row index over
    (pod, data) is pod-major; a gather over an axis is in its order."""
    got = launch(_geometry, (2, 2, 2), ("pod", "data", "model"),
                 device="cpu", timeout=WORLD_TIMEOUT_S)
    for rank, (r, coords, row, rank0, gathered) in enumerate(got):
        p, d, m = np.unravel_index(rank, (2, 2, 2))
        assert r == rank and coords == {"pod": p, "data": d, "model": m}
        assert row == 2 * p + d and rank0 == 4 * p + 2 * d
        assert gathered == [4 * p + m, 4 * p + 2 + m]


def test_launch_fails_with_a_failing_rank():
    """One rank raises, the other returns: the launch raises all the same,
    with the failing rank's traceback."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 exited.*rank one fails"):
        launch(_fail_on_rank_one, (2,), ("data",), device="cpu",
               timeout=WORLD_TIMEOUT_S)


def test_launch_fails_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch(_sleep, (2,), ("data",), (120.0,), device="cpu", timeout=8.0)
    assert time.monotonic() - t0 < 60.0
