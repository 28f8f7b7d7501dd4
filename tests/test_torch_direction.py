"""Direction-optimizing BFS in the port (plain path, CPU) against the JAX
package's jnp path.

The direction logic (``edge_counts``, ``choose_direction`` and its host
twin) must agree exactly. End to end, for 4 semirings x {push, pull, auto}
x {fused, hostloop}: distances, iterations, work logs and direction logs
are bit-equal; DP parents (tropical, real, boolean) are equal, and so are
sel-max parents under push. Under pull and auto the port's first-hit pull
may pick another parent than the jnp full reduction, so sel-max trees are
validated instead (Graph500 §5.2).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph500 as jg500
from repro.core import bfs as jbfs
from repro.core import direction as jdm
from repro.core import formats as jf
from repro.core import multi_bfs as jmulti
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch import graph500 as pg500
from repro_torch.core import bfs as pbfs
from repro_torch.core import direction as pdm
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core import multi_bfs as pmulti
from repro_torch.core.options import EngineConfig
from repro_torch.graph500 import validate_bfs_tree
from repro_torch.graphs import generators as pg

SEMIRINGS = ["tropical", "real", "boolean", "selmax"]
DIRECTIONS = ["push", "pull", "auto"]
MODES = ["fused", "hostloop"]
GRAPHS = {"kron": (lambda g: g.kronecker(8, 8, seed=1), 5),
          "two": (lambda g: g.two_components(6, 6, seed=4), 3)}


def path_graph(build_csr, n):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return build_csr(edges, n)


def _pair(make, C=8, L=16):
    """The same graph through both packages: (jax layout, csr, cpu layout)."""
    csr = make(pg)
    jt = jf.build_slimsell(make(jg), C=C, L=L).to_jax()
    return jt, csr, pf.build_slimsell(csr, C=C, L=L).to_torch("cpu")


@pytest.fixture(scope="module")
def layouts():
    return {g: _pair(make) for g, (make, _) in GRAPHS.items()}


def _assert_same_run(got, want, csr, root, semiring, direction):
    assert got.iterations == want.iterations
    for f in ("distances", "work_log", "directions"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f
    if semiring != "selmax" or direction == "push":
        assert np.array_equal(got.parents, want.parents)
    validate_bfs_tree(csr, root, got.distances, got.parents)


# ----------------------------------------------------------- direction logic


@pytest.mark.parametrize("width", [None, 1, 7])
def test_direction_logic_matches_jax(width):
    rng = np.random.default_rng(width or 0)
    n = 300
    deg = rng.integers(0, 60, size=n).astype(np.int32)
    for _ in range(20):
        shape = (n,) if width is None else (n, width)
        fb = rng.random(shape) < rng.random()
        nf = rng.random(shape) < rng.random()
        cur = rng.integers(0, 2, size=() if width is None else (width,))
        want = jdm.edge_counts(jnp.asarray(deg), jnp.asarray(fb), jnp.asarray(nf))
        got = pdm.edge_counts(torch.from_numpy(deg), torch.from_numpy(fb),
                              torch.from_numpy(nf))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert np.array_equal(a.numpy(), np.asarray(b))
        d_want = jdm.choose_direction(jnp.asarray(cur, jnp.int32), *want, n)
        d_got = pdm.choose_direction(torch.tensor(cur, dtype=torch.int32),
                                     *got, n)
        assert d_got.dtype == torch.int32
        assert np.array_equal(d_got.numpy(), np.asarray(d_want))


def test_direction_host_twin_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(500):
        args = (int(rng.integers(0, 2)), float(rng.integers(0, 5000)),
                float(rng.integers(0, 70000)), float(rng.integers(0, 100)),
                int(rng.integers(1, 3000)))
        assert pdm.choose_direction_host(*args) == jdm.choose_direction_host(*args)
    assert (pdm.PUSH, pdm.PULL, pdm.ALPHA, pdm.BETA) == \
        (jdm.PUSH, jdm.PULL, jdm.ALPHA, jdm.BETA)


def test_edge_counts_are_exact_past_float32():
    """The sums are exact before the cast: 2^24 + 4 is a float32, which a
    float32 sum that adds the 1s to 2^24 one at a time would not reach."""
    deg = torch.tensor([1 << 24, 1, 1, 1, 1], dtype=torch.int32)
    bits = torch.ones(5, dtype=torch.bool)
    mf, mu, nnz = pdm.edge_counts(deg, bits, bits)
    assert float(mf) == float(mu) == (1 << 24) + 4 and float(nnz) == 5


# ------------------------------------------------------------- end to end


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bfs_matches_jnp(layouts, graph, semiring, direction, mode):
    jt, csr, pt = layouts[graph]
    root = GRAPHS[graph][1]
    cfg = dict(direction=direction, mode=mode)
    want = jbfs.bfs(jt, root, semiring, need_parents=True, log_work=True,
                    config=JConfig(**cfg))
    got = pbfs.bfs(pt, root, semiring, need_parents=True, log_work=True,
                   config=EngineConfig(**cfg), device="cpu")
    _assert_same_run(got, want, csr, root, semiring, direction)
    if direction != "auto":
        assert (got.directions == (direction == "pull")).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("slimwork,max_iters", [(False, None), (True, 2)])
def test_bfs_options_match_jnp(layouts, slimwork, max_iters, direction, mode):
    """The unreachable component, no SlimWork, and a capped iteration
    count; and the logs kept without ``log_work``."""
    jt, csr, pt = layouts["two"]
    cfg = dict(direction=direction, mode=mode)
    for log_work in (True, False):
        want = jbfs.bfs(jt, 3, "selmax", need_parents=True, log_work=log_work,
                        slimwork=slimwork, max_iters=max_iters,
                        config=JConfig(**cfg))
        got = pbfs.bfs(pt, 3, "selmax", need_parents=True, log_work=log_work,
                       slimwork=slimwork, max_iters=max_iters,
                       config=EngineConfig(**cfg), device="cpu")
        assert (got.distances < 0).any()  # the other component
        assert got.iterations == want.iterations
        for f in ("distances", "work_log", "directions"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), (f, log_work)
            assert a is None or np.array_equal(a, b), (f, log_work)
        if max_iters is None:
            validate_bfs_tree(csr, 3, got.distances, got.parents)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_multi_source_bfs_matches_jnp(layouts, graph, semiring, direction):
    """Batches of three, the second padded; fused in all three directions."""
    jt, csr, pt = layouts[graph]
    roots = [5, 17, 40, 99, 200] if graph == "kron" else [3, 9, 40, 70]
    want = jmulti.multi_source_bfs(jt, roots, semiring, need_parents=True,
                                   log_work=True, batch_size=3,
                                   config=JConfig(direction=direction))
    got = pmulti.multi_source_bfs(pt, roots, semiring, need_parents=True,
                                  log_work=True, batch_size=3,
                                  config=EngineConfig(direction=direction),
                                  device="cpu")
    for f in ("distances", "iterations", "roots", "work_log", "pull_cols_log"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.work_log.shape == (2, peng.WORK_LOG)
    if semiring != "selmax" or direction == "push":
        assert np.array_equal(got.parents, want.parents)
    for i, r in enumerate(roots):
        validate_bfs_tree(csr, r, got.distances[i], got.parents[i])


@pytest.mark.parametrize("log_work", [True, False])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_multi_source_hostloop_push_matches_jnp(layouts, semiring, log_work):
    jt, _, pt = layouts["kron"]
    roots = [5, 17, 40, 99, 200]
    cfg = dict(mode="hostloop")
    want = jmulti.multi_source_bfs(jt, roots, semiring, need_parents=True,
                                   log_work=log_work, batch_size=3,
                                   config=JConfig(**cfg))
    got = pmulti.multi_source_bfs(pt, roots, semiring, need_parents=True,
                                  log_work=log_work, batch_size=3,
                                  config=EngineConfig(**cfg), device="cpu")
    for f in ("distances", "parents", "iterations", "work_log",
              "pull_cols_log"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f


@pytest.mark.parametrize("direction", ["pull", "auto"])
def test_batched_hostloop_is_push_only(layouts, direction):
    _, _, pt = layouts["kron"]
    with pytest.raises(NotImplementedError, match="push-only"):
        pmulti.multi_source_bfs(pt, [1, 2], config=EngineConfig(
            direction=direction, mode="hostloop"), device="cpu")


# ------------------------------------------------ structured extreme graphs


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_star_graph_matches_jnp(direction):
    jt, csr, pt = _pair(lambda g: g.star(128))
    for semiring in ("tropical", "selmax"):
        want = jbfs.bfs(jt, 5, semiring, need_parents=True, log_work=True,
                        config=JConfig(direction=direction))
        got = pbfs.bfs(pt, 5, semiring, need_parents=True, log_work=True,
                       config=EngineConfig(direction=direction), device="cpu")
        _assert_same_run(got, want, csr, 5, semiring, direction)
        if direction == "auto":
            assert pdm.PULL in got.directions  # the hub's expansion pulls


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_path_graph_matches_jnp(direction):
    jt, csr, pt = _pair(lambda g: path_graph(
        (jf if g is jg else pf).build_csr, 96), C=4, L=8)
    want = jbfs.bfs(jt, 0, "tropical", need_parents=True, log_work=True,
                    config=JConfig(direction=direction))
    got = pbfs.bfs(pt, 0, "tropical", need_parents=True, log_work=True,
                   config=EngineConfig(direction=direction), device="cpu")
    _assert_same_run(got, want, csr, 0, "tropical", direction)
    assert got.iterations >= 95  # diameter + the last sweep that finds nothing
    if direction == "auto":
        assert got.directions[0] == pdm.PUSH
        assert (got.directions == pdm.PUSH).mean() > 0.8


@pytest.mark.parametrize("mode", MODES)
def test_auto_switches_on_rmat(mode):
    jt, csr, pt = _pair(lambda g: g.kronecker(9, 16, seed=5), L=32)
    root = int(np.argmax(csr.deg))
    want = jbfs.bfs(jt, root, "tropical", log_work=True,
                    config=JConfig(direction="auto", mode=mode))
    got = pbfs.bfs(pt, root, "tropical", log_work=True,
                   config=EngineConfig(direction="auto", mode=mode),
                   device="cpu")
    assert np.array_equal(got.directions, want.directions)
    assert np.array_equal(got.work_log, want.work_log)
    assert pdm.PUSH in got.directions and pdm.PULL in got.directions
    assert np.sum(np.diff(got.directions) != 0) >= 1


def test_multisource_per_column_direction_state():
    """auto mixes directions inside one batch (per-column state)."""
    jt, csr, pt = _pair(lambda g: g.kronecker(8, 8, seed=1))
    roots = pg500.sample_roots(csr, 6, seed=0)
    want = jmulti.multi_source_bfs(jt, roots, "tropical", log_work=True,
                                   config=JConfig(direction="auto"))
    got = pmulti.multi_source_bfs(pt, roots, "tropical", log_work=True,
                                  config=EngineConfig(direction="auto"),
                                  device="cpu")
    assert np.array_equal(got.pull_cols_log, want.pull_cols_log)
    plog = got.pull_cols_log[0][: int(got.iterations[0])]
    assert plog.max() > 0                         # someone pulled
    assert ((plog > 0) & (plog < roots.size)).any()  # but not all at once


# ------------------------------------------------------------ front doors


def test_engine_config_rejects_unknown_options():
    with pytest.raises(ValueError, match="direction 'sideways'"):
        EngineConfig(direction="sideways")
    with pytest.raises(ValueError, match="mode 'jit'"):
        EngineConfig(mode="jit")
    assert EngineConfig() == EngineConfig(direction="push", mode="fused")


def test_pull_needs_no_push_index():
    """Only push masks read the push index: pull runs on a layout without
    it, push and auto under SlimWork refuse it, as in the JAX package."""
    jt, csr, pt = _pair(GRAPHS["kron"][0])
    bare = dataclasses.replace(pt, inc_src=None, inc_tile=None, inc_ptr=None)
    for mode in MODES:
        got = pbfs.bfs(bare, 5, config=EngineConfig(direction="pull", mode=mode),
                       device="cpu")
        validate_bfs_tree(csr, 5, got.distances)
    for direction in ("push", "auto"):
        with pytest.raises(ValueError, match="push index"):
            pbfs.bfs(bare, 5, config=EngineConfig(direction=direction),
                     device="cpu")
    pbfs.bfs(bare, 5, slimwork=False, config=EngineConfig(direction="auto"),
             device="cpu")


def test_entry_points_without_card_raise_for_every_option(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = pf.build_slimsell(pg.kronecker(6, 4, seed=0), C=8, L=16)
    for direction in DIRECTIONS:
        for mode in MODES:
            cfg = EngineConfig(direction=direction, mode=mode)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pbfs.bfs(host, 0, config=cfg)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pmulti.multi_source_bfs(host, [0, 1], config=cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pg500.run_graph500(scale=5, direction=direction)


def test_run_graph500_direction_shorthand():
    want = jg500.run_graph500(scale=7, edge_factor=8, n_roots=8, batch_size=4,
                              direction="auto")
    got = pg500.run_graph500(scale=7, edge_factor=8, n_roots=8, batch_size=4,
                             direction="auto", device="cpu")
    assert got.direction == want.direction == "auto"
    assert np.array_equal(got.roots, want.roots)
    assert got.validated == want.validated == 8
    pull = pg500.run_graph500(scale=7, edge_factor=8, n_roots=8, batch_size=4,
                              config=EngineConfig(direction="pull"),
                              device="cpu")
    assert pull.direction == "pull" and pull.validated == 8
    with pytest.raises(TypeError, match="not both"):
        pg500.run_graph500(scale=7, direction="auto", config=EngineConfig(),
                           device="cpu")
