"""The port's sanitizer (``repro_torch.core.debug``), the counterpart of the
sanitizer tests in the JAX package's ``tests/test_analysis.py``.

Sanitized runs equal unsanitized runs and the JAX package's jnp results
(BFS fused and hostloop, SSSP, CC, packed BFS). Every corrupt layout
raises ``SanitizerError`` with the JAX package's message before any
sweep: the port's plain sweeps would raise ``IndexError`` on an
out-of-range column on the CPU, so "the corrupt layout runs silently
without the sanitizer" has no counterpart here. ``validate_layout_host``
refuses what the JAX package's refuses on the same layouts. The state
nests as in the JAX package, reaches a session's flush thread through
``EngineConfig(sanitize=True)`` and every rank of a launch; a corrupt
shard fails the launch."""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import debug as jdebug
from repro.core import formats as jf
from repro.core.bfs import bfs as jbfs
from repro.core.cc import cc as jcc
from repro.core.options import EngineConfig as JConfig
from repro.core.sssp import sssp as jsssp
from repro.graphs import generators as jg
from repro_torch import convert
from repro_torch.core import debug
from repro_torch.core import engine as eng
from repro_torch.core import semiring as sm
from repro_torch.core.bfs import bfs
from repro_torch.core.cc import cc
from repro_torch.core.dist_bfs import (partition_slimsell, run_cases,
                                       save_partition)
from repro_torch.core.formats import build_slimsell
from repro_torch.core.options import EngineConfig
from repro_torch.core.sssp import sssp
from repro_torch.distributed import launch
from repro_torch.graphs import generators as pg
from repro_torch.serving import GraphSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 120.0
DELTA = 1.0    # both packages' SSSP at one explicit bucket width


def _graph(g):
    return g.with_random_weights(g.kronecker(7, 8, seed=3), seed=4)


@pytest.fixture(scope="module")
def layouts():
    jt = jf.build_slimsell(_graph(jg), C=8, L=16)
    pt = build_slimsell(_graph(pg), C=8, L=16).to_torch("cpu")
    return jt, jt.to_jax(), pt


# ------------------------------------------------- sanitized == unsanitized


RUNS = {
    "bfs fused": (lambda t, c: bfs(t, 5, config=c, device="cpu"),
                  lambda j: jbfs(j, 5), ("distances", "iterations")),
    "bfs hostloop": (
        lambda t, c: bfs(t, 5, config=dataclasses.replace(c, mode="hostloop"),
                         device="cpu"),
        lambda j: jbfs(j, 5, config=JConfig(mode="hostloop")),
        ("distances", "iterations")),
    "bfs auto": (
        lambda t, c: bfs(t, 5, config=dataclasses.replace(c, direction="auto"),
                         device="cpu"),
        lambda j: jbfs(j, 5, config=JConfig(direction="auto")),
        ("distances", "iterations")),
    "packed bfs": (
        lambda t, c: bfs(t, 5, "boolean", packed=True, config=c,
                         device="cpu"),
        lambda j: jbfs(j, 5, "boolean", packed=True),
        ("distances", "iterations")),
    "sssp fused": (lambda t, c: sssp(t, 5, delta=DELTA, config=c,
                                     device="cpu"),
                   lambda j: jsssp(j, 5, delta=DELTA),
                   ("distances", "sweeps", "buckets")),
    "sssp hostloop": (
        lambda t, c: sssp(t, 5, delta=DELTA,
                          config=dataclasses.replace(c, mode="hostloop"),
                          device="cpu"),
        lambda j: jsssp(j, 5, delta=DELTA, config=JConfig(mode="hostloop")),
        ("distances", "sweeps", "buckets")),
    "cc": (lambda t, c: cc(t, config=c, device="cpu"), lambda j: jcc(j),
           ("labels", "iterations")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sanitized_runs_match_unsanitized_and_jnp(layouts, name):
    _, jt, pt = layouts
    run, jrun, fields = RUNS[name]
    was = debug.enabled()
    with debug.suspended():
        plain = run(pt, EngineConfig())
    sanitized = run(pt, EngineConfig(sanitize=True))
    with debug.checked():
        checked = run(pt, EngineConfig())
    assert debug.enabled() == was      # the config and the context restored
    want = jrun(jt)
    for f in fields:
        for got in (sanitized, checked):
            assert np.array_equal(np.asarray(getattr(got, f)),
                                  np.asarray(getattr(plain, f))), f
        assert np.array_equal(np.asarray(getattr(plain, f)),
                              np.asarray(getattr(want, f))), f


# ----------------------------------------------------------- corrupt layouts


def _first_live(t):
    return int(torch.nonzero(t.cols.reshape(-1) >= 0)[0])


def _corrupt(pt, kind):
    if kind == "col past n":
        cols = pt.cols.clone()
        cols.view(-1)[_first_live(pt)] = pt.n + 7
        return dataclasses.replace(pt, cols=cols), "out-of-bounds vertex ids"
    if kind == "col below -1":
        cols = pt.cols.clone()
        cols.view(-1)[_first_live(pt)] = -3
        return dataclasses.replace(pt, cols=cols), "ids < -1"
    if kind == "nan weight":
        w = pt.wts.clone()
        w.view(-1)[_first_live(pt)] = float("nan")
        return dataclasses.replace(pt, wts=w), "NaN/inf/negative"
    if kind == "tile_ptr past T":
        tp = pt.tile_ptr.clone()
        tp[3] = pt.n_tiles + 5
        return dataclasses.replace(pt, tile_ptr=tp), "tile_ptr"
    if kind == "row_vertex past n":
        rv = pt.row_vertex.clone()
        rv[0, 0] = pt.n + 1
        return dataclasses.replace(pt, row_vertex=rv), "row_vertex"
    cl = pt.cl.clone()                  # "cl past its tiles"
    cl[0] += pt.L * 50
    return dataclasses.replace(pt, cl=cl), "cl has 1 chunks longer"


CORRUPTIONS = ["col past n", "col below -1", "nan weight", "tile_ptr past T",
               "row_vertex past n", "cl past its tiles"]


@pytest.mark.parametrize("mode", ["fused", "hostloop"])
@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_corrupt_layout_raises_before_any_sweep(layouts, monkeypatch, kind,
                                                mode):
    _, _, pt = layouts
    bad, match = _corrupt(pt, kind)
    sweeps = []
    real = eng._sweep_once
    monkeypatch.setattr(eng, "_sweep_once",
                        lambda *a: sweeps.append(1) or real(*a))
    cfg = EngineConfig(mode=mode, sanitize=True)
    with pytest.raises(debug.SanitizerError, match=match):
        if kind == "nan weight":
            sssp(bad, 5, delta=DELTA, config=cfg, device="cpu")
        else:
            bfs(bad, 5, config=cfg, device="cpu")
    assert sweeps == []


def test_corrupt_layout_without_the_sanitizer_fails_in_the_sweep(layouts):
    # the port's plain sweeps index x with torch, which raises on the host:
    # not silent as the JAX package's clipping gather, but only at the sweep
    _, _, pt = layouts
    bad, _ = _corrupt(pt, "col past n")
    with debug.suspended():
        with pytest.raises(IndexError):
            bfs(bad, 5, slimwork=False, device="cpu")


@pytest.mark.parametrize("kind", ["col past n", "col below -1", "nan weight",
                                  "negative weight", "inf weight", "clean"])
def test_validate_layout_host_refuses_what_jax_refuses(layouts, kind):
    jt, _, _ = layouts
    cols, wts = jt.cols.copy(), jt.wts.copy()
    live = np.flatnonzero(cols.reshape(-1) >= 0)[0]
    if kind == "col past n":
        cols.reshape(-1)[live] = jt.n + 7
    elif kind == "col below -1":
        cols.reshape(-1)[live] = -3
    elif kind != "clean":
        wts.reshape(-1)[live] = {"nan weight": np.nan, "inf weight": np.inf,
                                 "negative weight": -1.0}[kind]
    jbad = dataclasses.replace(jt, cols=cols, wts=wts)
    fields = {k: getattr(jbad, k) for k in convert.LAYOUT_ARRAYS}
    meta = {k: getattr(jbad, k) for k in convert.LAYOUT_META}
    pbad = convert.tiled_from_arrays(fields, meta, device="cpu")
    try:
        jdebug.validate_layout_host(jbad)
        want = None
    except jdebug.SanitizerError as e:
        want = str(e)
    try:
        debug.validate_layout_host(pbad)
        got = None
    except debug.SanitizerError as e:
        got = str(e)
    assert got == want                   # the same refusal, the same text
    assert (want is None) == (kind == "clean")


# ------------------------------------------------------------- sweep checks


def test_check_sweep_by_reduction_kind():
    inf = float("inf")
    with debug.checked():
        debug.check_sweep(sm.TROPICAL, torch.tensor([0.0, inf]))   # identity
        debug.check_sweep(sm.SELMAX, torch.tensor([1.0, -inf]))    # max fill
        with pytest.raises(debug.SanitizerError, match="poison infinity"):
            debug.check_sweep(sm.SELMAX, torch.tensor([1.0, inf]))
        with pytest.raises(debug.SanitizerError, match="poison infinity"):
            debug.check_sweep(sm.REAL, torch.tensor([1.0, -inf]))
        with pytest.raises(debug.SanitizerError, match="NaN in tropical"):
            debug.check_sweep(sm.TROPICAL, torch.tensor([0.0, float("nan")]))
        debug.check_sweep(sm.BOOLEAN, torch.tensor([0, 1]))   # ints: nothing
        words = torch.tensor([-1, 0b11111], dtype=torch.int32)
        debug.check_sweep(sm.BOOLEAN_PACKED, words, n_bits=37)
        with pytest.raises(debug.SanitizerError, match="tail padding"):
            debug.check_sweep(sm.BOOLEAN_PACKED, words, n_bits=36)
    with debug.suspended():
        assert debug.sweep_flag(sm.REAL, torch.tensor([float("nan")])) is None
        debug.check_sweep(sm.REAL, torch.tensor([float("nan")]))


def _poisoned_spec(python_bool: bool):
    """A real-semiring spec whose sweep operand turns NaN at iteration 2;
    its update returns a device flag, or a Python bool it read itself."""
    def init_state(n, arg, device):
        return {"x": torch.ones(n, device=device)}

    def update(state, y, k):
        cont = torch.tensor(k < 4)
        return {"x": state["x"]}, bool(cont) if python_bool else cont

    return eng.FixpointSpec(
        name="poisoned", sr_name="real", init_state=init_state,
        frontier=lambda s, k: s["x"] * (float("nan") if k == 2 else 1.0),
        source_bits=lambda s, k: torch.ones_like(s["x"], dtype=torch.bool),
        host_bits=lambda s, k, a, b: (np.ones(s["x"].shape[0], bool), None),
        update=update)


@pytest.mark.parametrize("python_bool", [False, True])
@pytest.mark.parametrize("run", ["fused", "hostloop", "handle"])
def test_a_poisoned_sweep_raises_in_every_strategy(layouts, run, python_bool):
    _, _, pt = layouts
    spec = _poisoned_spec(python_bool)
    with debug.suspended():
        eng.run_fused(spec, pt, 0, max_iters=6, slimwork=False)
    with debug.checked(), pytest.raises(debug.SanitizerError,
                                        match="NaN in real-semiring"):
        if run == "fused":
            eng.run_fused(spec, pt, 0, max_iters=6, slimwork=False)
        elif run == "hostloop":
            eng.run_hostloop(spec, pt, 0, max_iters=6, slimwork=False)
        else:
            h = eng.fixpoint_handle(spec, slimwork=False, max_iters=6)
            ctx = h.setup(pt)
            h.run(pt, ctx, h.init_state(pt, 0, ctx))


def test_check_gather_catches_seeded_oob():
    table = torch.arange(8.0)
    with debug.checked():
        debug.check_gather(torch.tensor([0, 3, 7]), table.shape[0])
        with pytest.raises(debug.SanitizerError,
                           match=r"gather index out of bounds \[0, 8\)"):
            debug.check_gather(torch.tensor([0, 3, 11]), table.shape[0])
    with debug.suspended():
        debug.check_gather(torch.tensor([11]), 8)    # off: nothing read


# ------------------------------------------------------------------- state


def test_sanitizer_enable_disable_and_suspend():
    with debug.suspended():   # a REPRO_SANITIZE=1 process starts enabled
        assert not debug.enabled()
        debug.enable()
        try:
            assert debug.enabled()
            with debug.suspended():
                assert not debug.enabled()
            assert debug.enabled()  # suspension restored the enabled state
            with debug.checked():
                assert debug.enabled()
            assert debug.enabled()
        finally:
            debug.disable()
        assert not debug.enabled()


def test_sanitizer_state_is_per_thread_and_env_sets_the_default():
    seen = []
    with debug.checked():
        t = threading.Thread(target=lambda: seen.append(debug.enabled()))
        t.start()
        t.join(10)
    assert seen == [debug._DEFAULT]
    code = ("import threading; from repro_torch.core import debug; "
            "s = []; t = threading.Thread(target=lambda: "
            "s.append(debug.enabled())); t.start(); t.join(); "
            "print(debug.enabled(), s[0])")
    for env, want in (("1", "True True"), ("0", "False False")):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, REPRO_SANITIZE=env,
                                  PYTHONPATH=os.path.join(REPO, "src")))
        assert out.stdout.split() == want.split(), out.stderr


def test_engine_config_sanitize_is_validated_and_not_in_the_signature():
    assert EngineConfig(sanitize=True).signature() == \
        EngineConfig().signature() == ("push", "fused")
    with pytest.raises(ValueError, match="sanitize must be bool"):
        EngineConfig(sanitize=1)
    with debug.suspended():
        with EngineConfig(sanitize=True).applied():
            assert debug.enabled()
        assert not debug.enabled()
        with EngineConfig().applied():
            assert not debug.enabled()


@pytest.mark.parametrize("sanitize", [True, False])
def test_engine_config_sanitize_reaches_the_flush_thread(layouts, monkeypatch,
                                                         sanitize):
    _, _, pt = layouts
    calls = []
    real = debug.sweep_flag

    def spy(*a, **k):
        calls.append((threading.current_thread().name, debug.enabled()))
        return real(*a, **k)

    monkeypatch.setattr(debug, "sweep_flag", spy)
    with debug.suspended():
        with GraphSession(pt, config=EngineConfig(sanitize=sanitize),
                          background=True, device="cpu") as s:
            handles = [s.submit("bfs", r) for r in (1, 5, 9)]
            t0 = time.monotonic()   # let the flush thread take the batch
            while not any(name == "graphsession-flush" for name, _ in calls) \
                    and time.monotonic() - t0 < 30.0:
                time.sleep(0.01)
            got = [h.result() for h in handles]
        want = [bfs(pt, r, device="cpu").distances for r in (1, 5, 9)]
    for g, w in zip(got, want):
        assert np.array_equal(g.distances, w)
    flush = [on for name, on in calls if name == "graphsession-flush"]
    assert flush and set(flush) == {sanitize or debug._DEFAULT}


# ------------------------------------------------------------- distributed


@pytest.fixture(scope="module")
def dist_paths(tmp_path_factory):
    csr = pg.kronecker(7, 8, seed=3)
    root = tmp_path_factory.mktemp("dist_debug")
    good = str(root / "good")
    save_partition(partition_slimsell(csr, 2, 2, C=8, L=16, device="cpu"),
                   good)
    part = partition_slimsell(csr, 2, 2, C=8, L=16, device="cpu")
    block = part.cols[0, 1]
    block.reshape(-1)[np.flatnonzero(block.reshape(-1) >= 0)[0]] = \
        part.n_col + 3
    bad = str(root / "bad")
    save_partition(part, bad)
    return good, bad, int(np.argmax(csr.deg))


@pytest.fixture(scope="module")
def world(dist_paths):
    good, _, root = dist_paths
    cases = [dict(factory=f, partition=good, args=args, sanitize=s,
                  kwargs=kw)
             for f, args, kw in (("bfs", [root], {}),
                                 ("bfs", [root], {"direction": "auto"}),
                                 ("multi_bfs", [[root, 1, 2]], {}))
             for s in (False, True)]
    ranks = launch(run_cases, (2, 2), ("data", "model"), (cases,),
                   device="cpu", timeout=WORLD_TIMEOUT_S)
    return cases, ranks


def test_sanitized_distributed_bfs_equals_unsanitized(world, layouts):
    cases, ranks = world
    for i in range(0, len(cases), 2):
        plain, checked = ranks[0][i]["result"], ranks[0][i + 1]["result"]
        assert all(np.array_equal(a, b) for a, b in zip(plain, checked))
        assert len({r[i]["digest"] for r in ranks}
                   | {r[i + 1]["digest"] for r in ranks}) == 1


def test_a_corrupt_shard_fails_the_sanitized_launch(dist_paths):
    _, bad, root = dist_paths
    case = dict(factory="bfs", partition=bad, args=[root], kwargs={})
    with debug.checked():
        with pytest.raises(RuntimeError,
                           match="SanitizerError: SlimSell cols contains "
                                 "out-of-bounds vertex ids"):
            launch(run_cases, (2, 2), ("data", "model"), ([case],),
                   device="cpu", timeout=WORLD_TIMEOUT_S)
