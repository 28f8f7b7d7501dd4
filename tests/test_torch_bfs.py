"""The port's BFS and multi-source BFS (plain path, CPU) against the JAX
package's jnp path: distances, parents, iterations and work logs equal.
Push-direction parents are deterministic (a max over ids), so they are
compared exactly too."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bfs as jbfs
from repro.core import engine as jeng
from repro.core import formats as jf
from repro.core import multi_bfs as jmulti
from repro.graphs import generators as jg
from repro_torch import convert
from repro_torch.core import bfs as pbfs
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core import multi_bfs as pmulti
from repro_torch.core.options import EngineConfig
from repro_torch.graphs import generators as pg

SEMIRINGS = ["tropical", "real", "boolean", "selmax"]
GRAPHS = {"kron": lambda g: g.kronecker(8, 8, seed=1),
          "two": lambda g: g.two_components(6, 6, seed=4)}


def _layouts(graph):
    jt = jf.build_slimsell(GRAPHS[graph](jg), C=8, L=16)
    pt = pf.build_slimsell(GRAPHS[graph](pg), C=8, L=16)
    return jt.to_jax(), pt.to_torch("cpu")


@pytest.fixture(scope="module")
def kron():
    return _layouts("kron")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_bfs_matches_jnp(kron, name):
    jt, pt = kron
    want = jbfs.bfs(jt, 5, name, need_parents=True, log_work=True)
    got = pbfs.bfs(pt, 5, name, need_parents=True, log_work=True, device="cpu")
    assert got.iterations == want.iterations
    for f in ("distances", "parents", "work_log"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("slimwork,max_iters", [(False, None), (True, 2)])
def test_bfs_options_match_jnp(slimwork, max_iters):
    """An unreachable component, no SlimWork, and a capped iteration count."""
    jt, pt = _layouts("two")
    want = jbfs.bfs(jt, 3, "tropical", need_parents=True, log_work=True,
                    slimwork=slimwork, max_iters=max_iters)
    got = pbfs.bfs(pt, 3, "tropical", need_parents=True, log_work=True,
                   slimwork=slimwork, max_iters=max_iters, device="cpu")
    assert (got.distances < 0).any()  # the other component
    assert got.iterations == want.iterations
    for f in ("distances", "parents", "work_log"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", SEMIRINGS)
def test_multi_source_bfs_matches_jnp(kron, name):
    """Five roots in batches of three: the second batch is padded."""
    jt, pt = kron
    roots = [5, 17, 40, 99, 200]
    want = jmulti.multi_source_bfs(jt, roots, name, need_parents=True,
                                   log_work=True, batch_size=3)
    got = pmulti.multi_source_bfs(pt, roots, name, need_parents=True,
                                  log_work=True, batch_size=3, device="cpu")
    assert got.work_log.shape == want.work_log.shape == (2, peng.WORK_LOG)
    for f in ("distances", "parents", "iterations", "roots", "work_log"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", SEMIRINGS)
def test_one_step_from_carried_state(kron, name):
    """Iteration 3 run by the port from the JAX package's state after two
    iterations gives the JAX package's state after three."""
    jt, pt = kron
    spec = jbfs.bfs_spec(name)
    before = jeng.run_fused(spec, jt, jnp.asarray(5, jnp.int32), max_iters=2)
    after = jeng.run_fused(spec, jt, jnp.asarray(5, jnp.int32), max_iters=3,
                           log_work=True)
    assert before.iterations == 2 and after.iterations == 3
    state = convert.state_from_arrays(
        {k: np.asarray(v) for k, v in before.state.items()}, device="cpu")
    got, cont, used = peng.step(pbfs.bfs_spec(name), pt, state, 3)
    assert bool(cont)
    assert int(used) == int(after.work_log[2])  # active tiles of iteration 3
    assert sorted(got) == sorted(after.state)
    for k, v in after.state.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert np.array_equal(pbfs._not_final(name, got).numpy(),
                          np.asarray(jbfs._not_final(name, after.state)))


def test_front_doors_reject_bad_options(kron):
    _, pt = kron
    with pytest.raises(KeyError):
        pbfs.bfs(pt, 0, "minplus", device="cpu")
    with pytest.raises(ValueError, match="direction"):
        pbfs.bfs(pt, 0, config=EngineConfig(direction="sideways"),
                 device="cpu")
    with pytest.raises(ValueError, match="root"):
        pbfs.bfs(pt, pt.n, device="cpu")
    with pytest.raises(ValueError, match="roots"):
        pmulti.multi_source_bfs(pt, [0, -1], device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        pmulti.multi_source_bfs(pt, [0], batch_size=0, device="cpu")
