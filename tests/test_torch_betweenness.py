"""The port's Brandes betweenness against the JAX package's fused jnp run
and the independent oracles of ``tests/oracles.py``, on the plain (CPU)
sweeps, at three layouts: (C, L) = (8, 32), (4, 8) and (1, 1).

Tolerances, fixed before any comparison was run:

* the forward sweep's depths ``d`` and path counts ``sigma``, and the
  iterations (forward plus backward sweeps), bit-equal to the JAX
  package's: on these graphs every count and every partial sum is a whole
  number below 2^24, which float32 adds exactly in any order;
* scores within rtol 1e-5 and atol 1e-6 x the JAX package's largest
  score: the backward fractions ``(1 + delta) / sigma`` are float32 sums
  taken in another order;
* scores within ``TOLERANCES["betweenness"]`` of the plain-python Brandes
  ``betweenness_oracle``, and normalised scores of networkx's;
* batched against one batch within rtol 1e-6, atol 1e-9 (the float64
  folds group differently), as ``tests/test_workloads.py`` holds the
  JAX package.

The port's fused and hostloop runs use the same sweeps over the same tile
sets, so they are compared bit for bit. The JAX package's hostloop is no
reference with SlimWork (it pads its tile list with repeats of the last
kept tile, which the real semiring adds again): the port's hostloop is
held against the oracle and the port's fused run.
"""
import functools
import types

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import formats as jf
from repro.core.betweenness import BRANDES_FORWARD_SPEC as J_FORWARD
from repro.core.betweenness import betweenness as jbetweenness
from repro.core.betweenness import brandes_accumulate as j_accumulate
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch.core import engine as peng
from repro_torch.core import formats as pf
from repro_torch.core.betweenness import (BRANDES_FORWARD_SPEC,
                                          betweenness, brandes_accumulate)
from repro_torch.core.options import EngineConfig
from repro_torch.graphs import generators as pg

from oracles import TOLERANCES, betweenness_oracle, to_networkx

MODES = ["fused", "hostloop"]
LAYOUTS = [(8, 32), (4, 8), (1, 1)]
LAYOUT_IDS = [f"C{c}L{l}" for c, l in LAYOUTS]


def path_graph(formats, n: int):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return formats.build_csr(edges, n)


def mixed_graph(formats):
    """A path of 10, a star of 6 and 4 isolated vertices (n = 20)."""
    edges = [(i, i + 1) for i in range(9)] + [(10, j) for j in range(11, 16)]
    return formats.build_csr(np.asarray(edges, np.int64), 20)


# ``tests/test_workloads.py``'s families, built by either package
FAMILIES = {
    "kron": lambda g, f: g.kronecker(9, 8, seed=3),
    "er": lambda g, f: g.erdos_renyi(256, 6, seed=1),
    "ring": lambda g, f: g.ring_of_cliques(10, 5),
    "star": lambda g, f: g.star(100),
    "path": lambda g, f: path_graph(f, 64),
    "disconnected": lambda g, f: g.two_components(6, 6, seed=0),
    "mixed": lambda g, f: mixed_graph(f),
}
#: families small enough for all sources (exact BC)
SMALL = ("ring", "star", "path", "disconnected")
#: the sources of the mixed graph: an isolated root, a duplicate, roots of
#: eccentricity 9, 5, 1 and 2, and an isolated root last; with a batch of 4
#: the last batch is padded by repeating its last root
MIXED_SOURCES = [16, 0, 4, 10, 0, 11, 19]


@functools.lru_cache(maxsize=None)
def csrs(name):
    """(JAX package's CSR, port's CSR): the generators are copies."""
    jcsr, pcsr = FAMILIES[name](jg, jf), FAMILIES[name](pg, pf)
    assert np.array_equal(jcsr.indptr, pcsr.indptr)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    return jcsr, pcsr


def layouts(name, layout, jax=True):
    """(port CSR, JAX layout or None, port layout on the CPU)."""
    C, L = layout
    jcsr, pcsr = csrs(name)
    jt = jf.build_slimsell(jcsr, C=C, L=L).to_jax() if jax else None
    return pcsr, jt, pf.build_slimsell(pcsr, C=C, L=L).to_torch("cpu")


def sources_of(name, csr):
    """None (all sources) on the small families, else 16 sampled."""
    if name in SMALL:
        return None
    rng = np.random.default_rng(0)
    return np.sort(rng.choice(csr.n, size=16, replace=False))


def assert_close_to_jax(got, want):
    assert got.iterations == want.iterations
    assert got.n_sources == want.n_sources
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                               atol=1e-6 * want.scores.max())


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", sorted(set(FAMILIES) - {"mixed"}))
def test_matches_jax_and_oracle(name, layout):
    csr, jt, pt = layouts(name, layout)
    src = sources_of(name, csr)
    roots = np.arange(csr.n) if src is None else src
    # the forward sweep alone: depths and path counts bit for bit
    want_fwd = jeng.run_fused(J_FORWARD, jt, jnp.asarray(roots, jnp.int32),
                              max_iters=csr.n + 1)
    got_fwd = peng.run_fused(BRANDES_FORWARD_SPEC, pt,
                             torch.from_numpy(roots), max_iters=csr.n + 1)
    assert got_fwd.iterations == want_fwd.iterations
    np.testing.assert_array_equal(got_fwd.state["d"].numpy(),
                                  np.asarray(want_fwd.state["d"]))
    sigma = got_fwd.state["sigma"].numpy()
    np.testing.assert_array_equal(sigma, np.asarray(want_fwd.state["sigma"]))
    assert sigma.max() < 2 ** 24
    want = jbetweenness(jt, sources=src, config=JConfig(backend="jnp"))
    got = betweenness(pt, sources=src, device="cpu")
    assert got.scores.dtype == np.float64 and got.scores.shape == (csr.n,)
    assert_close_to_jax(got, want)
    np.testing.assert_allclose(got.scores, betweenness_oracle(csr, src),
                               **TOLERANCES["betweenness"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_hostloop_slimwork_equals_fused_and_oracle(name, layout):
    """With SlimWork: the port's hostloop == its fused run bit for bit, and
    both within the oracle's tolerances (the JAX package's hostloop is not
    the reference here)."""
    csr, _, pt = layouts(name, layout, jax=False)
    src = MIXED_SOURCES if name == "mixed" else sources_of(name, csr)
    fused, host = (betweenness(pt, sources=src, batch_size=5,
                               config=EngineConfig(mode=m), device="cpu")
                   for m in MODES)
    assert host.iterations == fused.iterations
    np.testing.assert_array_equal(host.scores, fused.scores)
    np.testing.assert_allclose(host.scores, betweenness_oracle(csr, src),
                               **TOLERANCES["betweenness"])


@pytest.mark.parametrize("name", SMALL)
def test_normalized_matches_networkx(name):
    csr, jt, pt = layouts(name, LAYOUTS[0])
    ref = nx.betweenness_centrality(to_networkx(csr), normalized=True)
    got = betweenness(pt, normalized=True, device="cpu")
    np.testing.assert_allclose(got.scores, [ref[v] for v in range(csr.n)],
                               **TOLERANCES["betweenness"])
    assert_close_to_jax(got, jbetweenness(jt, normalized=True,
                                          config=JConfig(backend="jnp")))


@pytest.mark.parametrize("slimwork", [True, False], ids=["slimwork", "all"])
@pytest.mark.parametrize("mode", MODES)
def test_batched_equals_monolithic(mode, slimwork):
    csr, jt, pt = layouts("ring", LAYOUTS[0])
    cfg = EngineConfig(mode=mode)
    whole = betweenness(pt, slimwork=slimwork, config=cfg, device="cpu")
    for batch_size in (16, 5):
        chunked = betweenness(pt, batch_size=batch_size, slimwork=slimwork,
                              config=cfg, device="cpu")
        np.testing.assert_allclose(chunked.scores, whole.scores, rtol=1e-6,
                                   atol=1e-9)
        # the JAX package's fused run, batched the same way
        assert_close_to_jax(chunked, jbetweenness(
            jt, batch_size=batch_size, slimwork=slimwork,
            config=JConfig(backend="jnp")))
    np.testing.assert_allclose(whole.scores, betweenness_oracle(csr),
                               **TOLERANCES["betweenness"])


@pytest.mark.parametrize("slimwork", [True, False], ids=["slimwork", "all"])
@pytest.mark.parametrize("mode", MODES)
def test_isolated_padded_and_duplicate_sources(mode, slimwork):
    """Columns whose root is isolated (inert from the start, yet the
    backward run still takes its first sweep), a batch of mixed
    eccentricities, a padded last batch and a source given twice (counted
    twice): iterations equal the JAX package's fused run."""
    csr, jt, pt = layouts("mixed", LAYOUTS[1])
    cfg, jcfg = EngineConfig(mode=mode), JConfig(backend="jnp")
    for src, batch_size in ((MIXED_SOURCES, 4), (MIXED_SOURCES, None),
                            ([16], None), ([16, 19], 1)):
        got = betweenness(pt, sources=src, batch_size=batch_size,
                          slimwork=slimwork, config=cfg, device="cpu")
        want = jbetweenness(jt, sources=src, batch_size=batch_size,
                            slimwork=slimwork, config=jcfg)
        assert_close_to_jax(got, want)
        np.testing.assert_allclose(got.scores, betweenness_oracle(csr, src),
                                   **TOLERANCES["betweenness"])
    # an isolated root alone: one forward and one backward sweep
    assert betweenness(pt, sources=[16], config=cfg,
                       device="cpu").iterations == 2
    # the duplicate counts twice: 0 given twice == 0 once, doubled
    twice = betweenness(pt, sources=[0, 0], config=cfg, device="cpu").scores
    once = betweenness(pt, sources=[0], config=cfg, device="cpu").scores
    np.testing.assert_array_equal(twice, 2 * once)


def test_max_iters_caps_each_run():
    csr, jt, pt = layouts("path", LAYOUTS[0])
    for cap in (1, 3):
        got = betweenness(pt, sources=[0, 30], max_iters=cap, device="cpu")
        assert got.iterations == 2 * cap
        assert_close_to_jax(got, jbetweenness(
            jt, sources=[0, 30], max_iters=cap, config=JConfig(backend="jnp")))


def _raised(fn, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


def test_validation_order_and_messages():
    """The JAX package's checks in its order, with its messages: the
    direction, SlimWork's push index, n past 2^24, empty sources, sources
    out of range; each case also breaks every later rule."""
    _, jt, pt = layouts("path", LAYOUTS[0])
    no_index = types.SimpleNamespace(n=64, inc_src=None)
    too_big = types.SimpleNamespace(n=2 ** 24 + 1, inc_src=np.zeros(1))
    cases = [
        ((pt, jt), dict(sources=[], config="pull"), "push-only"),
        ((no_index, no_index), dict(sources=[]), "push index"),
        ((too_big, too_big), dict(sources=[]), "2^24"),
        ((pt, jt), dict(sources=[]), "non-empty"),
        ((pt, jt), dict(sources=[64]), "out of range"),
        ((pt, jt), dict(sources=[-1, 3]), "out of range"),
    ]
    for (port_t, jax_t), kw, needle in cases:
        pkw, jkw = dict(kw), dict(kw)
        if kw.get("config") == "pull":
            pkw["config"] = EngineConfig(direction="pull")
            jkw["config"] = JConfig(direction="pull")
        msg = _raised(betweenness, port_t, device="cpu", **pkw)
        assert msg == _raised(jbetweenness, jax_t, **jkw)
        assert needle in msg
    # without SlimWork no push index is needed
    no_index_layout = pf.build_slimsell(csrs("path")[1], C=8, L=32)
    no_index_layout.inc_src = None
    got = betweenness(no_index_layout, sources=[0], slimwork=False,
                      device="cpu")
    np.testing.assert_allclose(got.scores, betweenness_oracle(
        csrs("path")[1], [0]), **TOLERANCES["betweenness"])


def test_brandes_accumulate_matches_jax():
    rng = np.random.default_rng(26)
    delta = rng.random((30, 6)).astype(np.float32)
    roots = np.array([3, 7, 7, 0, 29, 29])
    for n_real in (None, 6, 4):
        want = j_accumulate(delta, roots, n_real=n_real)
        np.testing.assert_array_equal(
            brandes_accumulate(torch.from_numpy(delta), roots, n_real=n_real),
            want)
        np.testing.assert_array_equal(
            brandes_accumulate(delta, roots, n_real=n_real), want)
