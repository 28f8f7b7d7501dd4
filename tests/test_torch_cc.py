"""The port's connected components against the JAX package's jnp path and
scipy, on the plain (CPU) sweeps.

Both packages build their layout from the same CSR (the generators are
copies). Sel-max label propagation and boolean peeling (lane and packed,
push / pull / auto) in both engine modes give bit-equal labels, component
counts, iterations and work logs; the count equals scipy's. The behaviour
tests of ``tests/test_cc.py`` are ported, with the checks at the entry.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

from repro.core import formats as jf
from repro.core.cc import cc as jcc
from repro.core.options import EngineConfig as JConfig
from repro.graphs import generators as jg
from repro_torch.core import formats as pf
from repro_torch.core.cc import cc
from repro_torch.core.options import CC_SEMIRINGS, EngineConfig
from repro_torch.graphs import generators as pg

from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

MODES = ["fused", "hostloop"]
# (direction, packed) of the peeling BFSes; packed runs push only
PEELING = [("push", False), ("pull", False), ("auto", False), ("push", True)]


def path_graph(formats, n: int):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return formats.build_csr(edges, n)


def edgeless(formats, n: int):
    return formats.build_csr(np.empty((0, 2), np.int64), n)


# ``tests/test_cc.py``'s families, built by either package
FAMILIES = {
    "kron": lambda g, f: g.kronecker(9, 8, seed=1),
    "er_sparse": lambda g, f: g.erdos_renyi(512, 1.5, seed=2),
    "disconnected": lambda g, f: g.two_components(7, 8, seed=0),
    "star": lambda g, f: g.star(64),
    "path": lambda g, f: path_graph(f, 96),
    "edgeless": lambda g, f: edgeless(f, 37),
}


@functools.lru_cache(maxsize=None)
def family(name):
    """(port CSR, JAX layout, port layout on the CPU), built once."""
    jcsr, pcsr = FAMILIES[name](jg, jf), FAMILIES[name](pg, pf)
    assert np.array_equal(jcsr.indices, pcsr.indices)
    return (pcsr, jf.build_slimsell(jcsr, C=8, L=32).to_jax(),
            pf.build_slimsell(pcsr, C=8, L=32).to_torch("cpu"))


def scipy_count(csr) -> int:
    A = csr_matrix((np.ones(csr.nnz, np.int8), csr.indices, csr.indptr),
                   shape=(csr.n, csr.n))
    return connected_components(A, directed=False)[0]


def assert_canonical(labels):
    """labels[v] is the largest vertex id of v's component."""
    for rep in np.unique(labels):
        assert np.nonzero(labels == rep)[0].max() == rep


def test_cc_semirings_match_jax_package():
    from repro.core.options import CC_SEMIRINGS as J_CC_SEMIRINGS
    assert CC_SEMIRINGS == J_CC_SEMIRINGS == ("selmax", "boolean")


# ------------------------------------------------------------ against repro


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_labelprop_matches_jax(name, mode):
    csr, jt, pt = family(name)
    want = jcc(jt, semiring="selmax", log_work=True,
               config=JConfig(mode=mode, backend="jnp"))
    got = cc(pt, semiring="selmax", log_work=True,
             config=EngineConfig(mode=mode), device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int32
    assert (got.n_components, got.iterations) == (want.n_components,
                                                  want.iterations)
    np.testing.assert_array_equal(got.work_log, want.work_log)
    assert got.n_components == scipy_count(csr)
    assert_canonical(got.labels)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_labelprop_work_log_fused_equals_hostloop(name):
    _, _, pt = family(name)
    fused, host = (cc(pt, log_work=True, config=EngineConfig(mode=m),
                      device="cpu") for m in MODES)
    assert fused.iterations == host.iterations
    np.testing.assert_array_equal(fused.work_log, host.work_log)
    np.testing.assert_array_equal(fused.labels, host.labels)


@pytest.mark.parametrize("direction,packed", PEELING,
                         ids=[f"{d}{'-packed' if p else ''}"
                              for d, p in PEELING])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_boolean_peeling_matches_jax(name, mode, direction, packed):
    csr, jt, pt = family(name)
    want = jcc(jt, semiring="boolean", packed=packed,
               config=JConfig(mode=mode, backend="jnp", direction=direction))
    got = cc(pt, semiring="boolean", packed=packed,
             config=EngineConfig(mode=mode, direction=direction),
             device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.n_components, got.iterations) == (want.n_components,
                                                  want.iterations)
    assert got.work_log is None and want.work_log is None
    assert got.n_components == scipy_count(csr)
    # the same canonical labels as label propagation
    np.testing.assert_array_equal(got.labels,
                                  cc(pt, device="cpu").labels)


# --------------------------------------------------------------- behaviour


def test_single_node():
    pt = pf.build_slimsell(edgeless(pf, 1), C=8, L=32).to_torch("cpu")
    for semiring in CC_SEMIRINGS:
        res = cc(pt, semiring=semiring, device="cpu")
        assert res.labels.tolist() == [0] and res.n_components == 1


def test_slimwork_log_shrinks():
    _, _, pt = family("kron")
    res = cc(pt, config=EngineConfig(mode="hostloop"), log_work=True,
             device="cpu")
    assert res.work_log is not None and len(res.work_log) == res.iterations
    # the last sweep touches no more tiles than the first (fixpoint tail)
    assert res.work_log[-1] <= res.work_log[0]


def test_no_slimwork_matches():
    _, jt, pt = family("er_sparse")
    a = cc(pt, slimwork=False, log_work=True, device="cpu")
    b = cc(pt, slimwork=True, device="cpu")
    np.testing.assert_array_equal(a.labels, b.labels)
    # without SlimWork the fused work log holds zeros, as the JAX package's
    want = jcc(jt, slimwork=False, log_work=True,
               config=JConfig(backend="jnp"))
    np.testing.assert_array_equal(a.work_log, want.work_log)


def test_bad_semiring_rejected():
    _, jt, pt = family("star")
    for fn, t, kw in ((cc, pt, {"device": "cpu"}), (jcc, jt, {})):
        with pytest.raises(ValueError, match="cc semiring"):
            fn(t, semiring="tropical", **kw)


def test_iterations_bounded_by_diameter():
    pt = pf.build_slimsell(path_graph(pf, 64), C=8, L=32).to_torch("cpu")
    res = cc(pt, device="cpu")
    # label prop moves the max id one hop per sweep: diameter(+1) sweeps
    assert res.iterations <= 65


def test_max_iters_caps_label_propagation():
    _, jt, pt = family("path")
    want = jcc(jt, max_iters=5, config=JConfig(backend="jnp"))
    got = cc(pt, max_iters=5, device="cpu")
    assert got.iterations == want.iterations == 5
    np.testing.assert_array_equal(got.labels, want.labels)


# ---------------------------------------------------------- entry checks


def test_float32_guard_on_huge_layouts():
    """Labels ride float32 in the sel-max payload: n above 2^24 raises
    before the layout is touched (a stub stands in for a huge layout)."""
    stub = types.SimpleNamespace(n=(1 << 24) + 1, inc_src=np.zeros(1))
    with pytest.raises(ValueError, match="float32"):
        cc(stub, semiring="selmax", device="cpu")


@pytest.mark.parametrize("case", ["packed_selmax", "pull_selmax",
                                  "no_push_index"])
def test_entry_checks_match_jax(case):
    _, jt, pt = family("star")
    kw = {"packed_selmax": dict(semiring="selmax", packed=True),
          "pull_selmax": dict(semiring="selmax"),
          "no_push_index": dict(semiring="boolean")}[case]
    match = {"packed_selmax": "packed=True", "pull_selmax": "push-only",
             "no_push_index": "push index"}[case]
    direction = "pull" if case == "pull_selmax" else "push"
    if case == "no_push_index":
        pt = dataclasses.replace(pt, inc_src=None)
        jt = dataclasses.replace(jt, inc_src=None)
    with pytest.raises(ValueError, match=match):
        cc(pt, config=EngineConfig(direction=direction), device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jcc(jt, config=JConfig(direction=direction, backend="jnp"), **kw)


def test_packed_pull_raises_like_jax():
    """Packed peeling is push only: the first peeling BFS raises."""
    _, jt, pt = family("star")
    with pytest.raises(ValueError, match="push-only"):
        cc(pt, semiring="boolean", packed=True,
           config=EngineConfig(direction="pull"), device="cpu")
    with pytest.raises(ValueError, match="push-only"):
        jcc(jt, semiring="boolean", packed=True,
            config=JConfig(direction="pull", backend="jnp"))
