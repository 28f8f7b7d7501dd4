"""The port's optimisers and tree helper against the JAX package's.

The JAX package's functions run under ``jax.jit``, as its launchers run
them: XLA then contracts ``a * b + c`` into one fused multiply-add, and the
port writes those updates so that PyTorch's CPU kernels make the same
roundings (``repro_torch/optim/optimizers.py``). The same numpy inputs,
made from a seed, go through both. Tolerances, set before any run:

* AdamW (with and without weight decay), SGD, ``clip_by_global_norm`` and
  ``global_norm``: float32 rtol 1e-6, atol 0, over 3 steps (weights,
  moments, norms);
* ``int8_compress_ef``: bit-equal (``q``'s dequantised gradient and the
  error buffer);
* Muon and ``_newton_schulz`` (bfloat16 products and sums in both, in
  another order): the orthogonalised matrices within rtol = atol = 2e-2,
  the weights within rtol 1e-2 / atol 1e-4; Muon's bfloat16 momentum and
  its AdamW leaves as AdamW's (the momentum bit-equal).

The tree helper flattens, names and rebuilds as ``jax.tree_util`` does.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import optimizers as jopts
from repro_torch import optim as popt
from repro_torch import pytree
from repro_torch.optim import optimizers as popts

RTOL = dict(rtol=1e-6, atol=0)
NS_TOL = dict(rtol=2e-2, atol=2e-2)
MUON_P_TOL = dict(rtol=1e-2, atol=1e-4)

# a tree with dict keys out of order and lists, flattened in sorted key
# order in both packages (no tuple nodes: the JAX package's optimisers take
# a tuple for the (weight, state) pair of a leaf)
SHAPES = {"top": [(5, 3), (7,)], "bot": [(4, 4)], "emb": (11, 6)}


def _tree(shapes, rng, scale=1.0):
    """numpy float32 leaves of the shapes' structure."""
    def make(s):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return jax.tree_util.tree_map(make, shapes,
                                  is_leaf=lambda x: isinstance(x, tuple)
                                  and all(isinstance(i, int) for i in x))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got_tree, want_tree, **tol):
    got = [t.detach().numpy() for t in pytree.leaves(got_tree)]
    want = _np(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------- pytree


TREES = {
    "mixed": lambda: ({"b": 1, "a": [2, (3, 4)]}, {"opt": {"m": [5, 6]}},
                      None, (7,)),
    "state": lambda: ({"w": [1, 2]}, {"opt": {"m": {"w": [3, 4]},
                                              "v": {"w": [5, 6]}},
                                      "step": 7, "ef": None}),
    "flat": lambda: [1, 2, 3],
    "leaf": lambda: 9,
    "int_keys": lambda: {3: "c", 1: "a", 2: {"z": "b", "y": None}},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_pytree_matches_jax(name):
    tree = TREES[name]()
    flat, treedef = pytree.flatten(tree)
    assert flat == jax.tree_util.tree_leaves(tree)
    assert repr(treedef) == str(jax.tree_util.tree_structure(tree))
    pairs = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = [re.sub(r"[^A-Za-z0-9_.-]", "_", jax.tree_util.keystr(p))
            for p, _ in pairs]
    assert pytree.leaf_names(tree) == want
    assert pytree.unflatten(treedef, flat) == tree
    doubled = pytree.tree_map(lambda x: x * 2, tree)
    assert doubled == jax.tree_util.tree_map(lambda x: x * 2, tree)


def test_pytree_names_the_issue_example():
    tree = ({"w": [0]}, {"opt": {"m": [1]}})
    assert pytree.leaf_names(tree)[1] == "_1___opt____m___0_"


def test_pytree_guards():
    _, treedef = pytree.flatten({"a": 1, "b": 2})
    with pytest.raises(ValueError, match="holds 2 leaves"):
        pytree.unflatten(treedef, [1])
    with pytest.raises(ValueError, match="structures differ"):
        pytree.tree_map(lambda a, b: a, {"a": 1}, {"b": 1})
    is_state = lambda x: isinstance(x, dict) and set(x) == {"m"}
    assert pytree.leaves([{"m": 1}, {"m": 2}], is_leaf=is_state) == \
        [{"m": 1}, {"m": 2}]


# ----------------------------------------------------- norm and clip


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_global_norm_and_clip(max_norm):
    rng = np.random.default_rng(int(max_norm * 10) % 7)
    tree = _tree(SHAPES, rng, 0.2)
    want_n = float(jax.jit(jopt.global_norm)(_to_jax(tree)))
    got_n = popt.global_norm(_to_torch(tree))
    assert got_n.dtype == torch.float32 and got_n.shape == ()
    np.testing.assert_allclose(float(got_n), want_n, **RTOL)
    want_t, want_g = jax.jit(lambda t: jopt.clip_by_global_norm(t, max_norm))(
        _to_jax(tree))
    ptree = _to_torch(tree)
    leaves = pytree.leaves(ptree)
    got_t, got_g = popt.clip_by_global_norm(ptree, max_norm)
    assert all(a is b for a, b in zip(pytree.leaves(got_t), leaves))  # in place
    np.testing.assert_allclose(float(got_g), float(want_g), **RTOL)
    _close(got_t, want_t, **RTOL)
    if max_norm >= want_n:
        _close(got_t, _to_jax(tree), rtol=0, atol=0)


# -------------------------------------------------------- AdamW and SGD


def _run_both(jopt_obj, popt_obj, params, grads_per_step, state_cmp):
    """Three updates in both packages on the same grads; returns both."""
    jp = _to_jax(params)
    js = jopt_obj.init(jp)
    upd = jax.jit(jopt_obj.update)
    pp = _to_torch(params)
    ps = popt_obj.init(pp)
    p_leaves = pytree.leaves(pp)
    for i, g in enumerate(grads_per_step):
        jp, js = upd(_to_jax(g), js, jp, jnp.int32(i))
        out_p, out_s = popt_obj.update(_to_torch(g), ps, pp,
                                       torch.tensor(i, dtype=torch.int32))
        assert out_p is pp and out_s is ps  # in place
        _close(pp, jp, **MUON_P_TOL if state_cmp == "muon" else RTOL)
    assert all(a is b for a, b in zip(pytree.leaves(pp), p_leaves))
    return jp, js, pp, ps


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr,b1,b2", [(3e-4, 0.9, 0.95), (1e-2, 0.8, 0.999)])
def test_adamw_three_steps(lr, b1, b2, weight_decay):
    rng = np.random.default_rng([7, int(weight_decay * 10)])
    params = _tree(SHAPES, rng)
    grads = [_tree(SHAPES, rng, 0.3) for _ in range(3)]
    kw = dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay)
    _, js, pp, ps = _run_both(jopt.adamw(**kw), popt.adamw(**kw), params,
                              grads, "adamw")
    assert set(ps) == set(js) == {"m", "v"}
    _close(ps["m"], js["m"], **RTOL)
    _close(ps["v"], js["v"], **RTOL)


@pytest.mark.parametrize("lr,momentum", [(1e-2, 0.9), (0.1, 0.5)])
def test_sgd_three_steps(lr, momentum):
    rng = np.random.default_rng(int(lr * 100))
    params = _tree(SHAPES, rng)
    grads = [_tree(SHAPES, rng, 0.3) for _ in range(3)]
    _, js, _, ps = _run_both(jopt.sgd(lr, momentum), popt.sgd(lr, momentum),
                             params, grads, "sgd")
    _close(ps, js, **RTOL)


def test_adamw_state_layout():
    params = _to_torch(_tree(SHAPES, np.random.default_rng(0)))
    st = popt.adamw().init(params)
    want = jopt.adamw().init(_to_jax(_tree(SHAPES, np.random.default_rng(0))))
    assert repr(pytree.flatten(st)[1]) == str(jax.tree_util.tree_structure(want))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in pytree.leaves(st))


# ------------------------------------------------------------ compress


@pytest.mark.parametrize("with_error", [False, True])
def test_int8_compress_ef_bit_equal(with_error):
    rng = np.random.default_rng([11, with_error])
    grads = _tree(SHAPES, rng)
    grads["emb"] *= 1e-4   # a leaf of small values: its own scale
    error = _tree(SHAPES, rng, 1e-2) if with_error else None
    jd, je = jax.jit(jopt.int8_compress_ef)(
        _to_jax(grads), None if error is None else _to_jax(error))
    pg = _to_torch(grads)
    pe = None if error is None else _to_torch(error)
    gd, ge = popt.int8_compress_ef(pg, pe)
    assert gd is pg and (pe is None or ge is pe)
    _close(gd, jd, rtol=0, atol=0)
    _close(ge, je, rtol=0, atol=0)
    for g in pytree.leaves(gd):  # at most 255 levels a leaf
        assert torch.unique(g).numel() <= 255


def test_int8_compress_ef_three_steps_carry_the_error():
    rng = np.random.default_rng(12)
    grads = [_tree(SHAPES, rng) for _ in range(3)]
    je = pe = None
    comp = jax.jit(jopt.int8_compress_ef)
    for g in grads:
        jd, je = comp(_to_jax(g), je)
        pd, pe = popt.int8_compress_ef(_to_torch(g), pe)
        _close(pd, jd, rtol=0, atol=0)
        _close(pe, je, rtol=0, atol=0)


# ---------------------------------------------------------------- Muon


@pytest.mark.parametrize("shape", [(3, 64, 32), (2, 16, 48), (1, 8, 8)])
def test_newton_schulz_matches_jnp(shape):
    G = np.random.default_rng(list(shape)).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(jax.jit(jopts._newton_schulz)(jnp.asarray(G)))
    got = popts._newton_schulz(torch.from_numpy(G))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, **NS_TOL)
    # orthogonal rows (or columns) to bfloat16's precision
    small = min(shape[-2:])
    gram = got @ got.transpose(-1, -2) if shape[-2] <= shape[-1] \
        else got.transpose(-1, -2) @ got
    assert gram.shape[-1] == small


MUON_SHAPES = {"stack": (3, 64, 32), "wide": (2, 16, 48), "w2d": (10, 6),
               "bias": (7,)}


def test_muon_three_steps():
    rng = np.random.default_rng(13)
    params = _tree(MUON_SHAPES, rng, 0.1)
    grads = [_tree(MUON_SHAPES, rng, 0.3) for _ in range(3)]
    _, js, _, ps = _run_both(jopt.muon(), popt.muon(), params, grads, "muon")
    is_state = lambda x: isinstance(x, dict) and set(x) == {"mom", "m", "v"}
    assert sorted(ps) == sorted(js)
    for k in MUON_SHAPES:
        got, want = ps[k], js[k]
        assert is_state(got)
        mom = np.asarray(want["mom"]).astype(np.float32)
        assert got["mom"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["mom"].float().numpy(), mom)
        for part in ("m", "v"):
            assert got[part].dtype == torch.float32
            np.testing.assert_allclose(got[part].numpy(),
                                       np.asarray(want[part]), **RTOL)


def test_muon_state_layout():
    params = _to_torch(_tree(MUON_SHAPES, np.random.default_rng(0)))
    st = popt.muon().init(params)
    want = jopt.muon().init(_to_jax(_tree(MUON_SHAPES,
                                          np.random.default_rng(0))))
    assert repr(pytree.flatten(st)[1]) == str(jax.tree_util.tree_structure(want))
    for got, w in zip(pytree.leaves(st), jax.tree_util.tree_leaves(want)):
        assert tuple(got.shape) == w.shape
        assert str(got.dtype).split(".")[-1] == str(w.dtype)
