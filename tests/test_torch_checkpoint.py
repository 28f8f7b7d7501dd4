"""The port's checkpoint store against the JAX package's, on disk.

Both write ``step_<N:010d>/`` with one ``.npy`` a leaf under the same
names and a ``manifest.json``, so a checkpoint crosses between them:
every tensor restored is bit-equal to what was saved (no tolerance), in
either direction, for AdamW and SGD train states; a resumed CPU run is
bit-equal to an uninterrupted one. bfloat16 leaves (Muon's momentum) are
stored by the port as their uint16 bits, which the JAX package reads back
as uint16; the port reads the JAX package's own bfloat16 files (void
``|V2`` to NumPy without ``ml_dtypes``) as bfloat16.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import store as jstore
from repro.train import make_train_step as jmake_train_step
from repro_torch import optim as popt
from repro_torch import pytree
from repro_torch.checkpoint import store as pstore
from repro_torch.models import gnn as pgnn
from repro_torch.train import make_train_step


def _torch_tree(rng):
    return ({"w": [torch.from_numpy(rng.standard_normal((4, 3)).astype(
                np.float32)), torch.arange(5, dtype=torch.int32)],
             "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))},
            {"opt": {"mom": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(
                np.float32)).to(torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32)})


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def _same_tree(a, b):
    la, da = pytree.flatten(a)
    lb, db = pytree.flatten(b)
    assert da == db
    assert all(_bits_equal(x, y) for x, y in zip(la, lb))


def test_round_trip_bit_equal(tmp_path):
    tree = _torch_tree(np.random.default_rng(0))
    path = pstore.save(str(tmp_path), 7, tree, metadata={"seed": 3})
    assert os.path.basename(path) == "step_0000000007"
    got, meta = pstore.restore(str(tmp_path), 7, tree, device="cpu")
    assert meta == {"seed": 3}
    _same_tree(got, tree)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    dtypes = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    assert dtypes["_1___opt____mom__"] == "bfloat16"
    assert np.load(os.path.join(path, "_1___opt____mom__.npy")).dtype == np.uint16
    assert sorted(dtypes) == sorted(pytree.leaf_names(tree))
    assert manifest["step"] == 7
    assert manifest["treedef"] == repr(pytree.flatten(tree)[1])


def test_restore_wants_a_card_by_default(tmp_path, monkeypatch):
    tree = _torch_tree(np.random.default_rng(1))
    pstore.save(str(tmp_path), 1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pstore.restore(str(tmp_path), 1, tree)


def test_keep_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert pstore.latest_step(d) is None
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 10, 5):
        pstore.save(d, s, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_0000000005", "step_0000000010"]
    assert pstore.latest_step(d) == 10
    assert jstore.latest_step(d) == 10


def test_interrupted_save_stays_invisible(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    pstore.save(d, 4, tree)
    # a save killed before its rename: files but no complete step
    tmp = os.path.join(d, "step_0000000005.tmp")
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "_a__.npy"), np.ones(3, np.float32))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        f.write("{")
    # and a step directory whose manifest was never written
    os.makedirs(os.path.join(d, "step_0000000006"))
    assert pstore.latest_step(d) == 4 == jstore.latest_step(d)
    pstore.save(d, 5, {"a": torch.full((3,), 2.0), "b": [torch.ones(2)]})
    assert not os.path.exists(tmp) and pstore.latest_step(d) == 6 - 1
    got, _ = pstore.restore(d, 5, tree, device="cpu")
    assert torch.equal(got["a"], torch.full((3,), 2.0))


def test_restore_names_missing_leaves(tmp_path):
    pstore.save(str(tmp_path), 1, {"a": torch.ones(1)})
    with pytest.raises(KeyError, match="_b__"):
        pstore.restore(str(tmp_path), 1, {"a": 0, "b": 0}, device="cpu")


def _gcn_problem():
    from repro_torch.core import formats as pf
    from repro_torch.graphs import generators as pg
    csr = pg.erdos_renyi(64, 6, seed=2)
    tiled = pf.build_slimsell(csr, C=8, L=16).to_torch("cpu")
    rng = np.random.default_rng(5)
    cfg = pgnn.GCNConfig(d_in=12, n_classes=3, aggregation="slimsell")
    batch = {"node_feat": torch.from_numpy(rng.standard_normal(
                 (csr.n, 12)).astype(np.float32)),
             "deg": torch.from_numpy(csr.deg.astype(np.int32)),
             "tiled": tiled,
             "labels": torch.from_numpy(rng.integers(-1, 3, csr.n).astype(
                 np.int32)),
             "train_mask": torch.from_numpy((rng.random(csr.n) < 0.5).astype(
                 np.float32))}
    return cfg, batch


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("opt_name", ["adamw", "sgd", "muon"])
def test_resumed_run_equals_uninterrupted(tmp_path, opt_name, compress):
    cfg, batch = _gcn_problem()
    opt = {"adamw": popt.adamw(weight_decay=0.01), "sgd": popt.sgd(),
           "muon": popt.muon()}[opt_name]
    step, init = make_train_step(lambda p, b: pgnn.gcn_loss(
        p, b, cfg, device="cpu"), opt, compress=compress)

    def fresh():
        p = pgnn.gcn_init(cfg, generator=torch.Generator().manual_seed(9),
                          device="cpu")
        return p, init(p)

    p, s = fresh()
    losses = []
    for _ in range(4):
        p, s, m = step(p, s, batch)
        losses.append(m["loss"])
    q, t = fresh()
    for _ in range(2):
        q, t, _ = step(q, t, batch)
    pstore.save(str(tmp_path), 2, (q, t))
    (q2, t2), _ = pstore.restore(str(tmp_path), 2, (q, t), device="cpu")
    _same_tree((q2, t2), (q, t))
    assert all(a is not b for a, b in zip(pytree.leaves(q2), pytree.leaves(q)))
    resumed = []
    for _ in range(2):
        q2, t2, m = step(q2, t2, batch)
        resumed.append(m["loss"])
    _same_tree((q2, t2), (p, s))
    assert all(torch.equal(a, b) for a, b in zip(resumed, losses[2:]))


def _jax_train_state(opt_name, rng):
    params = {"w": [jnp.asarray(rng.standard_normal((5, 3)).astype(np.float32)),
                    jnp.asarray(rng.standard_normal(3).astype(np.float32))]}
    opt = {"adamw": jopt.adamw(), "sgd": jopt.sgd()}[opt_name]
    step, init = jmake_train_step(
        lambda p, b: jnp.sum((p["w"][0] @ p["w"][1] - b) ** 2), opt,
        compress=True)
    state = init(params)
    b = jnp.asarray(rng.standard_normal(5).astype(np.float32))
    for _ in range(2):
        params, state, _ = jax.jit(step)(params, state, b)
    return params, state


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_jax_saves_port_restores(tmp_path, opt_name):
    params, state = _jax_train_state(opt_name, np.random.default_rng(2))
    tree = (params, state)
    jstore.save(str(tmp_path), 2, tree, metadata={"by": "jax"})
    like = pytree.tree_map(lambda a: 0, jax.tree_util.tree_map(np.asarray, tree))
    got, meta = pstore.restore(str(tmp_path), 2, like, device="cpu")
    assert meta == {"by": "jax"}
    want = jax.tree_util.tree_leaves(tree)
    leaves = pytree.leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 2
    # the port's manifest of the same tree names the same files
    pstore.save(str(tmp_path / "port"), 2, got)
    ours = json.load(open(tmp_path / "port" / "step_0000000002" / "manifest.json"))
    theirs = json.load(open(tmp_path / "step_0000000002" / "manifest.json"))
    assert ours["treedef"] == theirs["treedef"]
    assert ours["leaves"] == theirs["leaves"]


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_port_saves_jax_restores(tmp_path, opt_name):
    params, state = _jax_train_state(opt_name, np.random.default_rng(3))
    host = jax.tree_util.tree_map(np.asarray, (params, state))
    ported = pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), host)
    pstore.save(str(tmp_path), 2, ported, metadata={"by": "port"})
    assert jstore.latest_step(str(tmp_path)) == 2
    got, meta = jstore.restore(str(tmp_path), 2, (params, state))
    assert meta == {"by": "port"}
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves((params, state))):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    mom = jnp.asarray(rng.standard_normal((2, 4, 3)).astype(np.float32)).astype(
        jnp.bfloat16)
    jtree = {"mom": mom, "m": jnp.zeros((0,), jnp.float32)}
    jstore.save(str(tmp_path / "jax"), 1, jtree)
    got, _ = pstore.restore(str(tmp_path / "jax"), 1, {"mom": 0, "m": 0},
                            device="cpu")
    assert got["mom"].dtype == torch.bfloat16
    want_bits = np.asarray(mom).view(np.uint16).astype(np.int16)
    np.testing.assert_array_equal(got["mom"].view(torch.int16).numpy(), want_bits)
    # the port's file: the JAX package reads the bits back as uint16
    pstore.save(str(tmp_path / "port"), 1, got)
    back, _ = jstore.restore(str(tmp_path / "port"), 1, jtree)
    assert back["mom"].dtype == jnp.uint16
    np.testing.assert_array_equal(
        np.asarray(jax.lax.bitcast_convert_type(back["mom"], jnp.bfloat16)),
        np.asarray(mom))
