"""Training in the port against the JAX package's: ``make_train_step`` on
DLRM, GCN, GIN, EGNN and NequIP, the three kernel routes of autograd
(7, 2g and 2), the training FLOP counts,
and the optimiser state carried across.

The JAX package's step is ``jax.jit`` of its ``make_train_step`` (its
launchers jit it), its gradient ``jax.grad`` of the jnp path; the port's
runs on the CPU, where the kernels' wrappers run their plain versions and
the ``Function``s of ``kernels.autograd`` give the gradients. The same
numpy weights and batches, made from a seed, go through both. Tolerances,
set before any run:

* loss within rtol 1e-5 (the forward's bound, ``test_torch_dlrm.py``), the
  gradient's global norm within rtol 1e-5, each step;
* AdamW's moments after each of 3 steps within rtol 1e-4 and an atol of
  1e-7 (m) and 1e-9 (v): float32 sums of the gradients in another order;
  the step count equal;
* the weights within rtol 1e-4 and atol 3e-5, a tenth of the learning
  rate: AdamW moves a weight by ``lr * m / (sqrt(v) + eps)``, and where a
  gradient element is near ``eps`` (1e-8; a sum of terms that cancel) its
  absolute float32 error of ~1e-10 moves that step by a few hundredths of
  ``lr`` (7.9e-6 at the MLPerf widths here);
* the int8 error-feedback buffers within atol 1e-6: ``q`` lands on the
  same level in both when no value lies at a rounding boundary, which
  holds for the seeded cases here;
* each ``Function``'s gradient against autograd of the plain path within
  rtol = atol = 1e-6 (kernel 2g: the same sums in another order); kernel
  7's table gradients within rtol = atol = 1e-5, whose rows here sum up to
  72 bag gradients (a one-row table) in another order; kernel 2's X
  gradient within rtol = atol = 1e-5 (``SUM_TOL``): its unnormalised sums
  reach ~30 on the hub rows here, where an ulp is ~2e-6; the gradients of a
  whole loss against ``jax.grad`` within rtol 1e-4 / atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import cells as jcells
from repro.configs import dlrm_mlperf as jcfgs
from repro.configs import egnn as jegnn_cfg
from repro.configs import gcn_cora as jcora
from repro.configs import gin_tu as jgin_cfg
from repro.configs import nequip as jnequip_cfg
from repro.core import formats as jf
from repro.data import pipeline as jpipe
from repro.graphs import generators as jg
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert, optim as popt, pytree
from repro_torch.configs import cells as pcells
from repro_torch.configs import dlrm_mlperf as pcfgs
from repro_torch.configs import egnn as pegnn_cfg
from repro_torch.configs import gcn_cora as pcora
from repro_torch.configs import gin_tu as pgin_cfg
from repro_torch.configs import nequip as pnequip_cfg
from repro_torch.core import formats as pf
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.kernels import autograd as pag
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_grouped_ref
from repro_torch.models import dlrm as pdlrm
from repro_torch.models import gnn as pgnn
from repro_torch.train import make_train_step

LOSS_TOL = dict(rtol=1e-5, atol=0)
W_TOL = dict(rtol=1e-4, atol=3e-5)
M_TOL = dict(rtol=1e-4, atol=1e-7)
V_TOL = dict(rtol=1e-4, atol=1e-9)
EF_TOL = dict(rtol=0, atol=1e-6)
FN_TOL = dict(rtol=1e-6, atol=1e-6)
BAG_TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got_tree, want_tree, **tol):
    got = [t.detach().numpy() for t in pytree.leaves(got_tree)]
    want = _np_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


def _check_state(ps, js, compress):
    assert set(ps) == set(js) == ({"opt", "step", "ef"} if compress
                                  else {"opt", "step"})
    assert int(ps["step"]) == int(js["step"])
    assert ps["step"].dtype == torch.int32
    _close(ps["opt"]["m"], js["opt"]["m"], **M_TOL)
    _close(ps["opt"]["v"], js["opt"]["v"], **V_TOL)
    if compress:
        _close(ps["ef"], js["ef"], **EF_TOL)


def _train_both(jloss, ploss, jparams, pparams, batches, compress):
    """STEPS steps of each package's ``make_train_step`` with AdamW; the
    port's weights and state compared with the JAX package's after each."""
    jstep, jinit = jmake_train_step(jloss, jopt.adamw(), compress=compress)
    jstep = jax.jit(jstep)
    pstep, pinit = make_train_step(ploss, popt.adamw(), compress=compress)
    js, ps = jinit(jparams), pinit(pparams)
    leaves = pytree.leaves(pparams)
    for jb, pb in batches:
        jparams, js, jm = jstep(jparams, js, jb)
        out, ps, pm = pstep(pparams, ps, pb)
        assert out is pparams
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), **LOSS_TOL)
        assert np.isfinite(float(pm["loss"]))
        _close(pparams, jparams, **W_TOL)
        _check_state(ps, js, compress)
    # the step updated the weights in place
    assert all(a is b for a, b in zip(pytree.leaves(pparams), leaves))
    return jparams, js, pparams, ps


# ----------------------------------------------------------------- DLRM


def _dlrm_configs(name):
    if name == "reduced":
        return jcfgs.reduced_config(), pcfgs.reduced_config()
    multi_hot = 3 if name == "mlperf_1000_k3" else 1
    vocabs = tuple(min(v, 1000) for v in jdlrm.MLPERF_VOCABS)
    return (jdlrm.DLRMConfig(vocabs=vocabs, multi_hot=multi_hot),
            dataclasses.replace(pcfgs.capped_config(1000), multi_hot=multi_hot))


def _dlrm_batches(jcfg, B, seed, n=STEPS):
    out = []
    for step in range(n):
        arrays = jpipe.CriteoPipeline(tuple(jcfg.vocabs), B, jcfg.multi_hot,
                                      seed=seed).get_batch(step)
        if jcfg.multi_hot > 1:  # pads, and a sample whose bags are all pads
            rng = np.random.default_rng([seed, step])
            sparse = arrays["sparse"].copy()
            sparse[rng.random(sparse.shape) < 0.3] = -1
            sparse[1, :, :] = -1
            arrays = dict(arrays, sparse=sparse)
        out.append(({k: jnp.asarray(v) for k, v in arrays.items()},
                    convert.dlrm_batch_from_arrays(arrays, device="cpu")))
    return out


def _dlrm_case(name, B, seed):
    jcfg, pcfg = _dlrm_configs(name)
    jp = jdlrm.dlrm_init(jcfg, jax.random.PRNGKey(seed))
    pp = convert.dlrm_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, jp), pcfg, device="cpu")
    return jcfg, pcfg, jp, pp, _dlrm_batches(jcfg, B, seed)


DLRM_CASES = [("reduced", False), ("reduced", True),
              ("mlperf_1000_k1", False), ("mlperf_1000_k3", False)]


@pytest.mark.parametrize("name,compress", DLRM_CASES)
def test_dlrm_train_step_matches_jax(name, compress):
    jcfg, pcfg, jp, pp, batches = _dlrm_case(name, 64, 3)
    _train_both(lambda p, b: jdlrm.dlrm_loss(p, b, jcfg),
                lambda p, b: pdlrm.dlrm_loss(p, b, pcfg, device="cpu"),
                jp, pp, batches, compress)


@pytest.mark.parametrize("name", ["reduced", "mlperf_1000_k3"])
def test_dlrm_gradient_matches_jax_grad(name):
    jcfg, pcfg, jp, pp, batches = _dlrm_case(name, 48, 5)
    jb, pb = batches[0]
    want = jax.grad(lambda p: jdlrm.dlrm_loss(p, jb, jcfg))(jp)
    leaves, treedef = pytree.flatten(pp)
    for t in leaves:
        t.requires_grad_(True)
    before = ops.launch_counts()
    got = torch.autograd.grad(pdlrm.dlrm_loss(pp, pb, pcfg, device="cpu"),
                              leaves)
    assert ops.launch_counts() == before  # CPU tables: the plain version
    _close(pytree.unflatten(treedef, list(got)), want, **GRAD_TOL)


def test_dlrm_tables_outside_the_batch_get_zero_gradient():
    _, pcfg, _, pp, batches = _dlrm_case("reduced", 8, 4)
    _, pb = batches[0]
    t0 = pp["tables"][0].requires_grad_(True)
    g, = torch.autograd.grad(pdlrm.dlrm_loss(pp, pb, pcfg, device="cpu"), [t0])
    used = torch.zeros(t0.shape[0], dtype=torch.bool)
    ids = pb["sparse"][:, 0].reshape(-1)
    used[ids[ids >= 0].long()] = True
    assert not g[~used].any() and g[used].abs().sum(dim=1).gt(0).all()


# ------------------------------------------------------------------ GCN


def _gcn_layout(graph):
    if graph == "er64":
        csr = jg.erdos_renyi(64, 6, seed=2)
        C, L = 8, 16
    else:
        csr = jg.kronecker(8, 8, seed=4)
        C, L = 8, 32
    host = jf.build_slimsell(csr, C=C, L=L)
    return csr, host


GCN_CONFIGS = {
    "small": (lambda m: m.GCNConfig(d_in=12, n_classes=3), "er64"),
    "reduced": (lambda m: m.reduced_config(), "kron"),
    "cora": (lambda m: m.make_config(), "er64"),
}


def _gcn_case(name, aggregation, seed=0):
    make, graph = GCN_CONFIGS[name]
    jcfg = make(jgnn if name == "small" else jcora)
    pcfg = dataclasses.replace(make(pgnn if name == "small" else pcora),
                               aggregation=aggregation)
    csr, host = _gcn_layout(graph)
    rng = np.random.default_rng([seed, len(name)])
    n = csr.n
    feat = rng.standard_normal((n, jcfg.d_in)).astype(np.float32)
    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    edge_index = np.concatenate([np.stack([src, csr.indices]).astype(np.int32),
                                 -np.ones((2, 5), np.int32)], 1)
    labels = rng.integers(-1, jcfg.n_classes, n).astype(np.int32)
    train_mask = (rng.random(n) < 0.4).astype(np.float32)
    jbatch = {"node_feat": jnp.asarray(feat), "edge_index": jnp.asarray(edge_index),
              "deg": jnp.asarray(csr.deg, jnp.int32),
              "labels": jnp.asarray(labels), "train_mask": jnp.asarray(train_mask)}
    pbatch = convert.gnn_batch_from_arrays(
        {"node_feat": feat, "edge_index": edge_index, "deg": csr.deg},
        layout=({k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
                {k: getattr(host, k) for k in convert.LAYOUT_META}),
        device="cpu")
    pbatch["labels"] = torch.from_numpy(labels)
    pbatch["train_mask"] = torch.from_numpy(train_mask)
    jp = jgnn.gcn_init(jcfg, jax.random.PRNGKey(seed + 1))
    pp = convert.gcn_params_from_arrays(
        {"w": [np.asarray(w) for w in jp["w"]]}, pcfg, device="cpu")
    return jcfg, pcfg, jp, pp, jbatch, pbatch


@pytest.mark.parametrize("aggregation", ["segment", "slimsell"])
@pytest.mark.parametrize("name", sorted(GCN_CONFIGS))
def test_gcn_loss_matches_gnn_loss(name, aggregation):
    jcfg, pcfg, jp, pp, jb, pb = _gcn_case(name, aggregation)
    want = float(jcells._gnn_loss("gcn", jp, jb, jcfg))
    got = pgnn.gcn_loss(pp, pb, pcfg, device="cpu")
    assert got.shape == () and np.isfinite(want)
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)


def test_gcn_loss_of_no_labelled_node_is_zero():
    _, pcfg, _, pp, _, pb = _gcn_case("small", "segment")
    pb["train_mask"] = torch.zeros_like(pb["train_mask"])
    assert float(pgnn.gcn_loss(pp, pb, pcfg, device="cpu")) == 0.0


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("aggregation", ["segment", "slimsell"])
@pytest.mark.parametrize("name", sorted(GCN_CONFIGS))
def test_gcn_train_step_matches_jax(name, aggregation, compress):
    jcfg, pcfg, jp, pp, jb, pb = _gcn_case(name, aggregation)
    _train_both(lambda p, b: jcells._gnn_loss("gcn", p, b, jcfg),
                lambda p, b: pgnn.gcn_loss(p, b, pcfg, device="cpu"),
                jp, pp, [(jb, pb)] * STEPS, compress)


@pytest.mark.parametrize("name", sorted(GCN_CONFIGS))
def test_gcn_gradient_matches_jax_grad(name):
    jcfg, pcfg, jp, pp, jb, pb = _gcn_case(name, "slimsell")
    want = jax.grad(lambda p: jcells._gnn_loss("gcn", p, jb, jcfg))(jp)
    w = [t.requires_grad_(True) for t in pp["w"]]
    got = torch.autograd.grad(pgnn.gcn_loss({"w": w}, pb, pcfg, device="cpu"), w)
    _close({"w": list(got)}, want, **GRAD_TOL)


# ------------------------------------------- GIN, EGNN and NequIP


def _gnn_inputs(kind, d_in, seed):
    """A batch of ``kind`` in both packages on the scale-8 Kronecker graph
    (its layout symmetric, some vertices of degree 0): 4 graphs. GIN's
    edge list has -1 pads; EGNN's has none, as a pad edge joins vertex 0 to
    itself, where the gradient of ``sqrt(d2)`` at 0 is NaN in both
    packages."""
    csr, host = _gcn_layout("kron")
    rng = np.random.default_rng([seed, len(kind)])
    n, G = csr.n, 4
    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    edge_index = np.stack([csr.indices, src]).astype(np.int32)
    if kind != "egnn":
        edge_index = np.concatenate([edge_index, -np.ones((2, 5), np.int32)], 1)
    arrays = {"edge_index": edge_index, "n_graphs": G,
              "graph_ids": rng.integers(0, G, n).astype(np.int32),
              "node_feat": rng.standard_normal((n, d_in)).astype(np.float32),
              "pos": (1.5 * rng.standard_normal((n, 3))).astype(np.float32),
              "species": rng.integers(0, 4, n).astype(np.int32),
              "graph_labels": rng.integers(0, 2, G).astype(np.int32),
              "energy": rng.standard_normal(G).astype(np.float32)}
    # repro's cells close over n_graphs, which its jitted step needs static
    jb = {k: jnp.asarray(v) for k, v in arrays.items() if k != "n_graphs"}
    pb = convert.gnn_batch_from_arrays(
        arrays, layout=({k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
                        {k: getattr(host, k) for k in convert.LAYOUT_META}),
        device="cpu")
    return jb, pb


GNN_TRAIN = {"gin": (jgin_cfg, pgin_cfg, jgnn.gin_init),
             "egnn": (jegnn_cfg, pegnn_cfg, jgnn.egnn_init),
             "nequip": (jnequip_cfg, pnequip_cfg, jgnn.nequip_init)}


@pytest.mark.parametrize("kind,aggregation", [
    ("gin", "segment"), ("gin", "slimsell"), ("egnn", "segment"),
    ("nequip", "segment")])
def test_gnn_train_step_matches_jax(kind, aggregation):
    """3 AdamW steps of ``reduced_config()`` against ``repro``'s jitted
    step on its segment path; the port's GIN also on the SlimSell
    aggregation (kernel 2's route, ``spmm_aggregate``)."""
    jmod, pmod, jinit = GNN_TRAIN[kind]
    jcfg = jmod.reduced_config()
    pcfg = pmod.reduced_config()
    if kind == "gin":
        pcfg = dataclasses.replace(pcfg, aggregation=aggregation)
    jp = jinit(jcfg, jax.random.PRNGKey(len(kind)))
    pp = convert.gnn_params_from_arrays(kind, jax.tree.map(np.asarray, jp),
                                        pcfg, device="cpu")
    jb, pb = _gnn_inputs(kind, getattr(jcfg, "d_in", 1), 0)
    _train_both(lambda p, b: jcells._gnn_loss(kind, p, dict(b, n_graphs=4),
                                              jcfg),
                lambda p, b: pcells.gnn_loss(kind, p, b, pcfg, device="cpu"),
                jp, pp, [(jb, pb)] * STEPS, False)


# ------------------------------------------------- the autograd routes


def _layout(csr, C, L):
    return pf.build_slimsell(csr, C=C, L=L).to_torch("cpu")


@pytest.mark.parametrize("width", [1, 16, 33])
@pytest.mark.parametrize("graph,C,L", [("er", 8, 16), ("kron", 8, 32),
                                       ("star", 3, 1)])
def test_gcn_aggregate_backward_equals_plain_autograd(graph, C, L, width):
    from repro_torch.graphs import generators as pg
    csr = {"er": lambda: pg.erdos_renyi(96, 5, seed=10),
           "kron": lambda: pg.kronecker(8, 8, seed=4),
           "star": lambda: pg.star(40)}[graph]()
    tiled = _layout(csr, C, L)
    rng = np.random.default_rng([C, L, width])
    X = torch.from_numpy(rng.standard_normal((csr.n, width)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((csr.n, width)).astype(np.float32))
    deg = tiled.deg.float()
    Xa = X.clone().requires_grad_(True)
    Y = pag.gcn_aggregate(tiled, Xa, deg)
    got, = torch.autograd.grad((Y * R).sum(), [Xa])
    Xb = X.clone().requires_grad_(True)
    Yb = pspmv.spmm_plain(psr.REAL, tiled, Xb, deg=deg)
    want, = torch.autograd.grad((Yb * R).sum(), [Xb])
    assert torch.equal(Y.detach(), Yb.detach())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FN_TOL)
    assert tiled.symmetric is not None and tiled.symmetric[3] is True


@pytest.mark.parametrize("width", [1, 16, 33])
@pytest.mark.parametrize("graph,C,L", [("er", 8, 16), ("kron", 8, 32),
                                       ("star", 3, 1)])
def test_spmm_aggregate_backward_equals_plain_autograd(graph, C, L, width):
    """Kernel 2's route: the implicit real SpMM's X gradient, the same
    sweep over the output's gradient, against autograd of the plain
    version within ``SUM_TOL``; the forward bit-equal."""
    from repro_torch.graphs import generators as pg
    csr = {"er": lambda: pg.erdos_renyi(96, 5, seed=10),
           "kron": lambda: pg.kronecker(8, 8, seed=4),
           "star": lambda: pg.star(40)}[graph]()
    tiled = _layout(csr, C, L)
    rng = np.random.default_rng([C, L, width, 2])
    X = torch.from_numpy(rng.standard_normal((csr.n, width)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((csr.n, width)).astype(np.float32))
    Xa = X.clone().requires_grad_(True)
    Y = pag.spmm_aggregate(tiled, Xa)
    got, = torch.autograd.grad((Y * R).sum(), [Xa])
    Xb = X.clone().requires_grad_(True)
    Yb = pspmv.spmm_plain(psr.REAL, tiled, Xb)
    want, = torch.autograd.grad((Yb * R).sum(), [Xb])
    assert torch.equal(Y.detach(), Yb.detach())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_TOL)


def test_spmm_aggregate_refuses_a_directed_layout():
    edges = np.array([[0, 1], [1, 2], [2, 0], [2, 3], [4, 3]])
    tiled = _layout(pf.build_csr(edges, 6, undirected=False), 2, 2)
    X = torch.ones((6, 3), requires_grad=True)
    Y = pag.spmm_aggregate(tiled, X)                     # forward runs
    with pytest.raises(NotImplementedError, match="transposed sweep"):
        Y.sum().backward()
    with torch.no_grad():                                # inference runs
        assert torch.equal(pag.spmm_aggregate(tiled, X),
                           pspmv.spmm_plain(psr.REAL, tiled, X))


def test_gcn_aggregate_refuses_a_directed_layout():
    edges = np.array([[0, 1], [1, 2], [2, 0], [2, 3], [4, 3]])
    csr = pf.build_csr(edges, 6, undirected=False)
    tiled = _layout(csr, 2, 2)
    assert not pf.is_symmetric(tiled)
    X = torch.ones((6, 3), requires_grad=True)
    Y = pag.gcn_aggregate(tiled, X, tiled.deg.float())   # forward runs
    with pytest.raises(NotImplementedError, match="transposed sweep"):
        Y.sum().backward()
    # the undirected layout of the same edges is symmetric
    assert pf.is_symmetric(_layout(pf.build_csr(edges, 6), 2, 2))


def test_is_symmetric_is_kept_on_the_layout(monkeypatch):
    from repro_torch.graphs import generators as pg
    tiled = _layout(pg.kronecker(6, 4, seed=0), 8, 16)
    assert pf.is_symmetric(tiled)
    calls = []
    monkeypatch.setattr(torch, "sort", lambda *a, **k: calls.append(1))
    assert pf.is_symmetric(tiled) and not calls       # the memo answers
    # a layout carried in from the JAX package's arrays works it out anew
    host = pf.build_slimsell(pg.kronecker(6, 4, seed=0), C=8, L=16)
    monkeypatch.undo()
    carried = convert.tiled_from_arrays(
        {k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
        {k: getattr(host, k) for k in convert.LAYOUT_META}, device="cpu")
    assert carried.symmetric is None and pf.is_symmetric(carried)


def test_gcn_aggregate_takes_no_deg_gradient():
    from repro_torch.graphs import generators as pg
    tiled = _layout(pg.kronecker(6, 4, seed=0), 8, 16)
    X = torch.ones((tiled.n, 2), requires_grad=True)
    deg = tiled.deg.float().requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient for deg"):
        pag.gcn_aggregate(tiled, X, deg)
    with torch.no_grad():
        pag.gcn_aggregate(tiled, X, deg)   # no gradient wanted: runs


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("K,pad_share", [(1, 0.0), (3, 0.3), (8, 0.5)])
def test_bag_lookup_backward_equals_plain_autograd(K, pad_share, mode):
    rng = np.random.default_rng([K, int(pad_share * 10), len(mode)])
    vocabs = (7, 50, 1, 300)
    d, B = 16, 24
    tables = [torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
              for v in vocabs]
    ids = np.stack([rng.integers(0, v, (B, K)) for v in vocabs], 1).astype(
        np.int32)
    ids[rng.random(ids.shape) < pad_share] = -1
    ids[2, 1, :] = -1                          # a bag of only pads
    ids[3, 0, 0] = vocabs[0]                   # an id past its table
    bags = torch.from_numpy(ids)
    R = torch.from_numpy(rng.standard_normal((B, len(vocabs), d)).astype(
        np.float32))
    ta = [t.clone().requires_grad_(True) for t in tables]
    out = pag.bag_lookup(ta, bags, mode)
    got = torch.autograd.grad(out, ta, grad_outputs=R)
    tb = [t.clone().requires_grad_(True) for t in tables]
    ref = embedding_bag_grouped_ref(tb, bags, mode)
    want = torch.autograd.grad(ref, tb, grad_outputs=R)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.isnan(out[3, 0]).all()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BAG_TOL)
    # only the tables that require grad get one
    tc = [tables[0].clone().requires_grad_(True)] + tables[1:]
    g0, = torch.autograd.grad(pag.bag_lookup(tc, bags, mode), [tc[0]],
                              grad_outputs=R)
    np.testing.assert_allclose(g0.numpy(), got[0].numpy(), rtol=0, atol=0)


def test_dlrm_forward_under_grad_writes_no_view():
    """Under grad mode the bags are joined by cat, not written into a view
    of the interaction's tensor: the logits equal the inference path's
    and the tables' gradients equal autograd of the plain lookups."""
    _, pcfg, _, pp, batches = _dlrm_case("mlperf_1000_k3", 16, 6)
    _, pb = batches[0]
    with torch.no_grad():
        want_y = pdlrm.dlrm_forward(pp, pb, pcfg, device="cpu")
    leaves, treedef = pytree.flatten(pp)
    for t in leaves:
        t.requires_grad_(True)
    y = pdlrm.dlrm_forward(pp, pb, pcfg, device="cpu")
    assert torch.equal(y.detach(), want_y)
    got = torch.autograd.grad(y.square().sum(), leaves)
    saved = pdlrm._lookup_all
    pdlrm._lookup_all = lambda tables, sparse, out=None: \
        embedding_bag_grouped_ref(tables, sparse, "sum", out)
    try:
        y_ref = pdlrm.dlrm_forward(pp, pb, pcfg, device="cpu")
    finally:
        pdlrm._lookup_all = saved
    want = torch.autograd.grad(y_ref.square().sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FN_TOL)
    Z = torch.zeros((16, 1 + pcfg.n_sparse, pcfg.embed_dim))
    with pytest.raises(ValueError, match="out= is for inference"):
        pdlrm._lookup_all(pp["tables"], pb["sparse"], Z[:, 1:])


def test_cpu_wrapper_runs_the_plain_version_under_autograd():
    """On the CPU the wrapper runs the plain version, which autograd sees
    through; the guard against grad is the card's (gpu tests)."""
    t = torch.ones((5, 4), requires_grad=True)
    out = ops.embedding_bag_grouped([t], torch.zeros((2, 1, 1), dtype=torch.int32))
    assert out.requires_grad


# ------------------------------------------------------- FLOPs and state


@pytest.mark.parametrize("name", sorted(pcora.GNN_SHAPES))
def test_gcn_model_flops_matches_repro(name):
    sh = pcora.GNN_SHAPES[name]
    cfg_j, cfg_p = jcora.make_config(), pcora.make_config()
    want = jcells.gnn_model_flops("gcn", cfg_j, sh["n_nodes"], sh["n_edges"],
                                  sh["d_feat"])
    assert pcora.gcn_model_flops(cfg_p, sh["n_nodes"], sh["n_edges"],
                                 sh["d_feat"]) == want


def test_dlrm_train_flops_matches_the_cell_count():
    cfg = jcfgs.make_config()
    B = jcells.RECSYS_SHAPES["train_batch"]["batch"]
    # repro/configs/cells.py's flops_mlp, as written there
    flops_mlp = (sum(2 * a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
                 + 2 * (cfg.n_interactions + cfg.bot_mlp[-1]) * cfg.top_mlp[0]
                 + sum(2 * a * b for a, b in zip(cfg.top_mlp[:-1], cfg.top_mlp[1:]))
                 + 2 * 27 * 27 * cfg.embed_dim)
    pcfg = pcfgs.make_config()
    assert pcfgs.mlp_flops(pcfg) == flops_mlp
    assert pcfgs.train_flops(pcfg, B) == 3 * B * flops_mlp
    assert pcfgs.train_flops(pcfgs.capped_config(2 ** 22), B) == 3 * B * flops_mlp


@pytest.mark.parametrize("opt_name", ["adamw", "sgd", "muon"])
def test_opt_state_from_arrays_carries_and_continues(opt_name):
    rng = np.random.default_rng(len(opt_name))
    shapes = {"a": (6, 4), "b": [(3, 8, 5), (9,)]}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 0.1
                                               ).astype(np.float32), params)
             for _ in range(2)]
    jo = {"adamw": jopt.adamw, "sgd": jopt.sgd, "muon": jopt.muon}[opt_name]()
    po = {"adamw": popt.adamw, "sgd": popt.sgd, "muon": popt.muon}[opt_name]()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    upd = jax.jit(jo.update)
    jp, js = upd(jax.tree_util.tree_map(jnp.asarray, grads[0]), js, jp,
                 jnp.int32(0))
    # carry the state after one step, then take the second step in both
    ps = convert.opt_state_from_arrays(jax.tree_util.tree_map(np.asarray, js),
                                       device="cpu")
    assert repr(pytree.flatten(ps)[1]) == str(jax.tree_util.tree_structure(js))
    for got, want in zip(pytree.leaves(ps), jax.tree_util.tree_leaves(js)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    pp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    jp, js = upd(jax.tree_util.tree_map(jnp.asarray, grads[1]), js, jp,
                 jnp.int32(1))
    po.update(jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     grads[1]), ps, pp,
              torch.tensor(1, dtype=torch.int32))
    _close(pp, jp, **(dict(rtol=1e-2, atol=1e-4) if opt_name == "muon"
                       else dict(rtol=1e-6, atol=0)))


def test_opt_state_from_arrays_carries_a_train_state():
    jp = {"w": [jnp.ones((3, 2)), jnp.zeros((2,))]}
    _, jinit = jmake_train_step(lambda p, b: 0.0, jopt.adamw(), compress=True)
    js = jinit(jp)
    ps = convert.opt_state_from_arrays(jax.tree_util.tree_map(np.asarray, js),
                                       device="cpu")
    assert set(ps) == {"opt", "step", "ef"}
    assert ps["step"].dtype == torch.int32 and ps["step"].shape == ()
    with pytest.raises(ValueError, match="float32, bfloat16 or int32"):
        convert.opt_state_from_arrays({"m": np.zeros(3, np.float64)},
                                      device="cpu")


def test_train_step_owns_expanded_and_shared_gradients():
    """Autograd returns the gradients of ``(a + b).sum()`` as expanded
    views that may share memory; the step copies them before the clip and
    the optimiser write in place, so each weight moves by its own
    gradient."""
    p = {"a": torch.ones(3), "b": torch.ones(3), "unused": torch.ones(2)}
    step, init = make_train_step(lambda p, b: (p["a"] + p["b"]).sum(),
                                 popt.sgd(lr=0.1, momentum=0.0), grad_clip=10.0)
    p, s, m = step(p, init(p), None)
    assert torch.equal(p["a"], torch.full((3,), 0.9))
    assert torch.equal(p["b"], torch.full((3,), 0.9))
    assert torch.equal(p["unused"], torch.ones(2))
    np.testing.assert_allclose(float(m["grad_norm"]), 6 ** 0.5, rtol=1e-6)


def test_train_step_frees_its_gradients_without_the_collector():
    """No reference cycle keeps a step's gradients alive (on the card a
    DLRM step's gradient tree is 12.8 GB): with the garbage collector off,
    every gradient is gone once the step returns."""
    import gc
    import weakref
    _, pcfg, _, pp, batches = _dlrm_case("reduced", 16, 7)
    step, init = make_train_step(
        lambda p, b: pdlrm.dlrm_loss(p, b, pcfg, device="cpu"), popt.adamw())
    s = init(pp)
    refs = []
    real_grad = torch.autograd.grad

    def spy(*a, **k):
        out = real_grad(*a, **k)
        refs.extend(weakref.ref(t) for t in out if t is not None)
        return out
    gc.disable()
    try:
        torch.autograd.grad = spy
        step(pp, s, batches[0][1])
        torch.autograd.grad = real_grad
        assert refs and all(r() is None for r in refs)
    finally:
        torch.autograd.grad = real_grad
        gc.enable()
