"""GIN, EGNN and NequIP in the port against the JAX package's jnp path.

The same numpy inputs, made from a seed, and the JAX package's weights,
carried across with ``convert.gnn_params_from_arrays``, go through both.
Tolerances, set before any run:

* every model output against ``repro``'s within 1e-4 of that output's
  largest magnitude (``REL``): float32 sums in another order, which GIN's
  five layers amplify (its activations reach ~2e5 here, ~1e10 on a
  scale-13 Kronecker graph) and EGNN's energies reach ~6e4;
* a loss against ``repro``'s ``_gnn_loss`` within rtol 1e-4;
* equivariance in the port at ``repro``'s own bounds
  (``tests/test_gnn_models.py``): EGNN energies and co-rotated coordinates
  within rtol = atol = 1e-3, NequIP energies within rtol 1e-3, atol 1e-4;
* the configs, the shapes, the FLOP counts and the weight trees' shapes
  equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import egnn as jegnn_cfg
from repro.configs import gcn_cora as jcora
from repro.configs import gin_tu as jgin_cfg
from repro.configs import nequip as jnequip_cfg
from repro.core import formats as jf
from repro.graphs import generators as jg
from repro.models import gnn as jgnn
from repro_torch import convert, pytree
from repro_torch.configs import cells as pcells
from repro_torch.configs import egnn as pegnn_cfg
from repro_torch.configs import gcn_cora as pcora
from repro_torch.configs import gin_tu as pgin_cfg
from repro_torch.configs import nequip as pnequip_cfg
from repro_torch.core import formats as pf
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops
from repro_torch.models import gnn as pgnn

REL = 1e-4
LOSS_TOL = dict(rtol=1e-4, atol=0)
N_GRAPHS = 4

# name -> (graph of the JAX package's generators, C, L)
GRAPHS = {
    # the graph of repro's GNN model tests
    "er64": (lambda: jg.erdos_renyi(64, 6, seed=2), 8, 16),
    # vertices of degree 0, chunks of several tiles
    "kron": (lambda: jg.kronecker(8, 8, seed=4), 8, 32),
}
# name -> (JAX package's config, the port's, the model's kind)
CONFIGS = {
    "gin small": (lambda: jgnn.GINConfig(d_in=12),
                  lambda: pgnn.GINConfig(d_in=12), "gin"),
    "gin reduced": (jgin_cfg.reduced_config, pgin_cfg.reduced_config, "gin"),
    "gin-tu": (jgin_cfg.make_config, pgin_cfg.make_config, "gin"),
    "egnn small": (lambda: jgnn.EGNNConfig(d_in=12),
                   lambda: pgnn.EGNNConfig(d_in=12), "egnn"),
    "egnn reduced": (jegnn_cfg.reduced_config, pegnn_cfg.reduced_config,
                     "egnn"),
    "nequip": (jnequip_cfg.make_config, pnequip_cfg.make_config, "nequip"),
    "nequip reduced": (jnequip_cfg.reduced_config, pnequip_cfg.reduced_config,
                       "nequip"),
}
J_INIT = {"gin": jgnn.gin_init, "egnn": jgnn.egnn_init,
          "nequip": jgnn.nequip_init}
P_INIT = {"gin": pgnn.gin_init, "egnn": pgnn.egnn_init,
          "nequip": pgnn.nequip_init}


def close_rel(got, want, rel=REL):
    """``got`` within ``rel`` of ``want``'s largest magnitude, no NaN."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(float(np.abs(want).max()), np.finfo(np.float32).tiny)
    assert float(np.abs(got - want).max()) <= rel * scale


def edge_arrays(csr, pads=5):
    """int32[2, E + pads]: (sender, receiver) of every CSR edge, -1 pads."""
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    return np.concatenate([np.stack([csr.indices, src]).astype(np.int32),
                           -np.ones((2, pads), np.int32)], 1)


def layout_arrays(host):
    return ({k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
            {k: getattr(host, k) for k in convert.LAYOUT_META})


def make_inputs(graph, d_in, seed):
    """The numpy batch of every model on ``graph`` and its layout, in both
    packages: ``(jax batch, port batch)``."""
    make, C, L = GRAPHS[graph]
    csr = make()
    host = jf.build_slimsell(csr, C=C, L=L)
    rng = np.random.default_rng([seed, d_in, len(graph)])
    graph_ids = rng.integers(0, N_GRAPHS, csr.n).astype(np.int32)
    graph_ids[rng.random(csr.n) < 0.1] = -1
    arrays = {
        "node_feat": rng.standard_normal((csr.n, d_in)).astype(np.float32),
        "pos": (1.5 * rng.standard_normal((csr.n, 3))).astype(np.float32),
        "species": rng.integers(0, 4, csr.n).astype(np.int32),
        "edge_index": edge_arrays(csr), "deg": csr.deg.astype(np.int32),
        "graph_ids": graph_ids, "n_graphs": N_GRAPHS,
        "graph_labels": rng.integers(0, 2, N_GRAPHS).astype(np.int32),
        "energy": rng.standard_normal(N_GRAPHS).astype(np.float32),
    }
    jb = {k: v if k == "n_graphs" else jnp.asarray(v) for k, v in arrays.items()}
    jb["tiled"] = host.to_jax()
    pb = convert.gnn_batch_from_arrays(arrays, layout=layout_arrays(host),
                                       device="cpu")
    return jb, pb


def make_case(name, graph="er64", aggregation="segment", seed=0):
    """``(jcfg, pcfg, kind, jax params, port params, jax batch, port
    batch)``: ``repro``'s init carried into the port."""
    jmake, pmake, kind = CONFIGS[name]
    jcfg, pcfg = jmake(), pmake()
    if kind == "gin":
        jcfg = dataclasses.replace(jcfg, aggregation=aggregation)
        pcfg = dataclasses.replace(pcfg, aggregation=aggregation)
    jp = J_INIT[kind](jcfg, jax.random.PRNGKey(seed + 7))
    pp = convert.gnn_params_from_arrays(kind, jax.tree.map(np.asarray, jp),
                                        pcfg, device="cpu")
    jb, pb = make_inputs(graph, getattr(jcfg, "d_in", 1), seed)
    return jcfg, pcfg, kind, jp, pp, jb, pb


GIN_NAMES = [n for n in CONFIGS if CONFIGS[n][2] == "gin"]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("aggregation", ["segment", "slimsell"])
@pytest.mark.parametrize("name", GIN_NAMES)
def test_gin_matches_jnp(name, aggregation, graph):
    jcfg, pcfg, _, jp, pp, jb, pb = make_case(name, graph, aggregation)
    want = jgnn.gin_forward(jp, jb, jcfg)
    before = ops.launch_counts()
    got = pgnn.gin_forward(pp, pb, pcfg, device="cpu")
    assert ops.launch_counts() == before  # CPU tensors: the plain version
    assert got.shape == (N_GRAPHS, pcfg.n_classes)
    close_rel(got, want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gin_slimsell_equals_segment_in_the_port(graph):
    *_, pp, _, pb = make_case("gin-tu", graph, "segment")
    cfg = pgin_cfg.make_config()
    seg = pgnn.gin_forward(pp, pb, cfg, device="cpu")
    slim = pgnn.gin_forward(pp, pb, dataclasses.replace(
        cfg, aggregation="slimsell"), device="cpu")
    close_rel(slim, seg.numpy())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["egnn small", "egnn reduced"])
def test_egnn_matches_jnp(name, graph):
    jcfg, pcfg, _, jp, pp, jb, pb = make_case(name, graph)
    we, wx = jgnn.egnn_forward(jp, jb, jcfg)
    ge, gx = pgnn.egnn_forward(pp, pb, pcfg, device="cpu")
    assert ge.shape == (N_GRAPHS,) and gx.shape == tuple(pb["pos"].shape)
    close_rel(ge, we)
    close_rel(gx, wx)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["nequip", "nequip reduced"])
def test_nequip_matches_jnp(name, graph):
    jcfg, pcfg, _, jp, pp, jb, pb = make_case(name, graph)
    want = jgnn.nequip_forward(jp, jb, jcfg)
    got = pgnn.nequip_forward(pp, pb, pcfg, device="cpu")
    assert got.shape == (N_GRAPHS,)
    close_rel(got, want)


def _rotation(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (torch.from_numpy(q.astype(np.float32)),
            torch.tensor([1.0, -2.0, 0.5]))


@pytest.mark.parametrize("seed", [0, 1])
def test_egnn_equivariance_in_the_port(seed):
    _, pcfg, _, _, pp, _, pb = make_case("egnn small", seed=seed)
    Q, t = _rotation(seed)
    e1, x1 = pgnn.egnn_forward(pp, pb, pcfg, device="cpu")
    e2, x2 = pgnn.egnn_forward(pp, dict(pb, pos=pb["pos"] @ Q.T + t), pcfg,
                               device="cpu")
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(x2.numpy(), (x1 @ Q.T + t).numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["nequip", "nequip reduced"])
def test_nequip_equivariance_in_the_port(name, seed):
    _, pcfg, _, _, pp, _, pb = make_case(name, seed=seed)
    Q, t = _rotation(seed)
    e1 = pgnn.nequip_forward(pp, pb, pcfg, device="cpu")
    e2 = pgnn.nequip_forward(pp, dict(pb, pos=pb["pos"] @ Q.T + t), pcfg,
                             device="cpu")
    assert torch.isfinite(e1).all()
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-3, atol=1e-4)


def test_nequip_higher_irreps_are_live():
    """Zeroing the first layer's l = 1 and l = 2 mixers changes the energy:
    the tensor products reach the output."""
    cfg = pgnn.NequIPConfig(n_layers=2)
    p = pgnn.nequip_init(cfg, generator=torch.Generator().manual_seed(4),
                         device="cpu")
    _, pb = make_inputs("er64", 1, 4)
    e1 = pgnn.nequip_forward(p, pb, cfg, device="cpu")
    for key in ("mix1", "mix2"):
        p["layers"][0][key] = torch.zeros_like(p["layers"][0][key])
    e2 = pgnn.nequip_forward(p, pb, cfg, device="cpu")
    assert not np.allclose(e1.numpy(), e2.numpy(), atol=1e-6)


def test_nequip_init_draws_each_mixer_apart():
    """``repro``'s init draws mix1 and mix2 from one key (equal at init);
    the port's draws each from its own stream."""
    cfg = pnequip_cfg.make_config()
    jp = jgnn.nequip_init(jnequip_cfg.make_config(), jax.random.PRNGKey(0))
    assert np.array_equal(jp["layers"][0]["mix1"], jp["layers"][0]["mix2"])
    p = pgnn.nequip_init(cfg, device="cpu")
    for lp in p["layers"]:
        assert not torch.equal(lp["mix1"], lp["mix2"])
        assert not torch.equal(lp["mix0"], lp["mix1"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_tree_and_shapes_equal_repro(name):
    jmake, pmake, kind = CONFIGS[name]
    jp = J_INIT[kind](jmake(), jax.random.PRNGKey(0))
    pp = P_INIT[kind](pmake(), generator=torch.Generator().manual_seed(0),
                      device="cpu")
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    pairs, pdef = pytree.flatten_with_paths(pp)
    assert repr(pdef) == str(jdef)
    assert [p for p, _ in pairs] == [jax.tree_util.keystr(k) for k, _ in
                                     jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [tuple(t.shape) for _, t in pairs] == [a.shape for a in jleaves]
    assert all(t.dtype == torch.float32 for _, t in pairs)
    again = P_INIT[kind](pmake(), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(pp),
                                                 pytree.leaves(again)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_module_equals_function(name):
    _, pcfg, kind, _, pp, _, pb = make_case(name)
    module = {"gin": pgnn.GIN, "egnn": pgnn.EGNN, "nequip": pgnn.NequIP}[kind]
    model = module(pcfg, pp)
    fn = {"gin": pgnn.gin_forward, "egnn": pgnn.egnn_forward,
          "nequip": pgnn.nequip_forward}[kind]
    want = fn(pp, pb, pcfg, device="cpu")
    got = model(pb)
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        assert torch.equal(g, w)
    assert len(list(model.parameters())) == len(pytree.leaves(pp))


# (config, aggregation): GIN under both, EGNN and NequIP have one
LOSS_CASES = [("gin reduced", "segment"), ("gin reduced", "slimsell"),
              ("gin-tu", "segment"), ("gin-tu", "slimsell"),
              ("egnn small", "segment"), ("nequip reduced", "segment")]


@pytest.mark.parametrize("name,aggregation", LOSS_CASES)
def test_gnn_loss_matches_repro(name, aggregation):
    jcfg, pcfg, kind, jp, pp, jb, pb = make_case(name, "kron", aggregation)
    want = float(jcells._gnn_loss(kind, jp, jb, jcfg))
    got = pcells.gnn_loss(kind, pp, pb, pcfg, device="cpu")
    assert got.shape == () and np.isfinite(want)
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)


def test_gnn_loss_gcn_branch_matches_repro():
    jcfg, pcfg = jcora.reduced_config(), pcora.reduced_config()
    jp = jgnn.gcn_init(jcfg, jax.random.PRNGKey(3))
    pp = convert.gnn_params_from_arrays(
        "gcn", {"w": [np.asarray(w) for w in jp["w"]]}, pcfg, device="cpu")
    jb, pb = make_inputs("kron", jcfg.d_in, 3)
    rng = np.random.default_rng(3)
    n = pb["deg"].shape[0]
    labels = rng.integers(-1, jcfg.n_classes, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    jb = dict(jb, labels=jnp.asarray(labels), train_mask=jnp.asarray(mask))
    pb = dict(pb, labels=torch.from_numpy(labels),
              train_mask=torch.from_numpy(mask))
    want = float(jcells._gnn_loss("gcn", jp, jb, jcfg))
    got = pcells.gnn_loss("gcn", pp, pb, pcfg, device="cpu")
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)
    with pytest.raises(ValueError, match="kind"):
        pcells.gnn_loss("gat", pp, pb, pcfg, device="cpu")


CFG_MODULES = {"gin": (jgin_cfg, pgin_cfg), "egnn": (jegnn_cfg, pegnn_cfg),
               "nequip": (jnequip_cfg, pnequip_cfg)}


@pytest.mark.parametrize("shape", sorted(pcells.GNN_SHAPES))
@pytest.mark.parametrize("kind", ["gcn", "gin", "egnn", "nequip"])
def test_gnn_model_flops_matches_repro(kind, shape):
    sh = pcells.GNN_SHAPES[shape]
    jmod, pmod = CFG_MODULES.get(kind, (jcora, pcora))
    want = jcells.gnn_model_flops(kind, jmod.make_config(), sh["n_nodes"],
                                  sh["n_edges"], sh["d_feat"])
    got = pcells.gnn_model_flops(kind, pmod.make_config(), sh["n_nodes"],
                                 sh["n_edges"], sh["d_feat"])
    assert got == want and got > 0
    if kind == "gcn":
        assert pcora.gcn_model_flops(pmod.make_config(), sh["n_nodes"],
                                     sh["n_edges"], sh["d_feat"]) == want


def _fields(cfg):
    f = dataclasses.asdict(cfg)
    dtype = f.pop("dtype")
    return f, dtype


@pytest.mark.parametrize("kind", sorted(CFG_MODULES))
def test_configs_equal_repro(kind):
    jmod, pmod = CFG_MODULES[kind]
    for fn in ("make_config", "reduced_config"):
        (fa, da), (fb, db) = _fields(getattr(jmod, fn)()), \
            _fields(getattr(pmod, fn)())
        assert np.dtype(da).name == "float32" and db == torch.float32
        assert fa == fb, fn
    default = {"gin": "GINConfig", "egnn": "EGNNConfig",
               "nequip": "NequIPConfig"}[kind]
    assert _fields(getattr(jgnn, default)())[0] == \
        _fields(getattr(pgnn, default)())[0]
    for k in ("ARCH_ID", "FAMILY", "KIND", "SHAPES"):
        assert getattr(pmod, k) == getattr(jmod, k), k
    assert not hasattr(pmod, "build_cell")
    assert pcells.GNN_SHAPES == jcells.GNN_SHAPES
    assert pcora.GNN_SHAPES is pcells.GNN_SHAPES


def test_params_converter_refuses_mismatches():
    cfg = pgin_cfg.reduced_config()
    jp = jax.tree.map(np.asarray, jgnn.gin_init(jgin_cfg.reduced_config(),
                                                jax.random.PRNGKey(0)))
    pp = convert.gnn_params_from_arrays("gin", jp, cfg, device="cpu")
    assert pp["layers"][0]["eps"].shape == () \
        and pp["layers"][0]["eps"].dtype == torch.float32
    with pytest.raises(ValueError, match="the config"):
        convert.gnn_params_from_arrays("gin", jp, pgin_cfg.make_config(),
                                       device="cpu")
    missing = dict(jp, layers=jp["layers"][:-1])
    with pytest.raises(ValueError, match="the config"):
        convert.gnn_params_from_arrays("gin", missing, cfg, device="cpu")
    ints = jax.tree.map(lambda a: a.astype(np.int32), jp)
    with pytest.raises(ValueError, match="floating"):
        convert.gnn_params_from_arrays("gin", ints, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        convert.gnn_params_from_arrays("gat", jp, device="cpu")
    ep = jax.tree.map(np.asarray, jgnn.egnn_init(jegnn_cfg.reduced_config(),
                                                 jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="the config"):
        convert.gnn_params_from_arrays("nequip", ep,
                                       pnequip_cfg.reduced_config(),
                                       device="cpu")
    # without a config the tree is carried as it is, in float32
    loose = convert.gnn_params_from_arrays("egnn", ep, device="cpu")
    assert [tuple(t.shape) for t in pytree.leaves(loose)] == \
        [a.shape for a in jax.tree_util.tree_leaves(ep)]


@pytest.mark.parametrize("key,value,match", [
    ("pos", np.zeros((64, 2), np.float32), "pos must be"),
    ("species", np.zeros(63, np.int32), "species must be"),
    ("graph_ids", np.full(64, N_GRAPHS, np.int32), "graph_ids holds ids"),
    ("energy", np.zeros(N_GRAPHS + 1, np.float32), "energy must be"),
    ("graph_labels", np.zeros((N_GRAPHS, 1), np.int32), "graph_labels must be"),
    ("edge_index", np.full((2, 3), 64, np.int32), "outside"),
    ("weights", np.zeros(64, np.float32), "no GNN reads"),
])
def test_batch_converter_refuses_mismatches(key, value, match):
    csr = jg.erdos_renyi(64, 6, seed=2)
    rng = np.random.default_rng(0)
    arrays = {"node_feat": np.zeros((64, 3), np.float32),
              "pos": np.zeros((64, 3), np.float32),
              "species": np.zeros(64, np.int32),
              "edge_index": edge_arrays(csr),
              "graph_ids": rng.integers(0, N_GRAPHS, 64).astype(np.int32),
              "n_graphs": N_GRAPHS,
              "graph_labels": np.zeros(N_GRAPHS, np.int32),
              "energy": np.zeros(N_GRAPHS, np.float32)}
    batch = convert.gnn_batch_from_arrays(arrays, device="cpu")
    assert batch["n_graphs"] == N_GRAPHS and batch["species"].dtype == torch.int32
    with pytest.raises(ValueError, match=match):
        convert.gnn_batch_from_arrays({**arrays, key: value}, device="cpu")
    no_g = {k: v for k, v in arrays.items()
            if k not in ("n_graphs", "graph_labels", "energy")}
    with pytest.raises(ValueError, match="needs G"):
        convert.gnn_batch_from_arrays(no_g, device="cpu")
    other = jf.build_slimsell(jg.erdos_renyi(40, 4, seed=1), C=8, L=16)
    with pytest.raises(ValueError, match="vertices"):
        convert.gnn_batch_from_arrays(arrays, layout=layout_arrays(other),
                                      device="cpu")


def test_forwards_check_aggregation_and_placement():
    _, pcfg, _, _, pp, _, pb = make_case("gin reduced")
    with pytest.raises(ValueError, match="aggregation"):
        pgnn.gin_forward(pp, pb, dataclasses.replace(pcfg, aggregation="mean"),
                         device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        pgnn.gin_forward(pp, pb, pcfg, device="meta")
    host = pf.build_slimsell(pg.erdos_renyi(64, 6, seed=2), C=8, L=16)
    with pytest.raises(ValueError, match="host layout"):
        pgnn.gin_forward(pp, dict(pb, tiled=host), dataclasses.replace(
            pcfg, aggregation="slimsell"), device="cpu")
    for name, fn in (("egnn small", pgnn.egnn_forward),
                     ("nequip reduced", pgnn.nequip_forward)):
        _, cfg, _, _, p, _, b = make_case(name)
        with pytest.raises(ValueError, match="is on cpu"):
            fn(p, b, cfg, device="meta")


def test_molecules_make_the_molecule_cell():
    """``generators.molecules(128)`` has the ``molecule`` cell's sizes; every
    edge joins two atoms of one molecule, each molecule's are its 32
    closest pairs both ways, and a seed gives one batch."""
    sh = pcells.GNN_SHAPES["molecule"]
    m = pg.molecules(sh["n_graphs"], seed=3)
    ei = m["edge_index"]
    assert m["node_feat"].shape == (sh["n_nodes"], sh["d_feat"])
    assert ei.shape == (2, sh["n_edges"]) and ei.dtype == np.int32
    assert m["n_graphs"] == sh["n_graphs"] and m["pos"].shape == (sh["n_nodes"], 3)
    assert np.array_equal(ei[0] // 30, ei[1] // 30)
    assert np.array_equal(m["graph_ids"], np.arange(sh["n_nodes"]) // 30)
    assert len({tuple(e) for e in ei.T}) == sh["n_edges"]
    for mol in (0, 77):
        p = m["pos"][30 * mol:30 * (mol + 1)]
        d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
        pairs = sorted((d2[i, j], i, j) for i in range(30) for j in range(i + 1, 30))
        want = {(i + 30 * mol, j + 30 * mol) for _, i, j in pairs[:32]}
        want |= {(j, i) for i, j in want}
        got = {tuple(e) for e in ei.T[64 * mol:64 * (mol + 1)]}
        assert got == want
    again = pg.molecules(sh["n_graphs"], seed=3)
    assert all(np.array_equal(np.asarray(m[k]), np.asarray(again[k])) for k in m)
    assert 0 <= m["species"].min() and m["species"].max() < 4


@pytest.mark.parametrize("shape", [(50,), (50, 3), (50, 2, 3)])
def test_seg_sum_of_one_segment_is_the_masked_sum(shape):
    """One segment takes the plain reduction: the index_add_ path's sum
    within float32 rounding, -1 ids dropped, any trailing shape."""
    rng = np.random.default_rng(len(shape))
    data = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 1, 50).astype(np.int32))
    got = pgnn.seg_sum(data, ids, 1)
    want = data[ids == 0].double().sum(0, keepdim=True)
    assert got.shape == (1,) + shape[1:] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    two = pgnn.seg_sum(data, ids, 2)      # index_add_: the same first row
    np.testing.assert_allclose(two[:1].numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)
