"""GCN inference in the port against the JAX package's jnp path.

* The plain GCN-weighted SpMM (what a CPU tensor runs in place of the
  ``slimsell_spmm_gcn`` kernel) against ``repro``'s
  ``slimsell_spmm(..., edge_weight=gcn_edge_weight(deg))``: three graphs,
  two of them with vertices of degree 0 or a hub, widths 1 / 16 / 128, with
  and without a SlimWork mask; rtol = atol = 1e-5 (float32 sums taken in
  another order), and no NaN.
* ``gcn_forward`` under both aggregations against ``repro``'s, with the
  weights and the batch carried by ``convert``: atol = rtol = 1e-4, the
  bound of ``repro``'s own backend test.
* The port's gcn-cora configuration and GNN shapes equal ``repro``'s, and
  the guards raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import gcn_cora as jcora
from repro.core import formats as jf
from repro.core import semiring as jsm
from repro.core import spmv as jspmv
from repro.graphs import generators as jg
from repro.kernels import ref as jref
from repro.models import gnn as jgnn
from repro_torch import convert
from repro_torch.configs import gcn_cora as pcora
from repro_torch.core import formats as pf
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops
from repro_torch.models import gnn as pgnn

# name -> (graph of the JAX package's generators, C, L)
GRAPHS = {
    # the graph of repro's weighted-kernel test (test_kernels.py)
    "er": (lambda: jg.erdos_renyi(96, 5, seed=10), 8, 16),
    # 8 vertices of degree 0
    "kron": (lambda: jg.kronecker(8, 8, seed=4), 8, 32),
    # one hub of degree 99 over several tiles, 99 leaves of degree 1
    "star": (lambda: jg.star(100), 8, 16),
}
TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _carry(csr, C, L):
    """One layout in both packages: repro's, and the port's carried over."""
    host = jf.build_slimsell(csr, C=C, L=L)
    pt = convert.tiled_from_arrays(
        {k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
        {k: getattr(host, k) for k in convert.LAYOUT_META}, device="cpu")
    return host, host.to_jax(), pt


@pytest.fixture(scope="module")
def layouts():
    out = {}
    for name, (make, C, L) in GRAPHS.items():
        csr = make()
        host, jt, pt = _carry(csr, C, L)
        out[name] = (csr, host, jt, pt)
    assert (out["kron"][0].deg == 0).any()
    return out


def _mask(tiled, rng):
    """Half the tiles, and no tile at all of about a third of the chunks."""
    keep_chunk = rng.random(tiled.n_chunks) < 0.65
    return (rng.random(tiled.n_tiles) < 0.5) \
        & keep_chunk[np.asarray(tiled.row_block)]


def _edge_arrays(csr):
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    return np.stack([src, csr.indices]).astype(np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [1, 16, 128])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gcn_spmm_plain_matches_jnp(layouts, graph, width, masked):
    csr, _, jt, pt = layouts[graph]
    rng = np.random.default_rng([len(graph), width, masked])
    X = rng.standard_normal((csr.n, width)).astype(np.float32)
    deg = csr.deg.astype(np.float32)
    mask = _mask(pt, rng) if masked else None
    want = np.asarray(jspmv.slimsell_spmm(
        jsm.REAL, jt, jnp.asarray(X),
        edge_weight=jref.gcn_edge_weight(jnp.asarray(deg)),
        tile_mask=None if mask is None else jnp.asarray(mask), backend="jnp"))
    before = ops.launch_counts()
    got = pspmv.slimsell_spmm(
        psr.REAL, pt, torch.from_numpy(X), deg=torch.from_numpy(deg),
        tile_mask=None if mask is None else torch.from_numpy(mask))
    assert ops.launch_counts() == before  # a CPU tensor runs the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    assert not torch.isnan(got).any() and not np.isnan(want).any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gcn_edge_weight_matches_jnp(layouts, graph):
    """The derived weight of every slot, padding rows and slots included."""
    csr, _, jt, pt = layouts[graph]
    deg = csr.deg.astype(np.float32)
    rv_j = jnp.take(jt.row_vertex, jt.row_block, axis=0)[:, :, None]
    safe_j = jnp.where(jt.cols < 0, 0, jt.cols)
    want = np.asarray(jref.gcn_edge_weight(jnp.asarray(deg))(rv_j, safe_j))
    rv_p = pt.row_vertex.index_select(0, pt.row_block.long())[:, :, None]
    got = pspmv.gcn_edge_weight(torch.from_numpy(deg))(rv_p, pt.cols.clamp_min(0))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_gcn_spmm_plain_slices_like_one_pass(layouts, monkeypatch):
    """Slicing the tiles (to bound the gather) does not change the result."""
    csr, _, _, pt = layouts["star"]
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (csr.n, 5)).astype(np.float32))
    deg = pt.deg.float()
    whole = pspmv.spmm_plain(psr.REAL, pt, X, deg=deg)
    monkeypatch.setattr(pspmv, "_GATHER_BYTES", 3 * pt.C * pt.L * 5 * 4)
    assert torch.equal(pspmv.spmm_plain(psr.REAL, pt, X, deg=deg), whole)


# name -> (the two packages' configs, graph)
CONFIGS = {
    "small": (lambda m: m.GCNConfig(d_in=12, n_classes=3), "er64"),
    "reduced": (lambda m: m.reduced_config(), "kron"),
    "cora": (lambda m: m.make_config(), "er64"),
}


def _forward_case(layouts, name, aggregation):
    """The same weights and batch in both packages; returns their logits."""
    make, graph = CONFIGS[name]
    jcfg = make(jgnn if name == "small" else jcora)
    pcfg = make(pgnn if name == "small" else pcora)
    if graph == "er64":  # the graph of repro's GNN model tests
        csr = jg.erdos_renyi(64, 6, seed=2)
        host, jt, _ = _carry(csr, 8, 16)
    else:
        csr, host, jt, _ = layouts[graph]
    rng = np.random.default_rng([len(name), len(aggregation)])
    feat = rng.standard_normal((csr.n, jcfg.d_in)).astype(np.float32)
    edge_index = _edge_arrays(csr)
    edge_index = np.concatenate([edge_index, -np.ones((2, 7), np.int32)], 1)
    jcfg = dataclasses.replace(jcfg, aggregation=aggregation)
    pcfg = dataclasses.replace(pcfg, aggregation=aggregation)
    jp = jgnn.gcn_init(jcfg, jax.random.PRNGKey(len(name)))
    want = np.asarray(jgnn.gcn_forward(jp, {
        "node_feat": jnp.asarray(feat), "edge_index": jnp.asarray(edge_index),
        "deg": jnp.asarray(csr.deg, jnp.int32), "tiled": jt}, jcfg))
    pp = convert.gcn_params_from_arrays(
        {"w": [np.asarray(w) for w in jp["w"]]}, pcfg, device="cpu")
    batch = convert.gcn_batch_from_arrays(
        {"node_feat": feat, "edge_index": edge_index, "deg": csr.deg},
        layout=({k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
                {k: getattr(host, k) for k in convert.LAYOUT_META}),
        device="cpu")
    got = pgnn.gcn_forward(pp, batch, pcfg, device="cpu")
    return got, want, pp, batch, pcfg


@pytest.mark.parametrize("aggregation", ["segment", "slimsell"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gcn_forward_matches_jnp(layouts, name, aggregation):
    got, want, *_ = _forward_case(layouts, name, aggregation)
    assert got.shape == want.shape and not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_segment_equals_slimsell_in_the_port(layouts, name):
    got, _, pp, batch, pcfg = _forward_case(layouts, name, "segment")
    slim = pgnn.gcn_forward(pp, batch, dataclasses.replace(
        pcfg, aggregation="slimsell"), device="cpu")
    np.testing.assert_allclose(slim.numpy(), got.numpy(), rtol=0, atol=1e-4)


def test_module_equals_function(layouts):
    got, _, pp, batch, pcfg = _forward_case(layouts, "reduced", "slimsell")
    model = pgnn.GCN(pcfg, pp)
    assert [tuple(w.shape) for w in model.w] == pgnn.layer_shapes(pcfg)
    assert torch.equal(model(batch), got)


def test_plain_slimsell_forward_has_a_gradient(layouts):
    """On the CPU the plain version is PyTorch: autograd sees through it,
    and its gradient is the segment path's."""
    _, _, pp, batch, pcfg = _forward_case(layouts, "reduced", "segment")
    grads = []
    for aggregation in ("segment", "slimsell"):
        w = [t.clone().requires_grad_(True) for t in pp["w"]]
        y = pgnn.gcn_forward({"w": w}, batch, dataclasses.replace(
            pcfg, aggregation=aggregation), device="cpu")
        y.square().sum().backward()
        grads.append([t.grad for t in w])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_gcn_init_shapes_and_scale():
    cfg = pcora.make_config()
    p = pgnn.gcn_init(cfg, generator=torch.Generator().manual_seed(5),
                      device="cpu")
    assert [tuple(w.shape) for w in p["w"]] == [(1433, 16), (16, 16)]
    assert all(w.dtype == torch.float32 for w in p["w"])
    # N(0, 1/d_in): the first layer's 22,928 draws give its std to ~1%
    assert abs(float(p["w"][0].std()) * 1433 ** 0.5 - 1.0) < 0.05
    again = pgnn.gcn_init(cfg, generator=torch.Generator().manual_seed(5),
                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p["w"], again["w"]))


def test_config_and_shapes_equal_repro():
    for fn in ("make_config", "reduced_config"):
        a, b = getattr(jcora, fn)(), getattr(pcora, fn)()
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert np.dtype(fa.pop("dtype")).name == "float32"
        assert fb.pop("dtype") == torch.float32
        assert fa == fb, fn
    fa, fb = dataclasses.asdict(jgnn.GCNConfig()), dataclasses.asdict(pgnn.GCNConfig())
    fa.pop("dtype"), fb.pop("dtype")
    assert fa == fb
    assert pcora.GNN_SHAPES == jcells.GNN_SHAPES
    for k in ("ARCH_ID", "FAMILY", "KIND", "SHAPES"):
        assert getattr(pcora, k) == getattr(jcora, k), k


@pytest.fixture
def small(layouts):
    csr, _, _, pt = layouts["kron"]
    return pt, torch.zeros(pt.n, 4), pt.deg.float()


@pytest.mark.parametrize("name", ["tropical", "boolean", "selmax", "minplus",
                                  "boolean_packed"])
def test_deg_needs_the_real_semiring(small, name):
    pt, X, deg = small
    sr = psr.get(name) if name != "boolean_packed" else psr.BOOLEAN_PACKED
    X = X.to(sr.dtype)
    with pytest.raises(ValueError, match="swept under real"):
        pspmv.slimsell_spmm(sr, pt, X, deg=deg)


def test_deg_excludes_weights(small):
    pt, X, deg = small
    w = torch.ones(tuple(pt.cols.shape))
    with pytest.raises(ValueError, match="not both"):
        ops.spmm(psr.REAL, pt, X, deg=deg, weights=w)
    with pytest.raises(ValueError, match="not both"):
        pspmv.spmm_plain(psr.REAL, pt, X, weights=w, deg=deg)


@pytest.mark.parametrize("bad", ["short", "float64", "int32", "meta", "2d"])
def test_deg_shape_dtype_and_device(small, bad):
    pt, X, deg = small
    deg = {"short": deg[:-1], "float64": deg.double(), "int32": deg.int(),
           "meta": deg.to("meta"), "2d": deg[:, None]}[bad]
    with pytest.raises(ValueError, match="deg must be float32"):
        ops.spmm(psr.REAL, pt, X, deg=deg)


def test_converters_reject_mismatches(layouts):
    cfg = pcora.reduced_config()
    good = [np.zeros((8, 16), np.float32), np.zeros((16, 4), np.float32)]
    assert len(convert.gcn_params_from_arrays({"w": good}, cfg,
                                              device="cpu")["w"]) == 2
    with pytest.raises(ValueError, match="the config"):
        convert.gcn_params_from_arrays({"w": good}, pcora.make_config(),
                                       device="cpu")
    with pytest.raises(ValueError, match="chained"):
        convert.gcn_params_from_arrays({"w": [good[0], good[0]]}, device="cpu")
    with pytest.raises(ValueError, match="chained"):
        convert.gcn_params_from_arrays({"w": [np.zeros(8)]}, device="cpu")
    csr, host, _, _ = layouts["kron"]
    arrays = {"node_feat": np.zeros((csr.n, 3), np.float32),
              "edge_index": _edge_arrays(csr), "deg": csr.deg}
    layout = ({k: getattr(host, k) for k in convert.LAYOUT_ARRAYS},
              {k: getattr(host, k) for k in convert.LAYOUT_META})
    batch = convert.gcn_batch_from_arrays(arrays, layout=layout, device="cpu")
    assert batch["edge_index"].dtype == batch["deg"].dtype == torch.int32
    assert batch["tiled"].n == csr.n
    for key, value, match in (
            ("node_feat", np.zeros(csr.n, np.float32), "node_feat"),
            ("edge_index", _edge_arrays(csr)[:1], "edge_index"),
            ("edge_index", _edge_arrays(csr) + csr.n, "outside"),
            ("deg", csr.deg[:-1], "deg")):
        with pytest.raises(ValueError, match=match):
            convert.gcn_batch_from_arrays({**arrays, key: value}, device="cpu")
    other = layouts["er"][1]  # a layout of another graph
    with pytest.raises(ValueError, match="vertices"):
        convert.gcn_batch_from_arrays(
            arrays, layout=({k: getattr(other, k) for k in convert.LAYOUT_ARRAYS},
                            {k: getattr(other, k) for k in convert.LAYOUT_META}),
            device="cpu")


def test_forward_checks_aggregation_and_placement(layouts):
    _, _, pp, batch, pcfg = _forward_case(layouts, "reduced", "segment")
    with pytest.raises(ValueError, match="aggregation"):
        pgnn.gcn_forward(pp, batch, dataclasses.replace(pcfg, aggregation="mean"),
                         device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        pgnn.gcn_forward(pp, batch, pcfg, device="meta")
    host = pf.build_slimsell(pg.kronecker(8, 8, seed=4), C=8, L=32)
    with pytest.raises(ValueError, match="host layout"):
        pgnn.gcn_forward(pp, dict(batch, tiled=host), dataclasses.replace(
            pcfg, aggregation="slimsell"), device="cpu")
