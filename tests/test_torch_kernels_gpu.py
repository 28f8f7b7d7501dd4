"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides in the ``cuda`` fixture whether a card is
present and skips where there is none. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core import semiring as psr
from repro_torch.core import sssp as psssp
from repro_torch.core.formats import build_slimsell
from repro_torch.core.spmv import (pull_mm_plain, pull_plain,
                                   spmm_packed_plain, spmm_plain,
                                   spmv_packed_plain, spmv_plain)
from repro_torch.graphs.generators import (erdos_renyi, kronecker,
                                           with_random_weights)
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

SEMIRINGS = ["tropical", "real", "boolean", "selmax"]
MASKS = ["none_given", "all_kept", "none_kept", "random"]
NF_KINDS = ["random", "all", "none"]
# layouts of the SpMV's (and SpMM's) cases: "<graph> C<rows> L<width>"
SWEEP_LAYOUTS = ["kron C8 L128", "kron C3 L1", "hub C1 L128", "hub C3 L128",
                 "hub C8 L1", "hub C8 L128", "hub C32 L128"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    return dev, build_slimsell(kronecker(12, 16, seed=1), C=8, L=128).to_torch(dev)


def _mask(kind, tiled, rng, dev):
    T = tiled.n_tiles
    if kind == "none_given":
        return None
    if kind in ("all_kept", "none_kept"):
        return torch.full((T,), kind == "all_kept", dtype=torch.bool, device=dev)
    if kind == "one_hub_tile":  # the middle tile of the first chunk alone
        ptr = tiled.tile_ptr.tolist()
        mask = torch.zeros(T, dtype=torch.bool, device=dev)
        mask[(ptr[0] + ptr[1]) // 2] = True
        return mask
    keep_chunk = torch.from_numpy(rng.random(tiled.n_chunks) < 0.6).to(dev)
    return torch.from_numpy(rng.random(T) < 0.5).to(dev) \
        & keep_chunk[tiled.row_block.long()]


def _operand(sr, shape, rng, dev):
    if sr.name == "boolean":
        x = rng.integers(0, 2, size=shape).astype(np.int32)
    else:
        x = rng.integers(0, 4, size=shape).astype(np.float32)
        if sr.name == "tropical":
            x[rng.random(shape) < 0.5] = np.inf
        if sr.name == "selmax":
            x *= rng.integers(1, 1000, size=shape)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("mask_kind", MASKS + ["one_hub_tile"])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_kernel_equals_plain(sweep_layouts, name, mask_kind, width, layout):
    """The SpMV (width None) and the SpMM against their plain versions,
    exactly, on every layout of ``sweep_layouts``; a second call gives the
    same bits."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([SEMIRINGS.index(name), len(mask_kind),
                                 width or 0, SWEEP_LAYOUTS.index(layout)])
    sr = psr.get(name)
    mask = _mask(mask_kind, tiled, rng, dev)
    x = _operand(sr, (tiled.n,) if width is None else (tiled.n, width), rng, dev)
    kernel = ops.SPMV if width is None else ops.SPMM
    before = kernel.launches
    if width is None:
        got, want = ops.spmv(sr, tiled, x, tile_mask=mask), spmv_plain(sr, tiled, x, mask)
        again = ops.spmv(sr, tiled, x, tile_mask=mask)
    else:
        got, want = ops.spmm(sr, tiled, x, tile_mask=mask), spmm_plain(sr, tiled, x, mask)
        again = ops.spmm(sr, tiled, x, tile_mask=mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.is_cuda and torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("nf_kind", NF_KINDS)
@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_pull_kernel_equals_plain(cuda, name, mask_kind, width, nf_kind):
    dev, tiled = cuda
    rng = np.random.default_rng([SEMIRINGS.index(name), MASKS.index(mask_kind),
                                 width or 0, NF_KINDS.index(nf_kind), 1])
    sr = psr.get(name)
    mask = _mask(mask_kind, tiled, rng, dev)
    shape = (tiled.n,) if width is None else (tiled.n, width)
    x = _operand(sr, shape, rng, dev)
    if nf_kind == "random":
        nf = torch.from_numpy(rng.random(shape) < 0.6).to(dev)
    else:
        nf = torch.full(shape, nf_kind == "all", dtype=torch.bool, device=dev)
    kernel = ops.PULL if width is None else ops.PULL_MM
    before = kernel.launches
    if width is None:
        got = ops.pull(sr, tiled, x, nf, tile_mask=mask)
        want = pull_plain(sr, tiled, x, nf, mask)
    else:
        got = ops.pull_mm(sr, tiled, x, nf, tile_mask=mask)
        want = pull_mm_plain(sr, tiled, x, nf, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


@pytest.fixture(scope="module")
def cuda_tail(cuda):
    """A layout whose n = 4001 leaves 1 live bit in the last packed word."""
    dev, _ = cuda
    return dev, build_slimsell(erdos_renyi(4001, 12.0, seed=3), C=8,
                               L=128).to_torch(dev)


@pytest.mark.parametrize("graph", ["kron", "tail"])
@pytest.mark.parametrize("density", [0.02, 0.5])
@pytest.mark.parametrize("width", [None, 1, 5, 33, 64, 97, 160])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_packed_kernel_equals_plain(request, mask_kind, width, density, graph):
    """SlimSell-B: the packed SpMV (width None) over a frontier bitmap and
    the packed-plane SpMM over ceil(B/32) words, exactly; padding bits stay
    zero. B = 97 and 160 fill 4 and 5 words: one block's four planes, then
    a second, partly used block along grid y."""
    dev, tiled = request.getfixturevalue("cuda" if graph == "kron"
                                         else "cuda_tail")
    rng = np.random.default_rng([MASKS.index(mask_kind), width or 0,
                                 int(density * 100), len(graph), 2])
    mask = _mask(mask_kind, tiled, rng, dev)
    shape = (tiled.n,) if width is None else (tiled.n, width)
    bits = torch.from_numpy(rng.random(shape) < density).to(dev)
    x = packing.pack_bits(bits, axis=0 if width is None else 1)
    kernel = ops.SPMV_PACKED if width is None else ops.SPMM_PACKED
    before = kernel.launches
    if width is None:
        got = ops.spmv_packed(tiled, x, tile_mask=mask)
        want = spmv_packed_plain(tiled, x, mask)
    else:
        got = ops.spmm_packed(tiled, x, tile_mask=mask)
        want = spmm_packed_plain(tiled, x, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)
    assert packing.check_tail_zero_host(got.cpu().numpy(),
                                        tiled.n if width is None else width)


@pytest.fixture(scope="module")
def cuda_weighted(cuda):
    """A weighted layout with the Graph500 SSSP weights on [2^-8, 1]."""
    dev, _ = cuda
    csr = with_random_weights(kronecker(12, 16, seed=1), low=1.0 / 256.0,
                              high=1.0, seed=2)
    return dev, build_slimsell(csr, C=8, L=128).to_torch(dev)


@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
@pytest.mark.parametrize("x_kind", ["all_inf", "sparse", "dense"])
@pytest.mark.parametrize("mask_kind", MASKS + ["one_hub_tile"])
@pytest.mark.parametrize("view", ["full", "light", "heavy", "poisoned"])
def test_weighted_kernel_equals_plain(sweep_layouts, view, mask_kind, x_kind,
                                      layout):
    """The stored-weight (min-plus) SpMV over the full ``wts``, its light /
    heavy views at the default delta, and the full ``wts`` with every
    padding slot's weight poisoned to -1000 (which must change nothing),
    exactly, on every layout of ``sweep_layouts``; a second call gives the
    same bits."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([len(view), len(mask_kind), len(x_kind),
                                 SWEEP_LAYOUTS.index(layout), 3])
    views = psssp.weight_views(tiled.wts, psssp.default_delta(tiled))
    w = {"full": tiled.wts, "light": views[0], "heavy": views[1],
         "poisoned": torch.where(tiled.cols < 0, -1000.0, tiled.wts)}[view]
    w_plain = tiled.wts if view == "poisoned" else w
    mask = _mask(mask_kind, tiled, rng, dev)
    x = rng.uniform(0.0, 8.0, tiled.n).astype(np.float32)
    x[rng.random(tiled.n) >= {"all_inf": 0.0, "sparse": 0.02,
                              "dense": 0.7}[x_kind]] = np.inf
    x = torch.from_numpy(x).to(dev)
    before = ops.SPMV_WTS.launches
    got = ops.spmv(psr.MINPLUS, tiled, x, tile_mask=mask, weights=w)
    again = ops.spmv(psr.MINPLUS, tiled, x, tile_mask=mask, weights=w)
    want = spmv_plain(psr.MINPLUS, tiled, x, mask, w_plain)
    torch.cuda.synchronize()
    assert ops.SPMV_WTS.launches == before + 2
    assert got.is_cuda and torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("x_kind", ["all_inf", "sparse", "dense"])
@pytest.mark.parametrize("poisoned", [False, True])
@pytest.mark.parametrize("width", [1, 5, 33, 64, 97, 160])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_weighted_spmm_kernel_equals_plain(cuda_weighted, mask_kind, width,
                                           poisoned, x_kind):
    """The stored-weight (min-plus) SpMM over the full ``wts``, exactly, at
    widths of one, two and three warps of lanes and past one lane tile
    (160: a second, partly used block along grid y). Poisoned padding
    weights (-1000) must change nothing."""
    dev, tiled = cuda_weighted
    rng = np.random.default_rng([MASKS.index(mask_kind), width, poisoned,
                                 len(x_kind), 4])
    w = torch.where(tiled.cols < 0, -1000.0, tiled.wts) if poisoned \
        else tiled.wts
    mask = _mask(mask_kind, tiled, rng, dev)
    X = rng.uniform(0.0, 8.0, (tiled.n, width)).astype(np.float32)
    X[rng.random(X.shape) >= {"all_inf": 0.0, "sparse": 0.02,
                              "dense": 0.7}[x_kind]] = np.inf
    X = torch.from_numpy(X).to(dev)
    before = ops.SPMM_WTS.launches
    got = ops.spmm(psr.MINPLUS, tiled, X, tile_mask=mask, weights=w)
    want = spmm_plain(psr.MINPLUS, tiled, X, mask, tiled.wts)
    torch.cuda.synchronize()
    assert ops.SPMM_WTS.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.parametrize("delta", [None, float("inf"), 0.05])
@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_multi_source_sssp_card_equals_cpu(cuda, mode, delta):
    """``multi_source_sssp`` on the card (the stored-weight SpMM kernel)
    against the plain path on the CPU: every field equal."""
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.graph500 import sample_roots
    dev, _ = cuda
    csr = with_random_weights(kronecker(10, 16, seed=1), low=1.0 / 256.0,
                              high=1.0, seed=2)
    host = build_slimsell(csr, C=8, L=128)
    roots = sample_roots(csr, 37)
    kw = dict(delta=delta, need_parents=True, log_work=True,
              config=EngineConfig(mode=mode))
    ref = multi_source_sssp(host.to_torch("cpu"), roots, device="cpu", **kw)
    before = ops.SPMM_WTS.launches
    got = multi_source_sssp(host.to_torch(dev), roots, device=dev, **kw)
    assert ops.SPMM_WTS.launches > before
    for f in ("distances", "parents", "sweeps", "buckets", "iterations",
              "work_log", "delta"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


@pytest.fixture(scope="module")
def cuda_l16(cuda):
    """The scale-12 graph at C=8, L=16: chunks of many narrow tiles."""
    dev, _ = cuda
    return dev, build_slimsell(kronecker(12, 16, seed=1), C=8, L=16).to_torch(dev)


@pytest.mark.parametrize("layout", ["L128", "L16"])
@pytest.mark.parametrize("width", [1, 5, 16, 33, 64, 160])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_gcn_kernel_equals_plain(request, mask_kind, width, layout):
    """The GCN-weighted SpMM (real, weight from deg) against its plain
    version: rtol = atol = 1e-5 (float32 sums in another order), no NaN on
    a graph with vertices of degree 0. 160 takes a second block along grid
    y."""
    dev, tiled = request.getfixturevalue("cuda" if layout == "L128"
                                         else "cuda_l16")
    rng = np.random.default_rng([MASKS.index(mask_kind), width, len(layout), 5])
    mask = _mask(mask_kind, tiled, rng, dev)
    X = torch.from_numpy(rng.standard_normal((tiled.n, width)).astype(
        np.float32)).to(dev)
    deg = tiled.deg.float()
    assert (deg == 0).any()
    before = ops.SPMM_GCN.launches
    got = ops.spmm(psr.REAL, tiled, X, tile_mask=mask, deg=deg)
    want = spmm_plain(psr.REAL, tiled, X, mask, deg=deg)
    torch.cuda.synchronize()
    assert ops.SPMM_GCN.launches == before + 1
    assert got.is_cuda and not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gcn_kernel_refuses_grad(cuda):
    """The kernel has no backward: with grad mode on and X requiring grad
    the wrapper raises; under no_grad it runs."""
    dev, tiled = cuda
    X = torch.randn(tiled.n, 16, device=dev, requires_grad=True)
    deg = tiled.deg.float()
    before = ops.SPMM_GCN.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.spmm(psr.REAL, tiled, X, deg=deg)
    assert ops.SPMM_GCN.launches == before
    with torch.no_grad():
        y = ops.spmm(psr.REAL, tiled, X, deg=deg)
    assert ops.SPMM_GCN.launches == before + 1 and not y.requires_grad


@pytest.mark.parametrize("aggregation", ["segment", "slimsell"])
def test_gcn_forward_card_equals_cpu(cuda, aggregation):
    """``gcn_forward`` at the gcn-cora widths on the card against the CPU:
    atol = rtol = 1e-4."""
    import dataclasses

    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.models.gnn import gcn_forward, gcn_init
    dev, _ = cuda
    csr = erdos_renyi(2708, 3.9, seed=6)
    host = build_slimsell(csr, C=8, L=16)
    cfg = dataclasses.replace(make_config(), aggregation=aggregation)
    rng = np.random.default_rng(6)
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    arrays = {"node_feat": torch.from_numpy(rng.standard_normal(
                  (csr.n, cfg.d_in)).astype(np.float32)),
              "edge_index": torch.from_numpy(np.stack([src, csr.indices]).astype(
                  np.int32)),
              "deg": torch.from_numpy(csr.deg.astype(np.int32))}
    params = gcn_init(cfg, device="cpu")
    out = {}
    for d in ("cpu", dev):
        batch = {k: v.to(d) for k, v in arrays.items()}
        batch["tiled"] = host.to_torch(d)
        with torch.inference_mode():
            out[str(d)] = gcn_forward({"w": [w.to(d) for w in params["w"]]},
                                      batch, cfg, device=d).cpu()
    torch.testing.assert_close(out[str(dev)], out["cpu"], rtol=1e-4, atol=1e-4)


# (V, d, B, K): the JAX test's sweep, then d = 16 and 130 (the scalar path),
# B = 1 and 13 (not multiples of 8)
BAG_CASES = [(500, 128, 16, 1), (1000, 128, 32, 8), (200, 256, 8, 4),
             (64, 16, 13, 3), (50, 130, 1, 5), (300, 128, 13, 1)]


@pytest.mark.parametrize("pads", ["none", "random", "empty"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,K", BAG_CASES)
def test_embedding_bag_kernel_equals_plain(cuda, V, d, B, K, mode, pads):
    """Kernel 7 against its plain version on the card, bit-equal: both add
    in slot order. Bags are a strided field of a [B, 3, K] id tensor."""
    from repro_torch.kernels.ref import embedding_bag_ref
    dev, _ = cuda
    rng = np.random.default_rng([V, d, B, K, len(mode), len(pads)])
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)).to(dev)
    low = 0 if pads == "none" else -1
    ids = rng.integers(low, V, size=(B, 3, K)).astype(np.int32)
    if pads != "none":
        ids[0, 1, :] = -1
    if pads == "empty":
        ids[:] = -1
    bags = torch.from_numpy(ids).to(dev)[:, 1]
    before = ops.EMBEDDING_BAG_GROUPED.launches
    got = ops.embedding_bag(table, bags, mode)
    want = embedding_bag_ref(table, bags, mode)
    torch.cuda.synchronize()
    assert ops.EMBEDDING_BAG_GROUPED.launches == before + 1
    assert got.is_cuda and got.shape == (B, d) and torch.equal(got, want)


def test_embedding_bag_kernel_ids_past_the_table(cuda):
    """An id at or past V is never read: its bag is NaN, as in the plain
    version, and the other bags are exact."""
    from repro_torch.kernels.ref import embedding_bag_ref
    dev, _ = cuda
    table = torch.randn(100, 128, device=dev)
    bags = torch.randint(-1, 100, (8, 3), dtype=torch.int32, device=dev)
    bags[2, 1], bags[5, 0] = 100, 2 ** 31 - 1
    got = ops.embedding_bag(table, bags)
    want = embedding_bag_ref(table, bags)
    torch.cuda.synchronize()
    bad = torch.tensor([2, 5], device=dev)
    ok = torch.tensor([0, 1, 3, 4, 6, 7], device=dev)
    assert torch.isnan(got[bad]).all() and torch.isnan(want[bad]).all()
    assert torch.equal(got[ok], want[ok])


def test_embedding_bag_kernel_refusals(cuda):
    """No backward: a table that requires grad is refused in grad mode and
    runs under no_grad. A float64 table, int64 bags, and bags on the CPU
    beside a card table, and more tables than one launch takes are
    refused; nothing launches."""
    dev, _ = cuda
    table = torch.randn(50, 16, device=dev, requires_grad=True)
    bags = torch.randint(-1, 50, (4, 2), dtype=torch.int32, device=dev)
    before = ops.EMBEDDING_BAG_GROUPED.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.embedding_bag(table, bags)
    with pytest.raises(TypeError, match="float32 table"):
        ops.embedding_bag(table.detach().double(), bags)
    with pytest.raises(TypeError, match="int32 bags"):
        ops.embedding_bag(table.detach(), bags.long())
    with pytest.raises(ValueError, match="bags on cpu"):
        ops.embedding_bag(table.detach(), bags.cpu())
    many = ops.MAX_TABLES + 1
    with pytest.raises(ValueError, match="at most"):
        ops.embedding_bag_grouped([table.detach()] * many,
                                  bags[:, None].expand(4, many, 2))
    assert ops.EMBEDDING_BAG_GROUPED.launches == before
    with torch.no_grad():
        y = ops.embedding_bag(table, bags)
    assert ops.EMBEDDING_BAG_GROUPED.launches == before + 1
    assert not y.requires_grad


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_forward_card_equals_cpu(cuda, multi_hot):
    """``dlrm_forward`` at the MLPerf widths, every table cut to 1,000
    rows, on the card against the CPU: atol = rtol = 1e-4; one launch of
    kernel 7 a forward, all 26 tables in it."""
    import dataclasses

    from repro_torch.configs.dlrm_mlperf import capped_config
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.models.dlrm import dlrm_forward, dlrm_init
    dev, _ = cuda
    cfg = dataclasses.replace(capped_config(1000), multi_hot=multi_hot)
    grouped = ops.EMBEDDING_BAG_GROUPED.launches
    params = dlrm_init(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    arrays = CriteoPipeline(cfg.vocabs, 64, multi_hot, seed=3).get_batch(0)
    sparse = arrays["sparse"]
    if multi_hot > 1:
        sparse[np.random.default_rng(3).random(sparse.shape) < 0.3] = -1
    out = {}
    for d in ("cpu", dev):
        batch = {"dense": torch.from_numpy(arrays["dense"]).to(d),
                 "sparse": torch.from_numpy(sparse).to(d)}
        p = {"tables": [t.to(d) for t in params["tables"]],
             **{k: [{n: v.to(d) for n, v in layer.items()} for layer in params[k]]
                for k in ("bot", "top")}}
        with torch.inference_mode():
            out[str(d)] = dlrm_forward(p, batch, cfg, device=d).cpu()
    assert ops.EMBEDDING_BAG_GROUPED.launches == grouped + 1
    torch.testing.assert_close(out[str(dev)], out["cpu"], rtol=1e-4, atol=1e-4)


def _hub_csr():
    """An Erdos-Renyi graph of 2^14 vertices with a hub joined to all of
    them, weighted for the min-plus mode."""
    from repro_torch.core.formats import build_csr
    n = 2 ** 14
    er = erdos_renyi(n, 8.0, seed=7)
    src = np.repeat(np.arange(n), np.diff(er.indptr))
    edges = np.concatenate([np.stack([src, er.indices], 1),
                            np.stack([np.zeros(n - 1, np.int64),
                                      np.arange(1, n)], 1)])
    return with_random_weights(build_csr(edges, n), low=1.0 / 256.0, high=1.0,
                               seed=7)


@pytest.fixture(scope="module")
def cuda_hub(cuda):
    """The hub graph at C=8, L=128: the hub's chunk has 128 tiles, cut
    into 64 pieces of the SpMM (and folded)."""
    dev, _ = cuda
    tiled = build_slimsell(_hub_csr(), C=8, L=128).to_torch(dev)
    assert int(tiled.tile_ptr[1] - tiled.tile_ptr[0]) >= 100
    return dev, tiled


@pytest.fixture(scope="module")
def sweep_layouts(cuda_weighted):
    """The SpMV's layouts by name, each built at its first use: the
    weighted scale-12 Kronecker graph (isolated vertices: chunks of length
    cl = 0) and the hub graph (its hub's chunk, 16,383 slots a row, cut into
    16 pieces of the SpMV), at C = 1, 3, 8 and 32 and L = 1 and 128; n =
    4096 and 16,384 at C = 3 leave padding rows (row_vertex -1) in the last
    chunk."""
    dev, kron = cuda_weighted
    csrs = {"kron": lambda: with_random_weights(
        kronecker(12, 16, seed=1), low=1.0 / 256.0, high=1.0, seed=2),
        "hub": _hub_csr}
    built = {"kron C8 L128": kron}

    def get(name):
        if name not in built:
            graph, c, width = name.split()
            built[name] = build_slimsell(csrs[graph](), C=int(c[1:]),
                                         L=int(width[1:])).to_torch(dev)
        return dev, built[name]
    return get


HUB_MODES = SEMIRINGS + ["minplus", "gcn"]
HUB_MASKS = MASKS + ["whole_chunks"]


@pytest.mark.parametrize("width", [1, 5, 16, 33, 64, 97, 160])
@pytest.mark.parametrize("mask_kind", HUB_MASKS)
@pytest.mark.parametrize("mode", HUB_MODES)
def test_spmm_hub_chunk_equals_plain(cuda_hub, mode, mask_kind, width):
    """The three SpMM modes where one chunk is split into many pieces and
    folded: exact for the implicit (4 semirings) and stored-weight modes,
    within the GCN tolerance (rtol = atol = 1e-5) for the GCN weight; the
    masks drop part of the hub's chunk or whole chunks."""
    dev, tiled = cuda_hub
    rng = np.random.default_rng([HUB_MODES.index(mode),
                                 HUB_MASKS.index(mask_kind), width, 8])
    if mask_kind == "whole_chunks":
        keep = torch.from_numpy(rng.random(tiled.n_chunks) < 0.6).to(dev)
        mask = keep[tiled.row_block.long()]
    else:
        mask = _mask(mask_kind, tiled, rng, dev)
    shape = (tiled.n, width)
    if mode == "minplus":
        X = rng.uniform(0.0, 8.0, shape).astype(np.float32)
        X[rng.random(shape) >= 0.5] = np.inf
        X = torch.from_numpy(X).to(dev)
        kernel, kw = ops.SPMM_WTS, dict(weights=tiled.wts)
        sr = psr.MINPLUS
    elif mode == "gcn":
        X = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        kernel, kw = ops.SPMM_GCN, dict(deg=tiled.deg.float())
        sr = psr.REAL
    else:
        sr = psr.get(mode)
        X = _operand(sr, shape, rng, dev)
        kernel, kw = ops.SPMM, {}
    before = kernel.launches
    got = ops.spmm(sr, tiled, X, tile_mask=mask, **kw)
    want = spmm_plain(sr, tiled, X, mask, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if mode == "gcn":
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert got.is_cuda and torch.equal(got, want)


def test_gcn_requests_bit_equal(cuda_hub):
    """Three GCN forwards of one batch on the card: the same bits (the
    SpMM folds its pieces in a fixed order, with no atomics)."""
    import dataclasses

    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.models.gnn import gcn_forward, gcn_init
    dev, tiled = cuda_hub
    cfg = dataclasses.replace(make_config(), d_in=64, aggregation="slimsell")
    params = gcn_init(cfg, generator=torch.Generator().manual_seed(8),
                      device=dev)
    batch = {"node_feat": torch.randn(tiled.n, cfg.d_in, device=dev),
             "deg": tiled.deg, "tiled": tiled,
             "edge_index": torch.zeros(2, 0, dtype=torch.int32, device=dev)}
    with torch.inference_mode():
        ys = [gcn_forward(params, batch, cfg, device=dev) for _ in range(3)]
    assert torch.isfinite(ys[0]).all()
    assert all(torch.equal(y, ys[0]) for y in ys[1:])


@pytest.mark.parametrize("out_kind", ["new", "stacked"])
@pytest.mark.parametrize("pads", ["none", "random", "empty"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [16, 128, 130, 256])
def test_embedding_bag_grouped_equals_per_table(cuda, d, mode, pads, out_kind):
    """The grouped kernel against ``embedding_bag`` table by table, bit for
    bit (one table is the same launch with T = 1): tables of different row
    counts; ids a strided [B, T, K] view; the output new or the [B, 1 + T,
    d] slice DLRM stacks; an id past V in one table only makes that
    table's bag NaN."""
    from repro_torch.kernels.ref import embedding_bag_grouped_ref
    dev, _ = cuda
    rng = np.random.default_rng([d, len(mode), len(pads), len(out_kind)])
    vocabs = [50, 3, 1000, 7, 400]
    tables = [torch.from_numpy(rng.standard_normal((v, d)).astype(
        np.float32)).to(dev) for v in vocabs]
    B, T, K = 37, len(vocabs), 3
    ids = np.stack([rng.integers(0 if pads == "none" else -1, v, size=(B, K))
                    for v in vocabs], 1).astype(np.int32)
    if pads == "empty":
        ids[:] = -1
    ids[4, 2, 1] = vocabs[2]  # past table 2's rows
    wide = torch.from_numpy(np.concatenate([ids, ids], 2)).to(dev)
    bags = wide[:, :, ::2]  # strided along K
    out = None
    if out_kind == "stacked":
        Z = torch.full((B, 1 + T, d), 7.0, device=dev)
        out = Z[:, 1:]
    before = ops.EMBEDDING_BAG_GROUPED.launches
    got = ops.embedding_bag_grouped(tables, bags, mode, out=out)
    assert ops.EMBEDDING_BAG_GROUPED.launches == before + 1
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(Z[:, 0], torch.full((B, d), 7.0, device=dev))
    for t, table in enumerate(tables):
        want = ops.embedding_bag(table, bags[:, t], mode)
        nan = torch.isnan(want).any(dim=1)
        assert torch.equal(torch.isnan(got[:, t]).any(dim=1), nan)
        assert torch.equal(got[:, t][~nan], want[~nan])
        assert nan.any().item() == (t == 2)
    ref = embedding_bag_grouped_ref(tables, bags, mode)
    ok = ~torch.isnan(ref)
    assert torch.equal(got[ok], ref[ok]) and torch.equal(torch.isnan(got), ~ok)


PIECE_WIDTHS = (1, 5, 33, 64, 97, 160)


def _pull_cases(sr, tiled, rng, dev, nf_kind="random"):
    """An operand and not-final bits 160 columns wide: the pull is column
    by column, so the plain result at 160 holds every narrower batch's in
    its first columns."""
    X = _operand(sr, (tiled.n, 160), rng, dev)
    if nf_kind == "random":
        nf = torch.from_numpy(rng.random((tiled.n, 160)) < 0.6).to(dev)
    else:
        nf = torch.full((tiled.n, 160), nf_kind == "all", dtype=torch.bool,
                        device=dev)
    return X, nf


def _pull_widths_equal_plain(sr, tiled, X, nf, mask, what):
    """The pull kernel at every width of ``PIECE_WIDTHS`` on the first
    columns of X and nf, each equal to those of one plain call at 160."""
    want = pull_mm_plain(sr, tiled, X, nf, mask)
    before = ops.PULL_MM.launches
    for width in PIECE_WIDTHS:
        got = ops.pull_mm(sr, tiled, X[:, :width].contiguous(),
                          nf[:, :width].contiguous(), tile_mask=mask)
        assert got.is_cuda and torch.equal(got, want[:, :width]), \
            (what, width)
    torch.cuda.synchronize()
    assert ops.PULL_MM.launches == before + len(PIECE_WIDTHS)


@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
@pytest.mark.parametrize("mask_kind", MASKS)
def test_pull_mm_pieces_equal_plain(sweep_layouts, mask_kind, layout):
    """The batched pull over the SpMV's pieces (the hub's chunk cut into
    16 and folded by its first hit), in 4 semirings at B = 1, 5, 33, 64,
    97 and 160, exactly, on every layout of ``sweep_layouts``."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([MASKS.index(mask_kind),
                                 SWEEP_LAYOUTS.index(layout), 9])
    mask = _mask(mask_kind, tiled, rng, dev)
    for name in SEMIRINGS:
        sr = psr.get(name)
        X, nf = _pull_cases(sr, tiled, rng, dev)
        _pull_widths_equal_plain(sr, tiled, X, nf, mask, name)


HUB_HITS = ["first", "middle", "last", "middle_and_last", "nf_all",
            "nf_none"]


@pytest.mark.parametrize("where", HUB_HITS)
@pytest.mark.parametrize("layout", ["hub C8 L128", "hub C8 L1"])
def test_pull_mm_hub_first_hit_piece(sweep_layouts, layout, where):
    """The hub's first hit only in the first, a middle or the last piece
    of its chunk (the hub's neighbours outside that piece hold the
    semiring zero), in a middle and the last piece with other values (a
    fold that is not the first hit's gives another value), and random
    operands with nf all true and all false: 4 semirings at B = 1, 5, 33,
    64, 97 and 160, exactly."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([HUB_HITS.index(where), len(layout), 10])
    items, _, _, _ = ops.spmv_work(tiled.tile_ptr, tiled.cl, tiled.L,
                                   ops.spmv_piece_tiles(tiled.L))
    rv = tiled.row_vertex.cpu().numpy()
    chunk, r = map(int, np.argwhere(rv == 0)[0])  # the hub's row
    hub = sorted(tuple(it) for it in items.tolist() if it[0] == chunk)
    assert len(hub) >= 3
    cols = tiled.cols.cpu().numpy()

    def leaves(piece):
        _, t0, slots, _ = hub[piece]
        c = cols[t0:t0 - (-slots // tiled.L), r].reshape(-1)
        return c[c >= 0]
    for name in SEMIRINGS:
        sr = psr.get(name)
        if where in ("nf_all", "nf_none"):
            X, nf = _pull_cases(sr, tiled, rng, dev, where[3:])
        else:
            X = torch.full((tiled.n, 160), sr.zero, dtype=sr.dtype)
            pieces = {"first": [0], "middle": [len(hub) // 2],
                      "last": [len(hub) - 1],
                      "middle_and_last": [len(hub) // 2, len(hub) - 1]}[where]
            for k, piece in enumerate(pieces):
                u = torch.from_numpy(leaves(piece))
                vals = rng.integers(1, 4, size=(u.numel(), 160)) * (10 ** k)
                X[u] = torch.from_numpy(vals).to(sr.dtype)
            X = X.to(dev)
            nf = torch.ones((tiled.n, 160), dtype=torch.bool, device=dev)
        _pull_widths_equal_plain(sr, tiled, X, nf, None, (name, where))


@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
@pytest.mark.parametrize("width", [1, 5, 33, 64, 97, 160])
@pytest.mark.parametrize("mask_kind", MASKS + ["one_hub_tile"])
def test_spmm_packed_pieces_equal_plain(sweep_layouts, mask_kind, width,
                                        layout):
    """The packed SpMM over the SpMV's items (the hub's chunk cut into
    pieces and ORed in piece order), at two frontier densities, exactly,
    on every layout of ``sweep_layouts``; the padding bits stay zero."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([len(mask_kind), width,
                                 SWEEP_LAYOUTS.index(layout), 11])
    mask = _mask(mask_kind, tiled, rng, dev)
    for density in (0.02, 0.5):
        bits = torch.from_numpy(rng.random((tiled.n, width)) < density).to(dev)
        x = packing.pack_bits(bits, axis=1)
        before = ops.SPMM_PACKED.launches
        got = ops.spmm_packed(tiled, x, tile_mask=mask)
        want = spmm_packed_plain(tiled, x, mask)
        torch.cuda.synchronize()
        assert ops.SPMM_PACKED.launches == before + 1
        assert got.is_cuda and torch.equal(got, want), density
        assert packing.check_tail_zero_host(got.cpu().numpy(), width)



# the single-source pull's and the packed SpMV's layouts: the SpMV's, and
# the hub graph at C=3, L=1 (its hub's chunk in 16 pieces of 1024 tiles,
# a lane a tile, padding rows in the last chunk)
SINGLE_LAYOUTS = SWEEP_LAYOUTS + ["hub C3 L1"]
SINGLE_MASKS = HUB_MASKS + ["one_hub_tile"]


def _any_mask(kind, tiled, rng, dev):
    """``_mask``, and "whole_chunks": about 60% of the chunks, whole."""
    if kind == "whole_chunks":
        keep = torch.from_numpy(rng.random(tiled.n_chunks) < 0.6).to(dev)
        return keep[tiled.row_block.long()]
    return _mask(kind, tiled, rng, dev)


def _pull_columns_equal_plain(sr, tiled, X, NF, mask, what):
    """The single-source pull kernel on each column of X [n, K] and NF
    bool[n, K], twice, against one plain call over all K columns: the
    plain pull is column by column (``pull_plain`` is ``pull_mm_plain`` of
    one column), and one call saves seconds a column on an L=1 layout,
    whose plain version loops over each of the hub chunk's 16,383 tile
    ranks. Equal, the same bits both times, one launch each."""
    want = pull_mm_plain(sr, tiled, X, NF, mask)
    before = ops.PULL.launches
    for j in range(X.shape[1]):
        x, nf = X[:, j].contiguous(), NF[:, j].contiguous()
        got = ops.pull(sr, tiled, x, nf, tile_mask=mask)
        again = ops.pull(sr, tiled, x, nf, tile_mask=mask)
        assert got.is_cuda and torch.equal(got, want[:, j]), (what, j)
        assert torch.equal(again, got), (what, j)
    torch.cuda.synchronize()
    assert ops.PULL.launches == before + 2 * X.shape[1]


@pytest.mark.parametrize("mask_kind", SINGLE_MASKS)
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_pull_pieces_equal_plain(sweep_layouts, layout, mask_kind):
    """The single-source pull over the SpMV's pieces (the hub's chunk cut
    into 16 and folded by its first hit), in 4 semirings with nf random
    and all true, exactly, on every layout, under the five masks of
    ``chip_smoke.py`` 7a and one keeping a single tile of the hub."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([SINGLE_LAYOUTS.index(layout),
                                 SINGLE_MASKS.index(mask_kind), 12])
    mask = _any_mask(mask_kind, tiled, rng, dev)
    for name in SEMIRINGS:
        sr = psr.get(name)
        X = _operand(sr, (tiled.n, 2), rng, dev)
        NF = torch.ones((tiled.n, 2), dtype=torch.bool, device=dev)
        NF[:, 0] = torch.from_numpy(rng.random(tiled.n) < 0.6).to(dev)
        _pull_columns_equal_plain(sr, tiled, X, NF, mask, name)


@pytest.mark.parametrize("layout", ["hub C8 L128", "hub C3 L1"])
def test_pull_hub_first_hit_piece(sweep_layouts, layout):
    """The hub's first hit only in the first, a middle or the last piece
    of its chunk (the hub's neighbours outside that piece hold the
    semiring zero), or in a middle and the last piece with other values (a
    fold that is not the first hit's gives another value), one column
    each: the single-source pull in 4 semirings, exactly."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([len(layout), 13])
    items, _, _, _ = ops.spmv_work(tiled.tile_ptr, tiled.cl, tiled.L,
                                   ops.spmv_piece_tiles(tiled.L))
    rv = tiled.row_vertex.cpu().numpy()
    chunk, r = map(int, np.argwhere(rv == 0)[0])  # the hub's row
    hub = sorted(tuple(it) for it in items.tolist() if it[0] == chunk)
    assert len(hub) >= 3
    cols = tiled.cols.cpu().numpy()
    mid, last = len(hub) // 2, len(hub) - 1
    placements = ([0], [mid], [last], [mid, last])
    for name in SEMIRINGS:
        sr = psr.get(name)
        X = torch.full((tiled.n, len(placements)), sr.zero, dtype=sr.dtype)
        for j, pieces in enumerate(placements):
            for k, piece in enumerate(pieces):
                _, t0, slots, _ = hub[piece]
                c = cols[t0:t0 - (-slots // tiled.L), r].reshape(-1)
                u = torch.from_numpy(c[c >= 0])
                X[u, j] = torch.from_numpy(rng.integers(1, 4, size=u.numel())
                                           * 10 ** k).to(sr.dtype)
        NF = torch.ones(X.shape, dtype=torch.bool, device=dev)
        _pull_columns_equal_plain(sr, tiled, X.to(dev), NF, None, name)


@pytest.mark.parametrize("mask_kind", SINGLE_MASKS)
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_spmv_packed_pieces_equal_plain(sweep_layouts, layout, mask_kind):
    """The packed SpMV over the SpMV's items (each piece ORing its rows'
    bits into the zeroed bitmap), at two frontier densities, exactly and
    the same bits twice, on every layout; the tail bits stay zero."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([SINGLE_LAYOUTS.index(layout),
                                 SINGLE_MASKS.index(mask_kind), 14])
    mask = _any_mask(mask_kind, tiled, rng, dev)
    for density in (0.02, 0.5):
        bits = torch.from_numpy(rng.random(tiled.n) < density).to(dev)
        x = packing.pack_bits(bits)
        before = ops.SPMV_PACKED.launches
        got = ops.spmv_packed(tiled, x, tile_mask=mask)
        again = ops.spmv_packed(tiled, x, tile_mask=mask)
        want = spmv_packed_plain(tiled, x, mask)
        torch.cuda.synchronize()
        assert ops.SPMV_PACKED.launches == before + 2
        assert got.is_cuda and torch.equal(got, want), density
        assert torch.equal(again, got)
        assert packing.check_tail_zero_host(got.cpu().numpy(), tiled.n)


# PageRank's and CC's payloads through kernel 1: the real mode sums floats
# in another order than the plain version (within rtol 1e-4, atol 1e-9,
# the bounds of chip_smoke.py's PageRank checks); the sel-max mode carries
# every vertex's 1-based label, exactly
@pytest.mark.parametrize("mask_kind", SINGLE_MASKS)
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_real_kernel_on_pagerank_payloads(sweep_layouts, layout, mask_kind):
    """x = r / deg for ranks r on the simplex (degree-0 vertices send 0),
    as PageRank's sweep takes it: within the bounds of plain, and the
    same bits on a second call (no atomics)."""
    from repro_torch.core.pagerank import pagerank_views
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([SINGLE_LAYOUTS.index(layout),
                                 SINGLE_MASKS.index(mask_kind), 25])
    mask = _any_mask(mask_kind, tiled, rng, dev)
    r = torch.from_numpy(rng.dirichlet(np.ones(tiled.n)).astype(np.float32))
    x = (r.to(dev) * pagerank_views(tiled.deg)[0]).contiguous()
    before = ops.SPMV.launches
    got = ops.spmv(psr.REAL, tiled, x, tile_mask=mask)
    again = ops.spmv(psr.REAL, tiled, x, tile_mask=mask)
    want = spmv_plain(psr.REAL, tiled, x, mask)
    torch.cuda.synchronize()
    assert ops.SPMV.launches == before + 2
    assert got.is_cuda and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-9)
    assert torch.equal(again, got)


@pytest.mark.parametrize("mask_kind", SINGLE_MASKS)
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_selmax_kernel_on_every_label(sweep_layouts, layout, mask_kind):
    """x = 1..n (CC's first sweep, every vertex its own label), exactly."""
    dev, tiled = sweep_layouts(layout)
    rng = np.random.default_rng([SINGLE_LAYOUTS.index(layout),
                                 SINGLE_MASKS.index(mask_kind), 26])
    mask = _any_mask(mask_kind, tiled, rng, dev)
    x = torch.arange(1, tiled.n + 1, dtype=torch.float32, device=dev)
    before = ops.SPMV.launches
    got = ops.spmv(psr.SELMAX, tiled, x, tile_mask=mask)
    want = spmv_plain(psr.SELMAX, tiled, x, mask)
    torch.cuda.synchronize()
    assert ops.SPMV.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


# Betweenness through kernel 2's real mode: the path counts and the
# fractions (1 + delta) / sigma are float sums in the kernel's order, held
# within the bounds of chip_smoke.py's BC_* checks: sweeps and depths
# equal, path counts bit-equal below 2^24 (within rtol 1e-5 past it),
# scores within rtol 1e-4 and atol 1e-6 x the CPU run's largest
@pytest.mark.parametrize("slimwork", [True, False], ids=["slimwork", "all"])
@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_betweenness_card_equals_cpu(cuda, mode, slimwork):
    from repro_torch.core import engine as peng
    from repro_torch.core.betweenness import (BRANDES_FORWARD_SPEC,
                                              betweenness)
    from repro_torch.core.options import EngineConfig
    dev, tiled = cuda
    cpu = build_slimsell(kronecker(12, 16, seed=1), C=8, L=128).to_torch(
        "cpu")
    roots = np.sort(np.random.default_rng(26).choice(tiled.n, 24,
                                                     replace=False))
    kw = dict(batch_size=10, slimwork=slimwork, config=EngineConfig(mode=mode))
    before = ops.SPMM.launches
    got = betweenness(tiled, roots, device=dev, **kw)
    assert ops.SPMM.launches > before
    want = betweenness(cpu, roots, device="cpu", **kw)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                               atol=1e-6 * want.scores.max())
    fwd = peng.run_fused(BRANDES_FORWARD_SPEC, tiled, torch.from_numpy(roots),
                         slimwork=slimwork, max_iters=tiled.n + 1)
    ref = peng.run_fused(BRANDES_FORWARD_SPEC, cpu, torch.from_numpy(roots),
                         slimwork=slimwork, max_iters=tiled.n + 1)
    assert fwd.iterations == ref.iterations
    assert torch.equal(fwd.state["d"].cpu(), ref.state["d"])
    sigma, sigma0 = fwd.state["sigma"].cpu(), ref.state["sigma"]
    exact = sigma0 < 2 ** 24
    assert torch.equal(sigma[exact], sigma0[exact])
    torch.testing.assert_close(sigma[~exact], sigma0[~exact], rtol=1e-5,
                               atol=0.0)


# The serving dispatcher on the card: a mixed stream of all six algorithms
# through Batcher and Dispatcher (max_inflight=2), each result bit-equal to
# the card's front-door call for its bucket (the same kernels in the same
# order, so the float results too)
@pytest.mark.parametrize("mode", ["fused", "hostloop"])
def test_dispatcher_card_equals_front_doors(cuda, mode):
    from repro_torch.core.betweenness import betweenness
    from repro_torch.core.cc import cc
    from repro_torch.core.khop import khop_many
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import pagerank
    from repro_torch.serving import (Batcher, Dispatcher, Query,
                                     ServingMetrics)
    dev, _ = cuda
    csr = with_random_weights(kronecker(9, 8, seed=1), seed=2)
    tiled = build_slimsell(csr, C=8, L=32).to_torch(dev)
    cfg = EngineConfig(mode=mode)
    roots = [int(r) for r in np.random.default_rng(27).choice(csr.n, 5,
                                                              replace=False)]
    buckets = [dict(algorithm="bfs", semiring=s) for s in
               ("tropical", "real", "boolean", "selmax")]
    buckets += [dict(algorithm="bfs", semiring="boolean", packed=True),
                dict(algorithm="sssp", semiring="minplus", delta=2.0),
                dict(algorithm="khop", semiring="boolean", k=2),
                dict(algorithm="khop", semiring="boolean", k=2, packed=True)]
    qs = [dict(b, root=r, need_parents=b["algorithm"] in ("bfs", "sssp"))
          for b in buckets for r in roots]
    qs += [dict(algorithm="cc", semiring="selmax", root=None),
           dict(algorithm="cc", semiring="boolean", root=None),
           dict(algorithm="pagerank", semiring="real", root=None,
                damping=0.85, tol=1e-6),
           dict(algorithm="betweenness", semiring="real", root=None)]
    batcher = Batcher(max_batch=8)
    for qid, q in enumerate(qs):
        batcher.add(Query(qid=qid, delta=q.pop("delta", None),
                          need_parents=q.pop("need_parents", False),
                          deadline_at=None, submitted_at=0.0, **q))
    disp = Dispatcher(tiled, cfg, ServingMetrics(), max_inflight=2,
                      device=dev)
    for slot in batcher.drain(0.0)[0]:
        disp.dispatch(slot)
    disp.drain()
    res = disp.results
    assert len(res) == len(qs)
    kw = dict(config=cfg, device=dev)
    for i, b in enumerate(buckets):
        got = [res[i * len(roots) + j] for j in range(len(roots))]
        packed = b.get("packed", False)
        if b["algorithm"] == "bfs":
            want = multi_source_bfs(tiled, roots, b["semiring"],
                                    need_parents=True, packed=packed, **kw)
        elif b["algorithm"] == "sssp":
            want = multi_source_sssp(tiled, roots, delta=2.0,
                                     need_parents=True, **kw)
            assert [(g.sweeps, g.buckets) for g in got] == \
                list(zip(want.sweeps.tolist(), want.buckets.tolist()))
        else:
            want = khop_many(tiled, roots, 2, packed=packed, **kw)
        for j, g in enumerate(got):
            np.testing.assert_array_equal(g.values, want.distances[j])
            if b["algorithm"] != "khop":
                np.testing.assert_array_equal(g.parents, want.parents[j])
    whole = [res[len(buckets) * len(roots) + j] for j in range(4)]
    for g, want in zip(whole[:2], (cc(tiled, **kw),
                                   cc(tiled, semiring="boolean", **kw))):
        np.testing.assert_array_equal(g.labels, want.labels)
        assert (g.sweeps, g.n_components) == (want.iterations,
                                              want.n_components)
    want = pagerank(tiled, damping=0.85, tol=1e-6, **kw)
    np.testing.assert_array_equal(whole[2].ranks, want.ranks)
    assert whole[2].sweeps == want.iterations
    want = betweenness(tiled, **kw)
    np.testing.assert_array_equal(whole[3].scores, want.scores)
    assert whole[3].sweeps == want.iterations


# The serving session on the card: four producer threads and the session's
# flush thread, which launches the kernels; every result bit-equal to the
# card's front door for its query, the counters reconciled, the thread
# ended by close()
def test_session_flush_thread_card_equals_front_doors(cuda):
    import threading
    from repro_torch.core.bfs import bfs
    from repro_torch.core.khop import khop
    from repro_torch.core.sssp import sssp
    from repro_torch.serving import GraphSession
    dev, _ = cuda
    csr = with_random_weights(kronecker(9, 8, seed=1), seed=2)
    tiled = build_slimsell(csr, C=8, L=32).to_torch(dev)
    roots = [int(r) for r in np.random.default_rng(28).choice(csr.n, 24,
                                                              replace=False)]
    plan = [(("bfs", r), dict(semiring=s, need_parents=s == "tropical"))
            for r in roots for s in ("tropical", "selmax")]
    plan += [(("sssp", r), dict(delta=2.0)) for r in roots[:12]]
    plan += [(("khop", r), dict(k=2, packed=True)) for r in roots[:12]]
    sess = GraphSession(tiled, max_batch=16, max_inflight=2,
                        background=True, device=dev)
    assert sess.tiled is tiled
    results = [None] * len(plan)

    def producer(t):
        hs = [(i, sess.submit(*plan[i][0], **plan[i][1]))
              for i in range(t, len(plan), 4)]
        for i, h in hs:
            results[i] = h.result()

    threads = [threading.Thread(target=producer, args=(t,), daemon=True)
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    flusher = sess._flush_thread
    st = sess.stats()
    sess.close()
    assert not flusher.is_alive()
    assert st["submitted"] == st["completed"] == len(plan)
    for ((alg, r), kw), got in zip(plan, results):
        assert got is not None and got.ok
        if alg == "bfs":
            want = bfs(tiled, r, kw["semiring"],
                       need_parents=kw["need_parents"], device=dev)
            if kw["need_parents"]:
                np.testing.assert_array_equal(got.parents, want.parents)
        elif alg == "sssp":
            want = sssp(tiled, r, delta=2.0, device=dev)
            assert (got.sweeps, got.buckets) == (want.sweeps, want.buckets)
        else:
            want = khop(tiled, r, 2, packed=True, device=dev)
        np.testing.assert_array_equal(got.distances, want.distances)


# The distributed strategy's shard views: every kernel on its path (1, 1w,
# 2, 2w, 3, 4, 6) over each block of a 2 x 2 partition equals its plain
# version on the same shard (localized operand of n_col rows, vertex-space
# result of n rows, the rows of other shards left at the semiring zero);
# then a 2 x 2 gloo world of processes sharing the card against the
# single-device port on the card
@pytest.mark.parametrize("name", SEMIRINGS)
def test_dist_shard_kernels_equal_plain(cuda, name):
    from repro_torch.core.dist_bfs import partition_slimsell, shard
    dev, _ = cuda
    sr = psr.get(name)
    csr = with_random_weights(kronecker(11, 16, seed=3), seed=4)
    part = partition_slimsell(csr, 2, 2, C=8, L=128, device=dev)
    rng = np.random.default_rng(29)
    for i in range(2):
        for j in range(2):
            t = shard(part, i, j).to_torch(dev)
            for mask_kind in MASKS:
                mask = _mask(mask_kind, t, rng, dev)
                for width in (None, 5, 64):
                    shape = (t.n_x,) if width is None else (t.n_x, width)
                    x = _operand(sr, shape, rng, dev)
                    nf = torch.from_numpy(rng.random(
                        (t.n,) + shape[1:]) < 0.5).to(dev)
                    if width is None:
                        got = ops.spmv(sr, t, x, tile_mask=mask)
                        want = spmv_plain(sr, t, x, mask)
                        pulled = ops.pull(sr, t, x, nf, tile_mask=mask)
                        pull_want = pull_plain(sr, t, x, nf, mask)
                    else:
                        got = ops.spmm(sr, t, x, tile_mask=mask)
                        want = spmm_plain(sr, t, x, mask)
                        pulled = ops.pull_mm(sr, t, x, nf, tile_mask=mask)
                        pull_want = pull_mm_plain(sr, t, x, nf, mask)
                    assert got.shape == (t.n,) + shape[1:]
                    assert torch.equal(got, want), (i, j, mask_kind, width)
                    assert torch.equal(pulled, pull_want), (i, j, mask_kind,
                                                            width)
                    if name != "tropical":
                        continue
                    xw = torch.where(torch.isinf(x), x, x / 3.0)
                    got = (ops.spmv if width is None else ops.spmm)(
                        psr.MINPLUS, t, xw, tile_mask=mask, weights=t.wts)
                    want = (spmv_plain if width is None else spmm_plain)(
                        psr.MINPLUS, t, xw, mask, t.wts)
                    assert torch.equal(got, want), (i, j, mask_kind, width)
                    words = torch.from_numpy(rng.integers(
                        -2 ** 31, 2 ** 31, (t.n_x, 2)).astype(np.int32)).to(dev)
                    assert torch.equal(
                        ops.spmm_packed(t, words, tile_mask=mask),
                        spmm_packed_plain(t, words, mask))


def test_dist_world_on_card_equals_single_device(cuda, tmp_path):
    from repro_torch.core.bfs import bfs
    from repro_torch.core.dist_bfs import (partition_slimsell, run_cases,
                                           save_partition)
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.distributed import launch
    dev, _ = cuda
    csr = with_random_weights(kronecker(10, 16, seed=3), seed=4)
    save_partition(partition_slimsell(csr, 2, 2, C=8, L=128, device=dev),
                   str(tmp_path))
    tiled = build_slimsell(csr, C=8, L=128).to_torch(dev)
    root = int(np.argmax(csr.deg))
    roots = [int(r) for r in np.random.default_rng(3).choice(
        np.nonzero(csr.deg)[0], 40, replace=False)]
    cases = [dict(factory="bfs", partition=str(tmp_path), args=[root],
                  kwargs=dict(direction=d, comm=c))
             for d in ("push", "pull", "auto")
             for c in ("allreduce", "reduce_gather")]
    cases += [dict(factory="multi_bfs", partition=str(tmp_path), args=[roots],
                   kwargs=dict(direction="auto", slimwork=True)),
              dict(factory="multi_bfs", partition=str(tmp_path), args=[roots],
                   kwargs=dict(sr_name="boolean", packed=True,
                               batch_width=len(roots))),
              dict(factory="multi_sssp", partition=str(tmp_path),
                   args=[roots, 0.5], kwargs={})]
    ranks = launch(run_cases, (2, 2), ("data", "model"), (cases,),
                   backend="gloo", device=dev, timeout=300)
    out = [o["result"] for o in ranks[0]]
    for d in range(6):
        want = bfs(tiled, root, device=dev,
                   config=EngineConfig(direction=("push", "pull",
                                                  "auto")[d // 2]))
        np.testing.assert_array_equal(out[d][0], want.distances)
        assert int(out[d][1]) == want.iterations
    want = multi_source_bfs(tiled, roots, device=dev)
    np.testing.assert_array_equal(out[6][0], want.distances)
    np.testing.assert_array_equal(out[7][0], want.distances)
    ms = multi_source_sssp(tiled, roots, delta=0.5, device=dev)
    np.testing.assert_array_equal(out[8][0], ms.distances)
    np.testing.assert_array_equal(out[8][2], ms.sweeps)
    for rank in ranks:
        assert all(o["launches"] for o in rank)   # the kernels ran


# The analysis layer on the card: the semiring probe against the port's
# table, each kernel's sweep under the sanitizer (its layout checked, its
# result read for NaN, poison infinities and tail bits) equal to its plain
# version, and a corrupt layout refused before any launch
def test_analysis_probe_equals_the_table(cuda):
    from repro_torch.analysis import laws
    dev, _ = cuda
    assert laws.cross_check_kernel_tables() == []
    assert laws.cross_check_probe(dev) == []


ANALYSIS_KERNELS = ["slimsell_spmv", "slimsell_spmv_wts", "slimsell_spmm",
                    "slimsell_spmm_wts", "slimsell_spmm_gcn", "slimsell_pull",
                    "slimsell_pull_mm", "slimsell_spmv_packed",
                    "slimsell_spmm_packed", "embedding_bag_grouped"]


@pytest.mark.parametrize("kernel", ANALYSIS_KERNELS)
def test_analysis_sanitized_sweep_of_each_kernel(cuda_weighted, kernel):
    from repro_torch.core import debug
    from repro_torch.kernels.ref import embedding_bag_ref
    dev, t = cuda_weighted
    rng = np.random.default_rng(30)
    trop, real, mp = psr.TROPICAL, psr.REAL, psr.MINPLUS
    x = _operand(trop, (t.n,), rng, dev)
    X = _operand(trop, (t.n, 5), rng, dev)
    nf = torch.from_numpy(rng.random(t.n) < 0.5).to(dev)
    NF = torch.from_numpy(rng.random((t.n, 5)) < 0.5).to(dev)
    F = torch.from_numpy(rng.standard_normal((t.n, 5)).astype(
        np.float32)).to(dev)
    words = packing.pack_bits(torch.from_numpy(rng.random(t.n) < 0.1)
                              .to(dev))
    planes = packing.pack_bits(torch.from_numpy(rng.random((t.n, 40)) < 0.1)
                               .to(dev), axis=1)
    deg = t.deg.float()
    tab = torch.from_numpy(rng.standard_normal((300, 16)).astype(
        np.float32)).to(dev)
    bags = torch.from_numpy(rng.integers(-1, 300, (64, 3)).astype(
        np.int32)).to(dev)
    sweeps = {
        "slimsell_spmv": (trop, None, lambda: ops.spmv(trop, t, x),
                          lambda: spmv_plain(trop, t, x, None)),
        "slimsell_spmv_wts": (mp, None,
                              lambda: ops.spmv(mp, t, x, weights=t.wts),
                              lambda: spmv_plain(mp, t, x, None, t.wts)),
        "slimsell_spmm": (trop, None, lambda: ops.spmm(trop, t, X),
                          lambda: spmm_plain(trop, t, X, None)),
        "slimsell_spmm_wts": (mp, None,
                              lambda: ops.spmm(mp, t, X, weights=t.wts),
                              lambda: spmm_plain(mp, t, X, None, t.wts)),
        "slimsell_spmm_gcn": (real, None,
                              lambda: ops.spmm(real, t, F, deg=deg),
                              lambda: spmm_plain(real, t, F, None, deg=deg)),
        "slimsell_pull": (trop, None, lambda: ops.pull(trop, t, x, nf),
                          lambda: pull_plain(trop, t, x, nf, None)),
        "slimsell_pull_mm": (trop, None, lambda: ops.pull_mm(trop, t, X, NF),
                             lambda: pull_mm_plain(trop, t, X, NF, None)),
        "slimsell_spmv_packed": (psr.BOOLEAN_PACKED, t.n,
                                 lambda: ops.spmv_packed(t, words),
                                 lambda: spmv_packed_plain(t, words, None)),
        "slimsell_spmm_packed": (psr.BOOLEAN_PACKED, 40,
                                 lambda: ops.spmm_packed(t, planes),
                                 lambda: spmm_packed_plain(t, planes, None)),
        "embedding_bag_grouped": (real, None,
                                  lambda: ops.embedding_bag(tab, bags),
                                  lambda: embedding_bag_ref(tab, bags)),
    }
    sr, n_bits, kern, plain = sweeps[kernel]
    before = ops.launch_counts()[kernel]
    with debug.checked():
        if kernel == "embedding_bag_grouped":
            debug.check_gather(bags[bags >= 0], tab.shape[0])
        else:
            debug.check_layout(t)
        got = kern()
        debug.check_sweep(sr, got, n_bits)
    assert ops.launch_counts()[kernel] == before + 1
    want = plain()
    if kernel == "slimsell_spmm_gcn":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


def test_analysis_corrupt_layout_refused_before_any_launch(cuda_weighted):
    import dataclasses
    from repro_torch.core import debug
    from repro_torch.core.bfs import bfs
    from repro_torch.core.options import EngineConfig
    dev, t = cuda_weighted
    cols = t.cols.clone()
    cols.view(-1)[int(torch.nonzero(cols.reshape(-1) >= 0)[0])] = t.n + 7
    bad = dataclasses.replace(t, cols=cols)
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        with pytest.raises(debug.SanitizerError,
                           match="out-of-bounds vertex ids"):
            bfs(bad, 0, config=EngineConfig(mode=mode, sanitize=True),
                device=dev)
        torch.cuda.synchronize()
        assert ops.launch_counts() == before


# ------------------------------------------------------------- training


@pytest.mark.parametrize("width", [1, 16, 33])
def test_train_gcn_aggregate_grad_equals_plain(cuda, width):
    """Kernel 2g under autograd: the gradient of X is the same sweep over
    the output's gradient, held within 1e-5 of autograd of the plain
    version on the card; two launches (forward, backward)."""
    from repro_torch.kernels import autograd
    dev, tiled = cuda
    g = torch.Generator(device=dev).manual_seed(width)
    X = torch.randn((tiled.n, width), generator=g, device=dev)
    R = torch.randn((tiled.n, width), generator=g, device=dev)
    deg = tiled.deg.float()
    before = ops.SPMM_GCN.launches
    Xa = X.clone().requires_grad_(True)
    got, = torch.autograd.grad((autograd.gcn_aggregate(tiled, Xa, deg) * R).sum(),
                               [Xa])
    assert ops.SPMM_GCN.launches == before + 2
    Xb = X.clone().requires_grad_(True)
    want, = torch.autograd.grad((spmm_plain(psr.REAL, tiled, Xb, deg=deg) * R).sum(),
                                [Xb])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_train_bag_lookup_grad_equals_plain(cuda, mode):
    """Kernel 7 under autograd: one launch forward, the tables' gradients
    by index_add_ within 1e-5 of autograd of the plain version on the
    card, relative to the summed magnitudes each element receives (atomics
    add in no fixed order, and a row's sum may cancel); pads and ids past
    a table add nothing."""
    from repro_torch.kernels import autograd
    from repro_torch.kernels.ref import embedding_bag_grouped_ref
    dev, _ = cuda
    rng = np.random.default_rng(len(mode))
    vocabs, d, B, K = (7, 1000, 1, 50), 128, 256, 3
    tables = [torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(dev)
              for v in vocabs]
    ids = np.stack([rng.integers(-1, v, (B, K)) for v in vocabs], 1).astype(np.int32)
    ids[5, 1, 0] = vocabs[1]
    bags = torch.from_numpy(ids).to(dev)
    R = torch.randn((B, len(vocabs), d), device=dev)
    ta = [t.clone().requires_grad_(True) for t in tables]
    before = ops.EMBEDDING_BAG_GROUPED.launches
    got = torch.autograd.grad(autograd.bag_lookup(ta, bags, mode), ta,
                              grad_outputs=R)
    assert ops.EMBEDDING_BAG_GROUPED.launches == before + 1
    tb = [t.clone().requires_grad_(True) for t in tables]
    ref = embedding_bag_grouped_ref(tb, bags, mode)
    want = torch.autograd.grad(ref, tb, grad_outputs=R, retain_graph=True)
    mag = torch.autograd.grad(ref, tb, grad_outputs=R.abs())
    for a, b, m in zip(got, want, mag):
        assert torch.isfinite(a).all()
        assert ((a - b).abs() <= 1e-5 * m + 1e-30).all()


def test_train_steps_card_equal_cpu(cuda):
    """Three AdamW steps of the reduced DLRM and of a gcn-cora GCN on the
    card against the CPU: losses and grad norms within 1e-4, weights
    within 1e-4; kernel 7 once a DLRM step, 2g four times a GCN step."""
    import dataclasses

    from repro_torch import convert, optim
    from repro_torch.configs.dlrm_mlperf import reduced_config
    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.models import dlrm, gnn
    from repro_torch.train import make_train_step
    dev, _ = cuda
    cfg = reduced_config()
    gcfg = dataclasses.replace(make_config(), aggregation="slimsell")
    csr = erdos_renyi(2708, 3.9, seed=6)
    host = build_slimsell(csr, C=8, L=16)
    rng = np.random.default_rng(6)
    gbatch = {"node_feat": torch.from_numpy(rng.standard_normal(
                  (csr.n, gcfg.d_in)).astype(np.float32)),
              "deg": torch.from_numpy(csr.deg.astype(np.int32)),
              "labels": torch.from_numpy(rng.integers(0, 16, csr.n).astype(np.int32)),
              "train_mask": torch.from_numpy((rng.random(csr.n) < 0.05).astype(
                  np.float32))}
    arrays = CriteoPipeline(cfg.vocabs, 256, 1, seed=4).get_batch(0)
    out = {}
    for d in ("cpu", dev):
        dp = dlrm.dlrm_init(cfg, generator=torch.Generator().manual_seed(4),
                            device="cpu")
        dp = {"tables": [t.to(d) for t in dp["tables"]],
              **{k: [{n: v.to(d) for n, v in l.items()} for l in dp[k]]
                 for k in ("bot", "top")}}
        db = convert.dlrm_batch_from_arrays(arrays, device=d)
        gp = {"w": [w.to(d) for w in gnn.gcn_init(gcfg, device="cpu")["w"]]}
        gb = {k: v.to(d) for k, v in gbatch.items()}
        gb["tiled"] = host.to_torch(d)
        runs = []
        for loss, p, b, kernel in (
                (lambda p, b: dlrm.dlrm_loss(p, b, cfg, device=d), dp, db,
                 ops.EMBEDDING_BAG_GROUPED),
                (lambda p, b: gnn.gcn_loss(p, b, gcfg, device=d), gp, gb,
                 ops.SPMM_GCN)):
            step, init = make_train_step(loss, optim.adamw())
            s = init(p)
            before = kernel.launches
            metrics = []
            for _ in range(3):
                p, s, m = step(p, s, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((metrics, p, kernel.launches - before))
        out[str(d)] = runs
    (dl_cpu, dp_cpu, _), (gl_cpu, gp_cpu, _) = out["cpu"]
    (dl_dev, dp_dev, k7), (gl_dev, gp_dev, k2g) = out[str(dev)]
    assert k7 == 3 and k2g == 12
    np.testing.assert_allclose(dl_dev, dl_cpu, rtol=1e-4)
    np.testing.assert_allclose(gl_dev, gl_cpu, rtol=1e-4)
    from repro_torch import pytree
    for a, b in zip(pytree.leaves(dp_dev) + pytree.leaves(gp_dev),
                    pytree.leaves(dp_cpu) + pytree.leaves(gp_cpu)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4,
                                   atol=1e-4)


def test_train_muon_step_card_equals_cpu(cuda):
    """One Muon step of a stacked [3, 64, 32] leaf (bfloat16 Newton-Schulz)
    on the card against the CPU: the orthogonalised update, the weights'
    step over lr * scale, within the CPU test's bound on Newton-Schulz
    (rtol = atol = 2e-2), the bfloat16 momentum bit-equal."""
    from repro_torch import optim
    dev, _ = cuda
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((3, 64, 32)).astype(np.float32) * 0.1
    g0 = rng.standard_normal((3, 64, 32)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        p = {"w": torch.tensor(p0, device=d)}
        opt = optim.muon()
        st = opt.init(p)
        opt.update({"w": torch.tensor(g0, device=d)}, st, p,
                   torch.zeros((), dtype=torch.int32, device=d))
        out[str(d)] = ((torch.tensor(p0) - p["w"].cpu()) / (0.02 * 2 ** 0.5),
                       st["w"]["mom"].cpu())
    torch.testing.assert_close(out[str(dev)][0], out["cpu"][0], rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(out[str(dev)][1].view(torch.int16),
                       out["cpu"][1].view(torch.int16))


def test_train_checkpoint_restores_on_card(cuda, tmp_path):
    """A state saved from the card restores onto it bit for bit."""
    from repro_torch.checkpoint import store
    dev, _ = cuda
    tree = {"w": [torch.randn(5, 3, device=dev)],
            "mom": torch.randn(4, device=dev).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32, device=dev)}
    store.save(str(tmp_path), 7, tree)
    got, _ = store.restore(str(tmp_path), 7, tree, device=dev)
    assert got["w"][0].is_cuda and torch.equal(got["w"][0], tree["w"][0])
    assert torch.equal(got["mom"].view(torch.int16), tree["mom"].view(torch.int16))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
