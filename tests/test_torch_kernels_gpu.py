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


@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_kernel_equals_plain(cuda, name, mask_kind, width):
    dev, tiled = cuda
    rng = np.random.default_rng([SEMIRINGS.index(name), MASKS.index(mask_kind),
                                 width or 0])
    sr = psr.get(name)
    mask = _mask(mask_kind, tiled, rng, dev)
    x = _operand(sr, (tiled.n,) if width is None else (tiled.n, width), rng, dev)
    kernel = ops.SPMV if width is None else ops.SPMM
    before = kernel.launches
    if width is None:
        got, want = ops.spmv(sr, tiled, x, tile_mask=mask), spmv_plain(sr, tiled, x, mask)
    else:
        got, want = ops.spmm(sr, tiled, x, tile_mask=mask), spmm_plain(sr, tiled, x, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


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


@pytest.mark.parametrize("x_kind", ["all_inf", "sparse", "dense"])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("view", ["full", "light", "heavy"])
def test_weighted_kernel_equals_plain(cuda_weighted, view, mask_kind, x_kind):
    """The stored-weight (min-plus) SpMV over the full ``wts`` and its
    light / heavy views at the default delta, exactly."""
    dev, tiled = cuda_weighted
    rng = np.random.default_rng([len(view), MASKS.index(mask_kind),
                                 len(x_kind), 3])
    views = psssp.weight_views(tiled.wts, psssp.default_delta(tiled))
    w = {"full": tiled.wts, "light": views[0], "heavy": views[1]}[view]
    mask = _mask(mask_kind, tiled, rng, dev)
    x = rng.uniform(0.0, 8.0, tiled.n).astype(np.float32)
    x[rng.random(tiled.n) >= {"all_inf": 0.0, "sparse": 0.02,
                              "dense": 0.7}[x_kind]] = np.inf
    x = torch.from_numpy(x).to(dev)
    before = ops.SPMV_WTS.launches
    got = ops.spmv(psr.MINPLUS, tiled, x, tile_mask=mask, weights=w)
    want = spmv_plain(psr.MINPLUS, tiled, x, mask, w)
    torch.cuda.synchronize()
    assert ops.SPMV_WTS.launches == before + 1
    assert got.is_cuda and torch.equal(got, want)


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
