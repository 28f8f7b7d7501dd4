"""The port's plain SpMV and SpMM (what a CPU tensor runs) against the JAX
package's jnp sweeps: 4 semirings x {no mask, a random mask that drops whole
chunks} x {SpMV, SpMM B=1/5/64}. Every value is an integer or +-inf, so the
comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import semiring as jsr
from repro.core import spmv as jspmv
from repro.graphs import generators as jg
from repro_torch.core import formats as pf
from repro_torch.core import semiring as psr
from repro_torch.core import spmv as pspmv
from repro_torch.graphs import generators as pg
from repro_torch.kernels import ops

SEMIRINGS = ["tropical", "real", "boolean", "selmax"]


@pytest.fixture(scope="module")
def layouts():
    jt = jf.build_slimsell(jg.kronecker(8, 8, seed=1), C=8, L=16)
    pt = pf.build_slimsell(pg.kronecker(8, 8, seed=1), C=8, L=16)
    return jt.to_jax(), pt.to_torch("cpu")


def _operand(name, shape, rng):
    if name == "boolean":
        return rng.integers(0, 2, size=shape).astype(np.int32)
    x = rng.integers(0, 4, size=shape).astype(np.float32)
    if name == "tropical":
        x[rng.random(shape) < 0.4] = np.inf
    if name == "selmax":
        x *= rng.integers(1, 300, size=shape)
    return x


def _mask(tiled, rng):
    """Half the tiles, and no tile at all of about a third of the chunks."""
    keep_chunk = rng.random(tiled.n_chunks) < 0.65
    return (rng.random(tiled.n_tiles) < 0.5) & keep_chunk[np.asarray(tiled.row_block)]


@pytest.mark.parametrize("width", [None, 1, 5, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_sweep_matches_jnp(layouts, name, masked, width):
    jt, pt = layouts
    rng = np.random.default_rng([SEMIRINGS.index(name), masked, width or 0])
    shape = (pt.n,) if width is None else (pt.n, width)
    x = _operand(name, shape, rng)
    mask = _mask(pt, rng) if masked else None
    if masked:
        chunk_hit = np.zeros(pt.n_chunks, bool)
        chunk_hit[np.asarray(pt.row_block)[mask]] = True
        assert not chunk_hit.all()  # some chunks get no tile
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    fn_j = jspmv.slimsell_spmv if width is None else jspmv.slimsell_spmm
    fn_p = pspmv.slimsell_spmv if width is None else pspmv.slimsell_spmm
    want = np.asarray(fn_j(jsr.get(name), jt, jnp.asarray(x), tile_mask=jm,
                           backend="jnp"))
    got = fn_p(psr.get(name), pt, torch.from_numpy(x), tile_mask=pm)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_tile_contributions_match_jnp(layouts, name):
    jt, pt = layouts
    x = _operand(name, (pt.n,), np.random.default_rng(7))
    want = np.asarray(jspmv.tile_contributions(jsr.get(name), jt.cols,
                                               jnp.asarray(x)))
    got = pspmv.tile_contributions(psr.get(name), pt.cols, torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


def test_plain_spmm_slices_like_one_pass(layouts, monkeypatch):
    """Slicing the tiles (to bound the gather) does not change the result."""
    _, pt = layouts
    X = torch.from_numpy(_operand("tropical", (pt.n, 5), np.random.default_rng(3)))
    whole = pspmv.spmm_plain(psr.TROPICAL, pt, X)
    monkeypatch.setattr(pspmv, "_GATHER_BYTES", 7 * pt.C * pt.L * 5 * 4)
    assert torch.equal(pspmv.spmm_plain(psr.TROPICAL, pt, X), whole)


def test_cpu_sweeps_launch_no_kernel(layouts):
    _, pt = layouts
    before = ops.launch_counts()
    pspmv.slimsell_spmv(psr.REAL, pt, torch.zeros(pt.n))
    pspmv.slimsell_spmm(psr.REAL, pt, torch.zeros(pt.n, 3))
    assert ops.launch_counts() == before


def test_wrappers_check_inputs(layouts):
    _, pt = layouts
    with pytest.raises(TypeError, match="sweeps"):
        ops.spmv(psr.TROPICAL, pt, torch.zeros(pt.n, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ops.spmv(psr.TROPICAL, pt, torch.zeros(pt.n + 1))
    with pytest.raises(ValueError, match="shape"):
        ops.spmm(psr.TROPICAL, pt, torch.zeros(pt.n))
    with pytest.raises(ValueError, match="tile_mask"):
        ops.spmv(psr.TROPICAL, pt, torch.zeros(pt.n),
                 tile_mask=torch.ones(pt.n_tiles, dtype=torch.int32))
    with pytest.raises(ValueError, match="layout on"):
        ops.spmv(psr.TROPICAL, pt, torch.zeros(pt.n, device="meta"))
