"""The port's graph generators and SlimSell builder against the JAX package:
the same seed and sizes give the same arrays, exactly."""
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.graphs import generators as jg
from repro_torch import convert
from repro_torch.core import formats as pf
from repro_torch.graphs import generators as pg

PATH_EDGES = np.stack([np.arange(63), np.arange(1, 64)], axis=1)
# each family takes (generators, formats) of one package
FAMILIES = {
    "kron": lambda g, f: g.kronecker(8, 8, seed=0),
    "er": lambda g, f: g.erdos_renyi(300, 6, seed=1),
    "ring": lambda g, f: g.ring_of_cliques(16, 6),
    "star": lambda g, f: g.star(200),
    "path": lambda g, f: f.build_csr(PATH_EDGES, 64),
    "two": lambda g, f: g.two_components(7, 6, seed=2),
}
LAYOUT = ["cols", "row_block", "row_vertex", "cl", "deg", "inc_src",
          "inc_tile", "inc_ptr", "wts"]


def _pair(family, weighted, **layout):
    a, b = FAMILIES[family](jg, jf), FAMILIES[family](pg, pf)
    if weighted:
        a = jg.with_random_weights(a, seed=3)
        b = pg.with_random_weights(b, seed=3)
    return a, b, jf.build_slimsell(a, **layout), pf.build_slimsell(b, **layout)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layout_arrays_equal(family, weighted):
    a, b, ja, pa = _pair(family, weighted, C=4, L=8, sigma=64)
    for f in ("indptr", "indices", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None) and (x is None or np.array_equal(x, y)), f
    for f in LAYOUT:
        x, y = getattr(ja, f), getattr(pa, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("n", "m_undirected", "C", "L", "sigma", "n_chunks", "n_tiles"):
        assert getattr(ja, f) == getattr(pa, f), f
    # chunk c owns tiles tile_ptr[c]:tile_ptr[c+1]
    for c in range(pa.n_chunks):
        owned = np.nonzero(pa.row_block == c)[0]
        assert owned.tolist() == list(range(pa.tile_ptr[c], pa.tile_ptr[c + 1]))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_from_arrays_equals_own_build(family, weighted):
    _, _, ja, pa = _pair(family, weighted, C=8, L=16)
    carried = convert.tiled_from_arrays(
        {k: getattr(ja, k) for k in convert.LAYOUT_ARRAYS},
        {k: getattr(ja, k) for k in convert.LAYOUT_META}, device="cpu")
    own = pa.to_torch("cpu")
    assert carried.device == own.device == torch.device("cpu")
    for f in LAYOUT + ["tile_ptr"]:
        x, y = getattr(carried, f), getattr(own, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


def test_tiled_from_arrays_rejects_bad_layouts():
    _, _, ja, _ = _pair("kron", False, C=8, L=16)
    fields = {k: getattr(ja, k) for k in convert.LAYOUT_ARRAYS}
    meta = {k: getattr(ja, k) for k in convert.LAYOUT_META}
    with pytest.raises(ValueError, match="missing"):
        convert.tiled_from_arrays({**fields, "cols": None}, meta, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.tiled_from_arrays(fields, {**meta, "n_tiles": meta["n_tiles"] + 1},
                                  device="cpu")
    with pytest.raises(ValueError, match="non-decreasing"):
        convert.tiled_from_arrays({**fields, "row_block": fields["row_block"][::-1]},
                                  meta, device="cpu")
    rv = np.array(fields["row_vertex"], copy=True)
    rv[rv == 0] = -1  # vertex 0 loses its chunk row
    with pytest.raises(ValueError, match="exactly one chunk row"):
        convert.tiled_from_arrays({**fields, "row_vertex": rv}, meta, device="cpu")
    short = np.array(fields["cl"], copy=True)
    short[np.argmax(short)] -= 1  # the longest row's last edge lies past cl
    with pytest.raises(ValueError, match="cover every slot"):
        convert.tiled_from_arrays({**fields, "cl": short}, meta, device="cpu")


def test_state_from_arrays_keeps_values_and_types():
    state = {"d": np.array([0, 1, -1], np.int32),
             "f": np.array([0.0, 1.0, np.inf], np.float32),
             "visited": np.array([True, True, False])}
    out = convert.state_from_arrays(state, device="cpu")
    for k, v in state.items():
        assert np.array_equal(out[k].numpy(), v) and out[k].numpy().dtype == v.dtype
