"""The port's sharding tables against the JAX package's, with no ranks:
``AxisRules``, ``_attn_mode``, ``param_specs``, ``cache_specs`` (with and
without ``seq_shard``, at several batch sizes) and DLRM's table placement
(``dlrm_param_specs`` against the shardings ``build_dlrm_cell`` attaches),
entry for entry, on the production meshes (16, 16) and (2, 16, 16) and
the small meshes (2, 2), (1, 4), (4, 1) of the CPU worlds. The JAX side
reads a ``jax.sharding.AbstractMesh`` (no devices), the port's a
``launch.mesh.MeshShape``. ``make_production_mesh`` and ``remesh`` are
held to the JAX package's, which build real meshes, in subprocesses with
forced host devices (``conftest.run_multidevice``). Plus the block
arithmetic of ``local_shard`` / ``reshard`` on the port's side alone.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import run_multidevice
from repro.configs import cells as jcells
from repro.configs import dlrm_mlperf as j_dlrm
from repro.configs import (internlm2_1_8b as j_internlm, kimi_k2 as j_kimi,
                           llama4_scout as j_llama4, phi3_mini as j_phi3,
                           smollm_135m as j_smollm)
from repro.models import sharding as jsh
from repro.models import transformer as jtf
from repro_torch.configs import cells as pcells
from repro_torch.configs import dlrm_mlperf as p_dlrm
from repro_torch.configs import (internlm2_1_8b as p_internlm,
                                 kimi_k2 as p_kimi, llama4_scout as p_llama4,
                                 phi3_mini as p_phi3, smollm_135m as p_smollm)
from repro_torch.launch import mesh as pmesh
from repro_torch.models import sharding as psh
from repro_torch.models import transformer as ptf

LM_ARCHS = {"smollm-135m": (j_smollm, p_smollm),
            "phi3-mini-3.8b": (j_phi3, p_phi3),
            "internlm2-1.8b": (j_internlm, p_internlm),
            "llama4-scout-17b-a16e": (j_llama4, p_llama4),
            "kimi-k2-1t-a32b": (j_kimi, p_kimi)}
# the ten configurations: each language model's published widths and its
# reduced test widths
CONFIGS = [(a, v) for a in LM_ARCHS for v in ("make", "reduced")]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
BATCHES = (1, 2, 4, 6, 32, 128)


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), pmesh.make_host_mesh(shape, axes)


def _cfgs(arch, variant):
    jm, pm = LM_ARCHS[arch]
    if variant == "make":
        return jm.make_config(), pm.make_config()
    return jm.reduced_config(), pm.reduced_config()


def _norm(entry):
    """A spec entry as ``PartitionSpec`` stores it: a one-name tuple is
    the name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _same_specs(got, want):
    """Two trees of specs, the port's tuples against the JAX package's
    ``PartitionSpec``s, entry for entry."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_specs(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_specs(g, w)
    else:
        assert tuple(_norm(e) for e in got) == tuple(want), (got, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axis_rules_match_jax(mesh_name):
    jm, pm = _meshes(mesh_name)
    jr, pr = jsh.AxisRules.for_mesh(jm), psh.AxisRules.for_mesh(pm)
    assert (pr.dp, pr.fsdp, pr.tp) == (jr.dp, jr.fsdp, jr.tp)
    for axes in (None, "model", ("data",), jr.dp, tuple(pm.axis_names)):
        assert psh.axis_size(pm, axes) == jsh.axis_size(jm, axes)
        for dim in (1, 3, 9, 16, 32, 48, 49152, 92544):
            assert _norm(psh.shard_dim(pm, dim, axes)) == \
                _norm(jsh.shard_dim(jm, dim, axes))
    shape = (49152, 576, 9, 64)
    axes = ("model", jr.fsdp, "model", None)
    assert tuple(_norm(e) for e in psh.spec(pm, shape, axes)) == \
        tuple(jsh.spec(jm, shape, axes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,variant", CONFIGS)
def test_attn_mode_and_param_specs_match_jax(arch, variant, mesh_name):
    jcfg, pcfg = _cfgs(arch, variant)
    jm, pm = _meshes(mesh_name)
    jr, pr = jsh.AxisRules.for_mesh(jm), psh.AxisRules.for_mesh(pm)
    for impl in ("ep", "reference"):
        assert ptf._attn_mode(pcfg, ptf.ShardCtx(pm, pr, moe_impl=impl)) == \
            jtf._attn_mode(jcfg, jtf.ShardCtx(mesh=jm, rules=jr,
                                              moe_impl=impl))
    assert ptf._attn_mode(pcfg, None) == jtf._attn_mode(jcfg, None) == "none"
    _same_specs(ptf.param_specs(pcfg, pm, pr), jtf.param_specs(jcfg, jm, jr))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,variant", CONFIGS)
def test_cache_specs_match_jax(arch, variant, mesh_name):
    jcfg, pcfg = _cfgs(arch, variant)
    jm, pm = _meshes(mesh_name)
    jr, pr = jsh.AxisRules.for_mesh(jm), psh.AxisRules.for_mesh(pm)
    for seq_shard in (False, True):
        for batch in BATCHES:
            _same_specs(ptf.cache_specs(pcfg, pm, pr, seq_shard=seq_shard,
                                        batch=batch),
                        jtf.cache_specs(jcfg, jm, jr, seq_shard=seq_shard,
                                        batch=batch))


def test_attn_modes_on_production_and_cpu_meshes():
    """smollm's 9 heads go context-parallel on (16, 16), phi3's 32 go over
    heads; on the CPU worlds' meshes the reduced configs do what the mesh
    tests rely on."""
    m = pmesh.make_production_mesh()
    rules = psh.AxisRules.for_mesh(m)
    assert ptf._attn_mode(p_smollm.make_config(),
                          ptf.ShardCtx(m, rules)) == "context"
    assert ptf._attn_mode(p_phi3.make_config(),
                          ptf.ShardCtx(m, rules)) == "heads"
    m14 = pmesh.make_host_mesh((1, 4), ("data", "model"))
    assert ptf._attn_mode(p_smollm.reduced_config(),
                          ptf.ShardCtx(m14, rules)) == "context"


DLRM_CONFIGS = {
    "mlperf": lambda m: m.make_config(),
    "reduced": lambda m: m.reduced_config(),
    # the reduced widths with a table at the hybrid threshold's scale
    "reduced+1M": lambda m: dataclasses.replace(
        m.reduced_config(), vocabs=m.reduced_config().vocabs + (1_000_003,)),
}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cfg_name", list(DLRM_CONFIGS))
@pytest.mark.parametrize("shape", ["serve_bulk", "serve_bulk_hybrid",
                                   "train_batch_hybrid"])
def test_dlrm_placement_matches_jax(shape, cfg_name, mesh_name):
    """The port's placement against the shardings the JAX package's
    ``build_dlrm_cell`` puts on the weights (its vocabularies padded to a
    multiple of ``tp``); the batch entry likewise."""
    jcfg, pcfg = (DLRM_CONFIGS[cfg_name](m) for m in (j_dlrm, p_dlrm))
    jm, pm = _meshes(mesh_name)
    cell = jcells.build_dlrm_cell("dlrm-mlperf", jcfg, shape, jm)
    params = cell.args[0]
    want = {"tables": [t.sharding.spec for t in params["tables"]],
            **{part: [{k: layer[k].sharding.spec for k in ("w", "b")}
                      for layer in params[part]] for part in ("bot", "top")}}
    hybrid = bool(jcells.RECSYS_SHAPES[shape].get("hybrid"))
    _same_specs(pcells.dlrm_param_specs(pcfg, pm, hybrid=hybrid), want)
    tp = pm.axis_size("model")
    assert [t.shape[0] for t in params["tables"]] == \
        [pcells._pad_to(v, tp) for v in pcfg.vocabs]
    if cell.kind == "serve":
        B = jcells.RECSYS_SHAPES[shape]["batch"]
        want_b = cell.args[1]["dense"].sharding.spec[0]
        from repro_torch.models import dlrm as pdlrm
        got_b = pdlrm.batch_entry(ptf.ShardCtx(pm, psh.AxisRules.for_mesh(pm)),
                                  B)
        assert _norm(got_b) == want_b
    assert pcells.RECSYS_SHAPES == jcells.RECSYS_SHAPES
    assert pcells._pad_to(7, 4) == jcells._pad_to(7, 4) == 8


def test_production_mesh_matches_jax():
    out = run_multidevice("""
import json
from repro.launch.mesh import make_production_mesh
res = {}
for pod in (False, True):
    m = make_production_mesh(multi_pod=pod)
    res[str(pod)] = [list(m.devices.shape), list(m.axis_names),
                     [d.id for d in m.devices.flat]]
print(json.dumps(res))
""", n_devices=512)
    want = json.loads(out.strip().splitlines()[-1])
    for pod in (False, True):
        m = pmesh.make_production_mesh(multi_pod=pod)
        shape, axes, ids = want[str(pod)]
        assert list(m.shape) == shape and list(m.axis_names) == axes
        assert m.ranks.reshape(-1).tolist() == ids


REMESH_FAILED = [set(), {3}, {0, 7}, {1, 2, 5}, {0, 1, 2, 3, 4, 5, 6},
                 {6, 4}]


def test_remesh_matches_jax():
    out = run_multidevice(f"""
import json
from repro.launch.mesh import remesh
res = []
for failed in {[sorted(f) for f in REMESH_FAILED]!r}:
    m = remesh(set(failed))
    res.append([list(m.devices.shape), list(m.axis_names),
                [[d.id for d in row] for row in m.devices]])
print(json.dumps(res))
""", n_devices=8)
    want = json.loads(out.strip().splitlines()[-1])
    for failed, (shape, axes, ids) in zip(REMESH_FAILED, want):
        m = pmesh.remesh(failed, 8)
        assert list(m.shape) == shape and list(m.axis_names) == axes
        assert m.ranks.tolist() == ids
        # the same from the survivors' ids in their order
        assert pmesh.remesh(failed, list(range(8))).ranks.tolist() == ids
    with pytest.raises(ValueError, match="survives"):
        pmesh.remesh(set(range(4)), 4)


class _FakeGrid:
    """A mesh position without a world: ``index`` and ``all_gather_dim``
    over a table of every position's block (enough for ``reshard``'s
    arithmetic)."""

    def __init__(self, shape, axes, coords, blocks=None):
        self.axis_names, self.shape = axes, shape
        self.coords = dict(zip(axes, coords))
        self.blocks = blocks

    def axis_size(self, a):
        return self.shape[self.axis_names.index(a)]

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.coords[a]
        return i

    def all_gather_dim(self, t, dim, axes):
        return self.blocks(t, dim, axes, self)


@pytest.mark.parametrize("spec", [("model", None), (None, ("pod", "data")),
                                  (("pod", "data"), "model"), ()])
def test_local_shard_blocks_tile_the_tensor(spec):
    """Every position's block, placed at its ``block`` slices, rebuilds
    the tensor exactly once; a short spec replicates the trailing dims."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    seen = torch.zeros_like(full)
    positions = [np.unravel_index(r, shape) for r in range(8)]
    for c in positions:
        g = _FakeGrid(shape, axes, c)
        part = psh.local_shard(full, spec, g)
        spec_p = tuple(spec) + (None,) * (2 - len(spec))
        sl = tuple(psh.block(e, n, g) for e, n in zip(spec_p, full.shape))
        assert torch.equal(full[sl], part)
        seen[sl] += 1
    # each element is held by the ranks that share its block
    copies = 8 // max(1, np.prod([psh.axis_size(_FakeGrid(shape, axes,
                                                          (0, 0, 0)), e)
                                  for e in spec]))
    assert torch.equal(seen, torch.full_like(full, copies))


def test_reshard_moves_between_specs():
    """``reshard`` from (model over rows) to (data over columns): gathered
    along the rows, then cut along the columns."""
    shape, axes = (1, 2, 2), ("pod", "data", "model")
    full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)

    def gather(t, dim, gaxes, g):
        parts = [psh.local_shard(full, ("model", None), _FakeGrid(
            shape, axes, (g.coords["pod"], g.coords["data"], m)))
            for m in range(g.axis_size("model"))]
        return torch.cat(parts, dim)

    for c in [np.unravel_index(r, shape) for r in range(4)]:
        g = _FakeGrid(shape, axes, c, gather)
        have = psh.local_shard(full, ("model", None), g)
        got = psh.reshard(have, ("model", None), (None, "data"), g)
        assert torch.equal(got, psh.local_shard(full, (None, "data"), g))
    with pytest.raises(ValueError, match="does not split"):
        psh.block("model", 5, _FakeGrid(shape, axes, (0, 0, 0)))
