"""Architecture registry, the port of the JAX package's
``repro/configs/__init__.py``: the ten assigned architectures (five
language models, four GNNs and DLRM), each a module with ``ARCH_ID``,
``FAMILY``, ``SHAPES``, ``make_config`` and ``reduced_config``.

``bfs-graph500``, the JAX package's registry entry for the paper's own
BFS cells, is not here: its module only lays out distributed cells over a
device mesh (``build_cell``), which waits with the other ``build_*_cell``
functions (ROADMAP module queue 2.3; the sharding layer they build on is
``models.sharding`` and ``transformer.param_specs`` / ``cache_specs``);
the port's Graph500 harnesses are ``repro_torch.graph500``.
``build_cell`` and ``all_cells`` wait with it.
"""
from __future__ import annotations

from . import (dlrm_mlperf, egnn, gcn_cora, gin_tu, internlm2_1_8b, kimi_k2,
               llama4_scout, nequip, phi3_mini, smollm_135m)

ARCHS = {
    m.ARCH_ID: m
    for m in (smollm_135m, phi3_mini, internlm2_1_8b, llama4_scout, kimi_k2,
              egnn, gin_tu, nequip, gcn_cora, dlrm_mlperf)
}

ASSIGNED = list(ARCHS)


def get(arch_id: str):
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")


def shapes_for(arch_id: str) -> list:
    return list(get(arch_id).SHAPES)
