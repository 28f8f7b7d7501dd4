"""Connected components on the SlimSell engine: sel-max label propagation
(default) and boolean BFS peeling.

Two formulations, both compositions of the sweeps BFS already uses:

* ``semiring="selmax"``: **label propagation to a fixpoint**. Every vertex
  starts with its own 1-based id as label, and one sel-max SpMV a sweep
  replaces each label with the max over its neighbourhood,

      x'[v] = max( x[v],  max_u A[v,u] * x[u] ),

  converging in O(component diameter) sweeps to "every vertex holds the
  max vertex id of its component". It is the spec ``CC_SPEC``: the
  SlimWork sources are the vertices whose label changed last sweep, and
  the fused and hostloop strategies come from the engine. Push only.
* ``semiring="boolean"``: **reachability peeling**. A boolean BFS from the
  lowest unlabelled vertex stamps everything it reaches, one BFS a
  component (the loop over components runs on the host), lane or packed,
  in any direction the config names.

Both return the canonical labelling, ``labels[v]`` = the largest vertex id
of v's component, so results compare across semirings and modes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import engine as eng
from .bfs import bfs, on_device
from .options import CC_SEMIRINGS, EngineConfig, check_choice


@dataclasses.dataclass
class CCResult:
    labels: np.ndarray   # int32[n]; canonical = max vertex id in the component
    n_components: int
    iterations: int      # label-prop sweeps, or total BFS iterations (boolean)
    work_log: Optional[np.ndarray] = None  # active tiles per sweep (selmax)


# ------------------------------------------------------- sel-max label prop


def _cc_init(n: int, arg, device) -> dict:
    # 1-based own ids: sel-max's zero (0) never beats a label
    return {"x": torch.arange(1, n + 1, dtype=torch.float32, device=device),
            "changed": torch.ones(n, dtype=torch.bool, device=device)}


def _cc_update(state: dict, y: torch.Tensor, k: int):
    x_new = torch.maximum(state["x"], y)
    changed = x_new > state["x"]
    return {"x": x_new, "changed": changed}, changed.any()


CC_SPEC = eng.FixpointSpec(
    name="cc/labelprop",
    sr_name="selmax",
    init_state=_cc_init,
    frontier=lambda state, k: state["x"],
    source_bits=lambda state, k: state["changed"],
    not_final=lambda state: state["changed"],
    update=_cc_update,
    host_bits=lambda state, k, need_sb, need_nf:
        (state["changed"].cpu().numpy(), None),
)


# --------------------------------------------------------- boolean peeling


def _cc_boolean(tiled, *, config: EngineConfig, slimwork: bool,
                max_iters: Optional[int], packed: bool):
    """One boolean BFS per component, stamping the canonical (max-id) label."""
    labels = np.full(tiled.n, -1, np.int64)
    # isolated vertices are their own component: label them up front
    # instead of paying one BFS each (sparse graphs have thousands)
    isolated = np.nonzero(tiled.deg.cpu().numpy() == 0)[0]
    labels[isolated] = isolated
    iters = 0
    while True:
        unlabelled = np.nonzero(labels < 0)[0]
        if unlabelled.size == 0:
            break
        res = bfs(tiled, int(unlabelled[0]), "boolean", config=config,
                  slimwork=slimwork, max_iters=max_iters, packed=packed,
                  device=tiled.device)
        comp = res.distances >= 0
        labels[comp] = int(np.nonzero(comp)[0].max())
        iters += res.iterations
    return labels.astype(np.int32), iters


# ----------------------------------------------------------------- public API


def cc(tiled, *, semiring: str = "selmax", slimwork: bool = True,
       packed: bool = False, max_iters: Optional[int] = None,
       log_work: bool = False, config: Optional[EngineConfig] = None,
       device=None) -> CCResult:
    """Connected components; ``labels[v]`` = max vertex id of v's component.

    semiring: "selmax" (label propagation, one SpMV a sweep, push only) or
    "boolean" (one boolean BFS a component; the config, its direction
    too, goes to each BFS).
    packed: SlimSell-B, the peeling BFSes over bit-packed bitmaps (needs
    ``semiring="boolean"`` and the push direction); the same labels.
    max_iters: the sweep cap of label propagation (n + 1 by default), or
    of each peeling BFS.
    device: where to run; None means the card (raises when there is none).
    """
    check_choice("cc semiring", semiring, CC_SEMIRINGS)
    config = config if config is not None else EngineConfig()
    if packed and semiring != "boolean":
        raise ValueError("cc: packed=True is the bit-packed boolean peeling "
                         f"path; got semiring={semiring!r}")
    if semiring == "selmax":
        check_choice("direction", config.direction, ("push",),
                     hint="sel-max label propagation is push-only")
    if slimwork and tiled.inc_src is None:
        raise ValueError("SlimWork masks need the push index; rebuild the "
                         "layout with formats.build_slimsell")
    n = tiled.n
    if semiring == "selmax" and n > (1 << 24):
        # labels ride in the float32 sel-max payload; ids above 2^24 round
        raise ValueError("selmax label propagation carries vertex ids in "
                         "float32 (exact up to 2^24); use semiring='boolean' "
                         f"for n={n}")
    tiled = on_device(tiled, device)

    if semiring == "boolean":
        labels, iters = _cc_boolean(tiled, config=config, slimwork=slimwork,
                                    max_iters=max_iters, packed=packed)
        return CCResult(labels=labels, n_components=len(np.unique(labels)),
                        iterations=iters)

    cap = int(max_iters) if max_iters is not None else n + 1
    with config.applied():
        if config.mode == "fused":
            res = eng.run_fused(CC_SPEC, tiled, 0, slimwork=slimwork,
                                max_iters=cap, log_work=log_work)
        else:
            res = eng.run_hostloop(CC_SPEC, tiled, 0, slimwork=slimwork,
                                   max_iters=cap)
    # 0-based ids; the labels are whole numbers up to 2^24, exact in float32
    labels = res.state["x"].cpu().numpy().astype(np.int32) - 1
    return CCResult(labels=labels, n_components=len(np.unique(labels)),
                    iterations=res.iterations,
                    work_log=res.work_log if log_work else None)
