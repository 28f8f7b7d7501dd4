"""GCN inference (Kipf & Welling, arXiv:1609.02907), the port of the GCN of
the JAX package's ``repro/models/gnn.py``, and that module's MLP helpers
(``mlp_init``, ``mlp_apply``), which DLRM (``models.dlrm``) builds on.

A layer is ``aggregate(x @ w)``, with ReLU between layers. The aggregation
is the symmetric-normalised neighbourhood sum: an edge (v, u) carries
``x[u] * rsqrt(max(deg[v], 1)) * rsqrt(max(deg[u], 1))`` to v. Two
backends compute it:

* ``"segment"``: gather the messages along ``edge_index`` and sum them with
  ``index_add_`` (-1-padded edges are dropped); on the card the atomics
  make the summation order vary from run to run;
* ``"slimsell"``: the SlimSell SpMM under ``real`` with the GCN weight
  derived from ``deg`` (``core.spmv.slimsell_spmm(..., deg=)``), the
  hand-written kernel ``slimsell_spmm_gcn`` on the card.

``x @ w`` stays a float32 ``torch.matmul`` (no TF32), as the JAX package
leaves it to XLA outside any kernel. Inference only: the GCN kernel has no
backward, so on the card the SlimSell forward runs under
``torch.no_grad()`` or ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.formats import resolve_device
from ..core.semiring import REAL
from ..core.spmv import slimsell_spmm

AGGREGATIONS = ("segment", "slimsell")


def seg_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``n`` segments by ``ids``; -1-padded
    ids go to a dropped bucket n."""
    safe = torch.where(ids < 0, n, ids).long()
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, safe, data)[:n]


def gather_nodes(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` at ``ids``, a -1 pad reading row 0."""
    return x.index_select(0, ids.clamp_min(0).long())


def mlp_init(sizes, *, generator: Optional[torch.Generator] = None,
             device=None, dtype: torch.dtype = torch.float32) -> list:
    """``[{"w", "b"}, ...]`` for the layers ``sizes[i] -> sizes[i + 1]``:
    ``w`` He-normal, N(0, 2 / fan_in), drawn from ``generator`` (default: a
    CPU generator seeded with 0) on its device and placed on ``device``
    (default: the card; raises when there is none); ``b`` zero."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return [{"w": (torch.randn((a, b), generator=generator, dtype=torch.float32,
                               device=generator.device) * (2.0 / a) ** 0.5
                   ).to(device=dev, dtype=dtype),
             "b": torch.zeros((b,), dtype=dtype, device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers, x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` layer by layer, ``act`` after every layer but the last
    (and after the last too with ``final_act``)."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    aggregation: str = "segment"    # "segment" | "slimsell"
    dtype: torch.dtype = torch.float32


def layer_shapes(cfg: GCNConfig) -> list:
    """The [d_in, d_out] shape of each layer's weight."""
    sizes = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return list(zip(sizes[:-1], sizes[1:]))


def gcn_init(cfg: GCNConfig, *, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
    """``{"w": [...]}``, each weight N(0, 1/d_in) drawn from ``generator``
    (default: a CPU generator seeded with 0) on its device, then placed on
    ``device`` (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return {"w": [
        (torch.randn((a, b), generator=generator, dtype=torch.float32,
                     device=generator.device) * (1.0 / a) ** 0.5
         ).to(device=dev, dtype=cfg.dtype)
        for a, b in layer_shapes(cfg)]}


def _placed(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device.type != dev.type or (dev.index is not None and t.device != dev):
        raise ValueError(f"{what} is on {t.device}, the call asks for {dev}")


def _gcn_aggregate(x: torch.Tensor, batch: dict, n: int,
                   aggregation: str) -> torch.Tensor:
    if aggregation == "slimsell":
        return slimsell_spmm(REAL, batch["tiled"], x,
                             deg=batch["deg"].to(torch.float32))
    src, dst = batch["edge_index"]
    deg = batch["deg"].to(torch.float32).clamp_min(1.0)
    w = torch.rsqrt(gather_nodes(deg, src)) * torch.rsqrt(gather_nodes(deg, dst))
    w = torch.where(src < 0, 0.0, w)
    msg = gather_nodes(x, src) * w[:, None]
    return seg_sum(msg, dst, n)


def gcn_forward(params: dict, batch: dict, cfg: GCNConfig, *,
                device=None) -> torch.Tensor:
    """Logits [N, n_classes]. ``batch``: ``node_feat`` [N, F], ``deg`` [N],
    and ``edge_index`` int32[2, E] (-1 pads) for ``"segment"`` or ``tiled``
    (a SlimSell layout on the device) for ``"slimsell"``. Every tensor must
    lie on ``device`` (default: the card; raises when there is none)."""
    if cfg.aggregation not in AGGREGATIONS:
        raise ValueError(f"aggregation must be one of {AGGREGATIONS}, got "
                         f"{cfg.aggregation!r}")
    dev = resolve_device(device)
    graph = "tiled" if cfg.aggregation == "slimsell" else "edge_index"
    for i, w in enumerate(params["w"]):
        _placed(w, dev, f"params['w'][{i}]")
    for key in ("node_feat", "deg", graph):
        t = batch[key]
        if key == "tiled":
            if t.device is None:
                raise ValueError("batch['tiled'] is a host layout; move it "
                                 f"with to_torch({str(dev)!r})")
            t = t.cols
        _placed(t, dev, f"batch[{key!r}]")
    x = batch["node_feat"].to(cfg.dtype)
    n = x.shape[0]
    for i, w in enumerate(params["w"]):
        x = _gcn_aggregate(x @ w, batch, n, cfg.aggregation)
        if i < len(params["w"]) - 1:
            x = torch.relu(x)
    return x


class GCN(nn.Module):
    """The GCN as a module: its weights a ``ParameterList``, ``forward``
    the same function as ``gcn_forward`` on the weights' device."""

    def __init__(self, cfg: GCNConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = gcn_init(cfg, generator=generator, device=device)
        self.w = nn.ParameterList(nn.Parameter(w) for w in params["w"])

    def forward(self, batch: dict) -> torch.Tensor:
        return gcn_forward({"w": list(self.w)}, batch, self.cfg,
                           device=self.w[0].device)
