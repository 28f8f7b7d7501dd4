"""The GNNs of the JAX package's ``repro/models/gnn.py``: GCN (Kipf &
Welling, arXiv:1609.02907) with its training loss (``gcn_loss``, the GCN
branch of ``repro/configs/cells.py::_gnn_loss``), GIN, EGNN and NequIP,
and that module's MLP helpers (``mlp_init``, ``mlp_apply``), which DLRM
(``models.dlrm``) builds on. The losses of all four are
``configs.cells.gnn_loss``.

A GCN layer is ``aggregate(x @ w)``, with ReLU between layers. The aggregation
is the symmetric-normalised neighbourhood sum: an edge (v, u) carries
``x[u] * rsqrt(max(deg[v], 1)) * rsqrt(max(deg[u], 1))`` to v. Two
backends compute it:

* ``"segment"``: gather the messages along ``edge_index`` and sum them with
  ``index_add_`` (-1-padded edges are dropped); on the card the atomics
  make the summation order vary from run to run;
* ``"slimsell"``: the SlimSell SpMM under ``real`` with the GCN weight
  derived from ``deg`` (``ops.spmm(..., deg=)``), the hand-written kernel
  ``slimsell_spmm_gcn`` on the card, through
  ``kernels.autograd.gcn_aggregate``: its backward is the same sweep over
  the output's gradient (the layout must be symmetric), so a training step
  runs the kernel twice a layer forward and backward, four times for
  gcn-cora.

``x @ w`` stays a float32 ``torch.matmul`` (no TF32), as the JAX package
leaves it to XLA outside any kernel.

GIN (Xu et al., arXiv:1810.00826) sums each vertex's neighbours' rows,
``x' = MLP((1 + eps) x + sum_u x[u])``, and pools the vertices of each
graph by ``graph_ids``. Under ``"segment"`` the sum gathers along
``edge_index`` (row v the senders u of u -> v) and adds with
``index_add_``; under ``"slimsell"`` it is kernel 2's implicit real SpMM
through ``kernels.autograd.spmm_aggregate``, one launch a layer, whose
backward is the same sweep on a symmetric layout (a sampled block's layout
is directed: inference only).

EGNN (Satorras et al., arXiv:2102.09844) and NequIP (Batzner et al.,
arXiv:2101.03164) run no SlimSell kernel: their messages are per-edge
MLPs and tensor products, gathered with ``index_select`` and summed with
``index_add_``, whose atomics on the card add in no fixed order. NequIP
carries its irreps l <= 2 in Cartesian form (scalars [N, c], vectors
[N, c, 3], traceless symmetric tensors [N, c, 3, 3]), as the JAX package
does.

Each init draws its weights one after another from one generator (the
JAX package splits a key for each part). The JAX package's
``nequip_init`` draws ``mix1`` and
``mix2`` from one key (they are equal at init) and ``gate`` from
``mix0``'s; here each has draws of its own. Weights carried across with
``convert.gnn_params_from_arrays`` go through both packages unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import pytree
from ..core.formats import resolve_device
from ..kernels.autograd import gcn_aggregate, spmm_aggregate

AGGREGATIONS = ("segment", "slimsell")


def seg_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``n`` segments by ``ids``; -1-padded
    ids go to a dropped bucket n. ``index_add_`` adds with atomics, in no
    fixed order on the card, so a batch of several graphs (``n`` > 1) gives
    sums that may differ in their last bits from call to call. One segment
    (the readout of a batch of one graph) is a masked sum instead: in a
    fixed order, so bit-reproducible, and without ``index_add_``'s atomics
    all onto one row."""
    if n == 1:
        keep = (ids == 0).reshape((-1,) + (1,) * (data.ndim - 1))
        return torch.where(keep, data, 0).sum(0, keepdim=True)
    safe = torch.where(ids < 0, n, ids).long()
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, safe, data)[:n]


def gather_nodes(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` at ``ids``, a -1 pad reading row 0."""
    return x.index_select(0, ids.clamp_min(0).long())


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def mlp_init(sizes, *, generator: Optional[torch.Generator] = None,
             device=None, dtype: torch.dtype = torch.float32) -> list:
    """``[{"w", "b"}, ...]`` for the layers ``sizes[i] -> sizes[i + 1]``:
    ``w`` He-normal, N(0, 2 / fan_in), drawn from ``generator`` (default: a
    CPU generator seeded with 0) on its device and placed on ``device``
    (default: the card; raises when there is none); ``b`` zero."""
    dev = resolve_device(device)
    generator = _generator(generator)
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
    generator = _generator(generator)
    return {"w": [
        (torch.randn((a, b), generator=generator, dtype=torch.float32,
                     device=generator.device) * (1.0 / a) ** 0.5
         ).to(device=dev, dtype=cfg.dtype)
        for a, b in layer_shapes(cfg)]}


def _placed(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device.type != dev.type or (dev.index is not None and t.device != dev):
        raise ValueError(f"{what} is on {t.device}, the call asks for {dev}")


def _check_inputs(params, batch: dict, keys, dev: torch.device) -> None:
    """Every weight leaf and every ``batch[key]`` of ``keys`` on ``dev``; a
    layout (``tiled``) must be on a device, not a host layout."""
    for path, leaf in pytree.flatten_with_paths(params)[0]:
        _placed(leaf, dev, f"params{path}")
    for key in keys:
        t = batch[key]
        if key == "tiled":
            if t.device is None:
                raise ValueError("batch['tiled'] is a host layout; move it "
                                 f"with to_torch({str(dev)!r})")
            t = t.cols
        _placed(t, dev, f"batch[{key!r}]")


def _check_aggregation(aggregation: str) -> None:
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"aggregation must be one of {AGGREGATIONS}, got "
                         f"{aggregation!r}")


def _gcn_aggregate(x: torch.Tensor, batch: dict, n: int,
                   aggregation: str) -> torch.Tensor:
    if aggregation == "slimsell":
        return gcn_aggregate(batch["tiled"], x,
                             batch["deg"].to(torch.float32))
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
    _check_aggregation(cfg.aggregation)
    dev = resolve_device(device)
    graph = "tiled" if cfg.aggregation == "slimsell" else "edge_index"
    _check_inputs(params, batch, ("node_feat", "deg", graph), dev)
    x = batch["node_feat"].to(cfg.dtype)
    n = x.shape[0]
    for i, w in enumerate(params["w"]):
        x = _gcn_aggregate(x @ w, batch, n, cfg.aggregation)
        if i < len(params["w"]) - 1:
            x = torch.relu(x)
    return x


def gcn_loss(params: dict, batch: dict, cfg: GCNConfig, *,
             device=None) -> torch.Tensor:
    """The node-classification loss of the JAX package's GCN cells
    (``_gnn_loss``'s GCN branch): the log-softmax NLL of the logits against
    one-hot ``batch["labels"]`` (int [N], -1 for none), averaged over the
    nodes of ``(labels >= 0) * batch["train_mask"]`` (float [N]), the sum
    divided by ``max(mask.sum(), 1)``."""
    logits = gcn_forward(params, batch, cfg, device=device)
    labels = batch["labels"]
    oh = F.one_hot(labels.clamp_min(0).long(), logits.shape[-1]).to(
        logits.dtype)
    nll = -torch.sum(F.log_softmax(logits, dim=-1) * oh, dim=-1)
    mask = (labels >= 0).to(torch.float32) * batch["train_mask"]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class _TreeModel(nn.Module):
    """A model whose weights are an init's tree of tensors: the leaves an
    ``nn.ParameterList`` in ``pytree`` order, ``weights()`` the tree of
    those parameters, ``forward`` the model's function on the weights'
    device. A subclass names its ``init`` and ``apply``."""

    init = None
    apply = None

    def __init__(self, cfg, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = type(self).init(cfg, generator=generator, device=device)
        leaves, self._treedef = pytree.flatten(params)
        self.leaves = nn.ParameterList(nn.Parameter(t) for t in leaves)

    def weights(self) -> dict:
        return pytree.unflatten(self._treedef, list(self.leaves))

    def forward(self, batch: dict):
        return type(self).apply(self.weights(), batch, self.cfg,
                                device=self.leaves[0].device)


class GCN(_TreeModel):
    """The GCN as a module: ``forward`` is ``gcn_forward``."""
    init = staticmethod(gcn_init)
    apply = staticmethod(gcn_forward)


# ------------------------------------------------------------------------ GIN


def _normal(shape, std: float, generator: torch.Generator, dev: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, std^2) drawn in float32 on the generator's device, placed on
    ``dev`` in ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std).to(device=dev,
                                                           dtype=dtype)


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 2
    aggregation: str = "segment"    # "segment" | "slimsell"
    dtype: torch.dtype = torch.float32


def gin_init(cfg: GINConfig, *, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
    """``{"layers": [{"mlp", "eps"}, ...], "readout"}``: each layer's MLP
    ``d -> d_hidden -> d_hidden`` (``mlp_init``), its ``eps`` a float32 0-d
    zero, and the readout ``d_hidden -> n_classes``; drawn from
    ``generator`` (default: a CPU generator seeded with 0) and placed on
    ``device`` (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    generator = _generator(generator)
    layers, d = [], cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({"mlp": mlp_init([d, cfg.d_hidden, cfg.d_hidden],
                                       generator=generator, device=dev,
                                       dtype=cfg.dtype),
                       "eps": torch.zeros((), dtype=torch.float32, device=dev)})
        d = cfg.d_hidden
    return {"layers": layers,
            "readout": mlp_init([cfg.d_hidden, cfg.n_classes],
                                generator=generator, device=dev,
                                dtype=cfg.dtype)}


def gin_forward(params: dict, batch: dict, cfg: GINConfig, *,
                device=None) -> torch.Tensor:
    """Graph logits [n_graphs, n_classes]. ``batch``: ``node_feat`` [N, F],
    ``graph_ids`` int [N] (-1 for none) and ``n_graphs``, and
    ``edge_index`` int32[2, E] (-1 pads) for ``"segment"`` or ``tiled`` (a
    SlimSell layout whose row v holds the senders of v's messages) for
    ``"slimsell"``. Every tensor must lie on ``device`` (default: the
    card; raises when there is none)."""
    _check_aggregation(cfg.aggregation)
    dev = resolve_device(device)
    graph = "tiled" if cfg.aggregation == "slimsell" else "edge_index"
    _check_inputs(params, batch, ("node_feat", "graph_ids", graph), dev)
    x = batch["node_feat"].to(cfg.dtype)
    n = x.shape[0]
    for lp in params["layers"]:
        if cfg.aggregation == "slimsell":
            agg = spmm_aggregate(batch["tiled"], x)
        else:
            src, dst = batch["edge_index"]
            agg = seg_sum(gather_nodes(x, src), dst, n)
        x = mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * x + agg, act=torch.relu,
                      final_act=True)
    g = seg_sum(x, batch["graph_ids"], int(batch["n_graphs"]))
    return mlp_apply(params["readout"], g)


class GIN(_TreeModel):
    """GIN as a module: ``forward`` is ``gin_forward``."""
    init = staticmethod(gin_init)
    apply = staticmethod(gin_forward)


# ----------------------------------------------------------------------- EGNN


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    dtype: torch.dtype = torch.float32


def egnn_init(cfg: EGNNConfig, *, generator: Optional[torch.Generator] = None,
              device=None) -> dict:
    """``{"embed", "layers": [{"phi_e", "phi_x", "phi_h"}, ...],
    "readout"}``, every part an MLP of ``mlp_init``: the embedding
    ``d_in -> h``, per layer the edge MLP ``2h + 1 -> h -> h``, the
    coordinate MLP ``h -> h -> 1`` and the node MLP ``2h -> h -> h``, and
    the readout ``h -> h -> 1``; drawn from ``generator`` (default: a CPU
    generator seeded with 0) and placed on ``device`` (default: the card;
    raises when there is none)."""
    dev = resolve_device(device)
    generator = _generator(generator)
    h = cfg.d_hidden

    def mlp(sizes):
        return mlp_init(sizes, generator=generator, device=dev, dtype=cfg.dtype)
    embed = mlp([cfg.d_in, h])
    layers = [{"phi_e": mlp([2 * h + 1, h, h]), "phi_x": mlp([h, h, 1]),
               "phi_h": mlp([2 * h, h, h])} for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "readout": mlp([h, h, 1])}


def egnn_forward(params: dict, batch: dict, cfg: EGNNConfig, *,
                 device=None):
    """E(n)-equivariant message passing: ``(energy [n_graphs], coords
    [N, 3])``. ``batch``: ``node_feat`` [N, d_in], ``pos`` [N, 3],
    ``edge_index`` int32[2, E] (-1 pads; an edge u -> v carries u's
    message to v), ``graph_ids`` int [N] and ``n_graphs``. Every tensor
    must lie on ``device`` (default: the card; raises when there is
    none)."""
    dev = resolve_device(device)
    _check_inputs(params, batch, ("node_feat", "pos", "edge_index",
                                  "graph_ids"), dev)
    h = mlp_apply(params["embed"], batch["node_feat"].to(cfg.dtype))
    x = batch["pos"].to(cfg.dtype)
    n = h.shape[0]
    src, dst = batch["edge_index"]
    valid = (src >= 0)[:, None]
    deg = seg_sum(valid.to(torch.float32), dst, n).clamp_min(1.0)
    for lp in params["layers"]:
        xi, xj = gather_nodes(x, dst), gather_nodes(x, src)
        hi, hj = gather_nodes(h, dst), gather_nodes(h, src)
        d2 = torch.sum((xi - xj) ** 2, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"], torch.cat([hi, hj, torch.log1p(d2)], -1),
                      final_act=True) * valid
        coef = torch.tanh(mlp_apply(lp["phi_x"], m)) * valid
        # the relative vector normalised, the update a mean: both keep the
        # coordinates stable over the layers
        rel = (xi - xj) / (torch.sqrt(d2) + 1.0)
        x = x + seg_sum(rel * coef, dst, n) / deg
        agg = seg_sum(m, dst, n)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], -1))
    e = seg_sum(mlp_apply(params["readout"], h), batch["graph_ids"],
                int(batch["n_graphs"]))[:, 0]
    return e, x


class EGNN(_TreeModel):
    """EGNN as a module: ``forward`` is ``egnn_forward``."""
    init = staticmethod(egnn_init)
    apply = staticmethod(egnn_forward)


# --------------------------------------------------------------------- NequIP


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32      # channels per irrep order
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4
    dtype: torch.dtype = torch.float32


# the tensor-product paths of a layer, each weighted per edge and channel
# by the radial MLP: 0x0->0, 1x1->0, 2x2->0, 0x1->1, 1x0->1, 1x1->1,
# 2x1->1, 0x2->2, 1x1->2
N_PATHS = 9


def _rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis [..., n_rbf] of the distances ``r``, centres
    evenly on [0, cutoff], times the cosine envelope that reaches 0 at the
    cutoff."""
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=r.dtype, device=r.device)
    gamma = n_rbf / cutoff
    env = 0.5 * (torch.cos(math.pi * torch.clamp(r / cutoff, 0, 1)) + 1.0)
    return torch.exp(-gamma * (r[..., None] - mu) ** 2) * env[..., None]


def _y2(rhat: torch.Tensor) -> torch.Tensor:
    """The traceless symmetric rank-2 harmonic in Cartesian form,
    ``r̂ r̂ᵀ - I / 3`` [..., 3, 3]."""
    outer = rhat[..., :, None] * rhat[..., None, :]
    return outer - torch.eye(3, dtype=rhat.dtype, device=rhat.device) / 3.0


def nequip_init(cfg: NequIPConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """``{"embed" [n_species, c] ~ N(0, 0.25), "layers": [{"radial",
    "mix0", "mix1", "mix2", "gate"}, ...], "readout"}``: per layer the
    radial MLP ``n_rbf -> 32 -> 9c``, the channel mixers [2c, c] ~ N(0,
    1/2c) of each irrep order and the gate MLP ``c -> 2c``, and the readout
    ``c -> 16 -> 1``; drawn from ``generator`` (default: a CPU generator
    seeded with 0) and placed on ``device`` (default: the card; raises
    when there is none)."""
    dev = resolve_device(device)
    generator = _generator(generator)
    c = cfg.d_hidden

    def mlp(sizes):
        return mlp_init(sizes, generator=generator, device=dev, dtype=cfg.dtype)

    def mix():
        return _normal((2 * c, c), (2 * c) ** -0.5, generator, dev, cfg.dtype)
    embed = _normal((cfg.n_species, c), 0.5, generator, dev, cfg.dtype)
    layers = [{"radial": mlp([cfg.n_rbf, 32, N_PATHS * c]), "mix0": mix(),
               "mix1": mix(), "mix2": mix(), "gate": mlp([c, 2 * c])}
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "readout": mlp([c, 16, 1])}


def nequip_forward(params: dict, batch: dict, cfg: NequIPConfig, *,
                   device=None) -> torch.Tensor:
    """Interatomic potential: energy [n_graphs]. ``batch``: ``species``
    int [N], ``pos`` [N, 3], ``edge_index`` int32[2, E] (-1 pads; an edge
    u -> v carries u's message to v), ``graph_ids`` int [N] and
    ``n_graphs``. Each layer: per edge the tensor products of the sender's
    irreps with the edge's harmonics (Y0 = 1, Y1 = r̂, Y2 = r̂ r̂ᵀ - I/3),
    weighted by the radial MLP; summed at the receiver; the channels of
    each order mixed over self and sum; a gated nonlinearity (SiLU on the
    scalars, sigmoid gates of the scalars on l > 0). Every tensor must lie
    on ``device`` (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    _check_inputs(params, batch, ("species", "pos", "edge_index",
                                  "graph_ids"), dev)
    c = cfg.d_hidden
    pos = batch["pos"].to(cfg.dtype)
    n = pos.shape[0]
    src, dst = batch["edge_index"]
    valid = src >= 0
    eye = torch.eye(3, dtype=cfg.dtype, device=pos.device)
    h0 = gather_nodes(params["embed"], batch["species"])
    h1 = pos.new_zeros((n, c, 3))
    h2 = pos.new_zeros((n, c, 3, 3))

    rvec = gather_nodes(pos, dst) - gather_nodes(pos, src)
    r = torch.sqrt(torch.sum(rvec ** 2, -1) + 1e-12)
    y1 = rvec / r[..., None]                                  # [E, 3]
    y2 = _y2(y1)                                              # [E, 3, 3]
    rb = _rbf(r, cfg.n_rbf, cfg.cutoff) * valid[:, None]
    vmask = valid[:, None].to(cfg.dtype)

    for lp in params["layers"]:
        w = mlp_apply(lp["radial"], rb).reshape(-1, N_PATHS, c)  # [E, path, c]
        s0, s1, s2 = (gather_nodes(h0, src), gather_nodes(h1, src),
                      gather_nodes(h2, src))
        m0 = (w[:, 0] * s0                                          # 0x0->0
              + w[:, 1] * torch.einsum("eci,ei->ec", s1, y1)        # 1x1->0
              + w[:, 2] * torch.einsum("ecij,eij->ec", s2, y2))     # 2x2->0
        m1 = (w[:, 3, :, None] * s0[..., None] * y1[:, None, :]     # 0x1->1
              + w[:, 4, :, None] * s1                               # 1x0->1
              + w[:, 5, :, None] * torch.linalg.cross(
                  s1, y1[:, None, :], dim=-1)                       # 1x1->1
              + w[:, 6, :, None] * torch.einsum("ecij,ej->eci", s2, y1))  # 2x1->1
        outer = 0.5 * (s1[..., :, None] * y1[:, None, None, :]
                       + s1[..., None, :] * y1[:, None, :, None])
        tr = torch.einsum("ecii->ec", outer)
        sym = outer - tr[..., None, None] * eye / 3.0               # 1x1->2
        m2 = (w[:, 7, :, None, None] * s0[..., None, None] * y2[:, None]  # 0x2->2
              + w[:, 8, :, None, None] * sym)
        a0 = seg_sum(m0 * vmask, dst, n)
        a1 = seg_sum(m1 * vmask[..., None], dst, n)
        a2 = seg_sum(m2 * vmask[..., None, None], dst, n)
        h0n = torch.cat([h0, a0], -1) @ lp["mix0"]
        h1n = torch.einsum("ncx,cd->ndx", torch.cat([h1, a1], 1), lp["mix1"])
        h2n = torch.einsum("ncxy,cd->ndxy", torch.cat([h2, a2], 1), lp["mix2"])
        g1, g2 = torch.chunk(torch.sigmoid(mlp_apply(lp["gate"], h0n)), 2,
                             dim=-1)
        h0 = F.silu(h0n)
        h1 = h1n * g1[..., None]
        h2 = h2n * g2[..., None, None]
    e_atom = mlp_apply(params["readout"], h0)[:, 0]
    return seg_sum(e_atom, batch["graph_ids"], int(batch["n_graphs"]))


class NequIP(_TreeModel):
    """NequIP as a module: ``forward`` is ``nequip_forward``."""
    init = staticmethod(nequip_init)
    apply = staticmethod(nequip_forward)
