"""DLRM inference (Naumov et al., arXiv:1906.00091), the port of the JAX
package's ``repro/models/dlrm.py``: embedding bags, a bottom MLP over the
dense features, the dot interaction and a top MLP.

The sparse lookup is the hot path. ``_lookup_all`` sends all of a
forward's fields at once to ``kernels.ops.embedding_bag_grouped``: CUDA
tables to one launch of the hand-written embedding-bag kernel
(``kernels/csrc/embedding_bag.cu``), CPU tables to its plain version
(``kernels.ref.embedding_bag_grouped_ref``, one ``embedding_bag_ref`` a
table). There is no ``use_kernel`` switch:
``repro``'s ``use_kernel=True`` (the Pallas kernel) is the card here,
``use_kernel=False`` (its jnp oracle) is ``device="cpu"``. Both sum a bag
in slot order, so on the card the kernel and the plain version give the
same bits. ``dlrm_forward`` has the bags written straight into the
[B, 1 + n_sparse, d] tensor the interaction multiplies, beside the bottom
MLP's output, so no stack copies them again.

The MLPs and the interaction are plain float32 products, as ``repro``
leaves them to XLA outside any kernel: ``torch.matmul`` and ``torch.bmm``,
in full float32 (PyTorch's default, ``allow_tf32`` False). Inference only:
the kernel has no backward, so on the card the forward runs under
``torch.no_grad()`` or ``torch.inference_mode()`` when the tables require
grad. ``retrieval_scores`` scores one user against many candidates as one
matrix-vector product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..core.formats import resolve_device
from ..kernels import ops
from .gnn import _placed, mlp_apply, mlp_init

# MLPerf Criteo-1TB per-table cardinalities (public benchmark config)
MLPERF_VOCABS = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    embed_dim: int = 128
    vocabs: Sequence[int] = tuple(MLPERF_VOCABS)
    bot_mlp: Sequence[int] = (13, 512, 256, 128)
    top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1)
    multi_hot: int = 1            # bag size per sparse field
    dtype: torch.dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocabs)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def top_sizes(cfg: DLRMConfig) -> list:
    """The top MLP's layer sizes: the bottom output beside the interactions,
    then ``cfg.top_mlp``."""
    return [cfg.n_interactions + cfg.bot_mlp[-1]] + list(cfg.top_mlp)


def dlrm_init(cfg: DLRMConfig, *, generator: Optional[torch.Generator] = None,
              device=None) -> dict:
    """``{"tables": [...], "bot": [...], "top": [...]}`` on ``device``
    (default: the card; raises when there is none). Each table is
    N(0, 1 / embed_dim): drawn from ``generator`` (default: a generator on
    ``device`` seeded with 0) on the generator's device and scaled there in
    place, so a card generator makes a table of gigabytes on the card with
    no second copy. The MLPs are He-normal (``mlp_init``), from the same
    generator."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(cfg.embed_dim)
    tables = []
    for v in cfg.vocabs:
        t = torch.randn((v, cfg.embed_dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
        tables.append(t.mul_(scale).to(device=dev, dtype=cfg.dtype))
    return {"tables": tables,
            "bot": mlp_init(list(cfg.bot_mlp), generator=generator, device=dev,
                            dtype=cfg.dtype),
            "top": mlp_init(top_sizes(cfg), generator=generator, device=dev,
                            dtype=cfg.dtype)}


def _lookup_all(tables: Sequence[torch.Tensor], sparse: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sparse int32[B, n_sparse, K] (-1 pads) -> [B, n_sparse, d] (into
    ``out`` when given), each bag summed in slot order: one kernel launch
    for CUDA tables, the plain version for CPU tables."""
    return ops.embedding_bag_grouped(tables, sparse, "sum", out=out)


def _check_placement(params: dict, batch: dict, dev: torch.device,
                     keys: Sequence[str]) -> None:
    for part in ("bot", "top"):
        for i, layer in enumerate(params.get(part, ())):
            for k in ("w", "b"):
                _placed(layer[k], dev, f"params[{part!r}][{i}][{k!r}]")
    for i, t in enumerate(params.get("tables", ())):
        _placed(t, dev, f"params['tables'][{i}]")
    for key in keys:
        _placed(batch[key], dev, f"batch[{key!r}]")


def bottom(params: dict, dense: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """The bottom MLP over the dense features, ReLU after every layer."""
    return mlp_apply(params["bot"], dense.to(cfg.dtype), act=torch.relu,
                     final_act=True)


def lookups(params: dict, sparse: torch.Tensor) -> list:
    """One embedding bag a field: sparse int32[B, n_sparse, multi_hot] ->
    a list of n_sparse [B, d] (views of one [B, n_sparse, d] tensor)."""
    return list(_lookup_all(params["tables"], sparse).unbind(1))


def interact(dense: torch.Tensor, embs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The dot interaction: the pairwise dot products of the bottom output
    and the field embeddings (the upper triangle, in ``jnp.triu_indices``'
    order), beside the bottom output -> [B, d + f(f-1)/2]."""
    return _interact(torch.stack([dense, *embs], dim=1))


def _interact(Z: torch.Tensor) -> torch.Tensor:
    """``interact`` of Z [B, f, d], the bottom output at Z[:, 0] and the
    field embeddings after it."""
    ZZt = torch.bmm(Z, Z.transpose(1, 2))                       # [B, f, f]
    f = Z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=Z.device)
    return torch.cat([Z[:, 0], ZZt[:, iu, ju]], dim=-1)


def top(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The top MLP, ReLU between layers -> logits [B]."""
    return mlp_apply(params["top"], x, act=torch.relu)[:, 0]


def dlrm_forward(params: dict, batch: dict, cfg: DLRMConfig, *,
                 device=None) -> torch.Tensor:
    """batch: ``dense`` float [B, n_dense], ``sparse`` int32 [B, n_sparse,
    multi_hot] (-1 pads) -> logits [B]. Every tensor must lie on ``device``
    (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    _check_placement(params, batch, dev, ("dense", "sparse"))
    dense = bottom(params, batch["dense"], cfg)                 # [B, d]
    tables = params["tables"]
    Z = dense.new_empty((dense.shape[0], 1 + len(tables), dense.shape[1]))
    Z[:, 0] = dense
    _lookup_all(tables, batch["sparse"], Z[:, 1:])
    return top(params, _interact(Z))


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig, *,
              device=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the JAX package's stable form. Forward only."""
    z = dlrm_forward(params, batch, cfg, device=device).to(torch.float32)
    y = batch["label"].to(torch.float32)
    return torch.mean(z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs())))


def retrieval_scores(user_vec: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """[d] x [N_cand, d] -> [N_cand]; one matrix-vector product."""
    return cand_vecs @ user_vec


def dlrm_user_tower(params: dict, batch: dict, cfg: DLRMConfig, *,
                    device=None) -> torch.Tensor:
    """User embedding for retrieval: the bottom MLP's output (two-tower
    style) -> [B, d]."""
    dev = resolve_device(device)
    _check_placement({"bot": params["bot"]}, batch, dev, ("dense",))
    return bottom(params, batch["dense"], cfg)


class DLRM(nn.Module):
    """DLRM as a module: its tables and MLP weights ``ParameterList``s,
    ``forward`` the same function as ``dlrm_forward`` on the weights'
    device. On the card, call it under ``torch.inference_mode()``: the
    embedding-bag kernel refuses tables that require grad in grad mode."""

    def __init__(self, cfg: DLRMConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = dlrm_init(cfg, generator=generator, device=device)
        self.tables = nn.ParameterList(nn.Parameter(t) for t in params["tables"])
        for part in ("bot", "top"):
            setattr(self, part, nn.ParameterList(
                nn.Parameter(layer[k]) for layer in params[part]
                for k in ("w", "b")))

    def params(self) -> dict:
        """The weights as ``dlrm_forward``'s dict (the same tensors)."""
        def layers(plist):
            return [{"w": plist[i], "b": plist[i + 1]}
                    for i in range(0, len(plist), 2)]
        return {"tables": list(self.tables), "bot": layers(self.bot),
                "top": layers(self.top)}

    def forward(self, batch: dict) -> torch.Tensor:
        return dlrm_forward(self.params(), batch, self.cfg,
                            device=self.tables[0].device)
