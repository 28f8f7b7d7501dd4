"""DLRM (Naumov et al., arXiv:1906.00091), the port of the JAX package's
``repro/models/dlrm.py``: embedding bags, a bottom MLP over the dense
features, the dot interaction and a top MLP; inference and training.

The sparse lookup is the hot path. ``_lookup_all`` sends all of a
forward's fields at once to ``kernels.ops.embedding_bag_grouped``: CUDA
tables to one launch of the hand-written embedding-bag kernel
(``kernels/csrc/embedding_bag.cu``), CPU tables to its plain version
(``kernels.ref.embedding_bag_grouped_ref``, one ``embedding_bag_ref`` a
table). There is no ``use_kernel`` switch:
``repro``'s ``use_kernel=True`` (the Pallas kernel) is the card here,
``use_kernel=False`` (its jnp oracle) is ``device="cpu"``. Both sum a bag
in slot order, so on the card the kernel and the plain version give the
same bits. Outside grad mode ``dlrm_forward`` has the bags written
straight into the [B, 1 + n_sparse, d] tensor the interaction multiplies,
beside the bottom MLP's output, so no stack copies them again.

Under grad mode (``dlrm_loss`` in a train step) the lookups go through
``kernels.autograd.bag_lookup``: the same launch, into a new tensor, with
a backward that scatters the bags' gradients into dense table gradients
(``index_add_``, in no fixed order on the card). The interaction's tensor
is then the bottom output and the bags joined by ``torch.cat``, not a
write into a view of it, so autograd sees every part.

**On a mesh** (``ctx``, a ``models.transformer.ShardCtx`` over the
world's ``distributed.Grid``) the tables are row-sharded over ``tp`` as
the JAX package's DLRM cells place them (``configs.cells.dlrm_param_specs``):
each vocabulary padded to a multiple of the ``tp`` extent with rows of
zeros that no id names, and every table split into row blocks, or with
``hybrid`` only the tables of at least ``HYBRID_MIN_ROWS`` padded rows
(the others whole on every rank). A rank remaps each sharded field's ids
to its row block (``id - lo`` inside ``[lo, hi)``, else -1, a pad) and
runs **one** launch of the bag kernel over all of its local tables; the
sharded fields' bags are SUM-reduced over ``tp`` (one rank adds each id's
row, so at one id a bag the sum is that row, bit for bit), the whole
tables' are not (they would count ``tp`` times). The batch is split over
``dp`` where it divides: the MLPs and the interaction run on the rank's
batch block, and the logits are that block. ``retrieval_scores`` takes
the rank's block of the candidates (split over ``dp``) and gathers the
scores.

The MLPs and the interaction are plain float32 products, as ``repro``
leaves them to XLA outside any kernel: ``torch.matmul`` and ``torch.bmm``,
in full float32 (PyTorch's default, ``allow_tf32`` False).
``retrieval_scores`` scores one user against many candidates as one
matrix-vector product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..core.formats import resolve_device
from ..kernels import autograd, ops
from .gnn import _placed, mlp_apply, mlp_init
from .sharding import block, entry_axes, local_shard, shard_dim

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


# with hybrid placement, the tables of at least this many (padded) rows are
# row-sharded over tp; the others are whole on every rank
HYBRID_MIN_ROWS = 1_000_000


def padded_rows(vocab: int, tp_size: int) -> int:
    """A vocabulary padded to a multiple of the ``tp`` extent."""
    return -(-vocab // tp_size) * tp_size


def table_sharded(vocab: int, tp_size: int, hybrid: bool) -> bool:
    """Whether a table of ``vocab`` rows is row-sharded over ``tp``: every
    table, or with ``hybrid`` those of at least ``HYBRID_MIN_ROWS`` padded
    rows."""
    return padded_rows(vocab, tp_size) >= (HYBRID_MIN_ROWS if hybrid else 0)


def _tp_size(ctx) -> int:
    return ctx.grid.axis_size(ctx.rules.tp)


def table_shard(table: torch.Tensor, ctx, hybrid: bool) -> torch.Tensor:
    """The rank's block of a whole table: padded with zero rows to a
    multiple of the ``tp`` extent and cut to its row block where the table
    is sharded, else the table itself."""
    tp = _tp_size(ctx)
    if not table_sharded(table.shape[0], tp, hybrid):
        return table
    pad = padded_rows(table.shape[0], tp) - table.shape[0]
    if pad:
        table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
    return local_shard(table, (ctx.rules.tp, None), ctx.grid).clone()


def dlrm_init(cfg: DLRMConfig, *, generator: Optional[torch.Generator] = None,
              device=None, ctx=None, hybrid: bool = False) -> dict:
    """``{"tables": [...], "bot": [...], "top": [...]}`` on ``device``
    (default: the card, or the grid's device under ``ctx``; raises when
    there is none). Each table is N(0, 1 / embed_dim): drawn from
    ``generator`` (default: a generator on ``device`` seeded with 0) on the
    generator's device and scaled there in place, so a card generator makes
    a table of gigabytes on the card with no second copy. The MLPs are
    He-normal (``mlp_init``), from the same generator. With ``ctx`` every
    table is drawn whole and the rank keeps its block (``table_shard``):
    the same weights as one device's, padded, and no rank holds them all."""
    dev = resolve_device(device) if ctx is None or device is not None \
        else torch.device(ctx.grid.device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(cfg.embed_dim)
    tables = []
    for v in cfg.vocabs:
        t = torch.randn((v, cfg.embed_dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
        t = t.mul_(scale).to(device=dev, dtype=cfg.dtype)
        tables.append(t if ctx is None else table_shard(t, ctx, hybrid))
        del t
    return {"tables": tables,
            "bot": mlp_init(list(cfg.bot_mlp), generator=generator, device=dev,
                            dtype=cfg.dtype),
            "top": mlp_init(top_sizes(cfg), generator=generator, device=dev,
                            dtype=cfg.dtype)}


def _lookup_all(tables: Sequence[torch.Tensor], sparse: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sparse int32[B, n_sparse, K] (-1 pads) -> [B, n_sparse, d] (into
    ``out`` when given), each bag summed in slot order: one kernel launch
    for CUDA tables, the plain version for CPU tables. Under grad mode the
    launch goes through ``autograd.bag_lookup`` into a new tensor, and
    ``out`` is refused."""
    if torch.is_grad_enabled():
        if out is not None:
            raise ValueError("under grad mode the lookups write a new tensor; "
                             "out= is for inference")
        return autograd.bag_lookup(tables, sparse, "sum")
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


def batch_entry(ctx, batch: int):
    """The spec entry of the batch on a mesh: ``dp`` where it divides."""
    return shard_dim(ctx.grid, batch, ctx.rules.dp)


def local_ids(sparse: torch.Tensor, tables: Sequence[torch.Tensor], cfg,
              ctx, hybrid: bool) -> torch.Tensor:
    """Each sharded field's ids remapped to the rank's row block of its
    table (``id - lo`` inside ``[lo, lo + rows)``, else -1); a whole
    table's ids as they are."""
    tp = _tp_size(ctx)
    rows, lo = [], []
    for v, t in zip(cfg.vocabs, tables):
        split = table_sharded(v, tp, hybrid)
        rows.append(t.shape[0] if split else -1)
        lo.append(ctx.grid.index((ctx.rules.tp,)) * t.shape[0] if split
                  else 0)
    rows = torch.tensor(rows, device=sparse.device)[None, :, None]
    ids = sparse - torch.tensor(lo, dtype=sparse.dtype,
                                device=sparse.device)[None, :, None]
    mine = (ids >= 0) & (ids < rows)
    return torch.where((rows < 0) | mine, ids, torch.full_like(ids, -1))


def _forward_mesh(params: dict, batch: dict, cfg: DLRMConfig, ctx,
                  hybrid: bool) -> torch.Tensor:
    """``dlrm_forward`` on a rank (the module docstring)."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "DLRM training on a mesh (train_batch_hybrid, train_batch_dp256) "
            "waits for the training-on-a-mesh slice with build_dlrm_cell "
            "(ROADMAP module queue 2.3); run the forward under "
            "torch.no_grad()")
    grid, tp = ctx.grid, (ctx.rules.tp,)
    B = batch["dense"].shape[0]
    rows = block(batch_entry(ctx, B), B, grid)
    dense = bottom(params, batch["dense"][rows], cfg)
    tables = params["tables"]
    ids = local_ids(batch["sparse"][rows], tables, cfg, ctx, hybrid)
    Z = dense.new_empty((dense.shape[0], 1 + len(tables), dense.shape[1]))
    Z[:, 0] = dense
    _lookup_all(tables, ids, Z[:, 1:])           # one launch, every table
    split = [1 + i for i, v in enumerate(cfg.vocabs)
             if table_sharded(v, _tp_size(ctx), hybrid)]
    if split and _tp_size(ctx) > 1:
        Z[:, split] = grid.all_reduce(Z[:, split], "sum", tp)
    return top(params, _interact(Z))


def dlrm_forward(params: dict, batch: dict, cfg: DLRMConfig, *,
                 device=None, ctx=None, hybrid: bool = False) -> torch.Tensor:
    """batch: ``dense`` float [B, n_dense], ``sparse`` int32 [B, n_sparse,
    multi_hot] (-1 pads) -> logits [B]. Every tensor must lie on ``device``
    (default: the card; raises when there is none). Under ``ctx`` (inference
    only) the tables are the rank's blocks (``dlrm_init(ctx=)``,
    ``convert.dlrm_shards_from_arrays``), the batch is the whole batch on
    every rank, and the logits are the rank's batch block
    (``batch_entry``)."""
    dev = resolve_device(device) if ctx is None or device is not None \
        else torch.device(ctx.grid.device)
    _check_placement(params, batch, dev, ("dense", "sparse"))
    if ctx is not None:
        return _forward_mesh(params, batch, cfg, ctx, hybrid)
    dense = bottom(params, batch["dense"], cfg)                 # [B, d]
    tables = params["tables"]
    if torch.is_grad_enabled():
        Z = torch.cat([dense[:, None], _lookup_all(tables, batch["sparse"])],
                      dim=1)
    else:
        Z = dense.new_empty((dense.shape[0], 1 + len(tables), dense.shape[1]))
        Z[:, 0] = dense
        _lookup_all(tables, batch["sparse"], Z[:, 1:])
    return top(params, _interact(Z))


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig, *,
              device=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the JAX package's stable form ``max(z, 0) - z y + log1p(exp(-|z|))``;
    differentiable (the loss of ``repro``'s ``train_batch`` cell)."""
    z = dlrm_forward(params, batch, cfg, device=device).to(torch.float32)
    y = batch["label"].to(torch.float32)
    return torch.mean(z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs())))


def retrieval_scores(user_vec: torch.Tensor, cand_vecs: torch.Tensor,
                     *, ctx=None, n_candidates: Optional[int] = None
                     ) -> torch.Tensor:
    """[d] x [N_cand, d] -> [N_cand]; one matrix-vector product. Under
    ``ctx`` ``cand_vecs`` is the rank's block of ``n_candidates`` rows
    (split over ``dp`` where they divide) and the scores are gathered
    whole on every rank."""
    scores = cand_vecs @ user_vec
    if ctx is None:
        return scores
    entry = batch_entry(ctx, n_candidates)
    if not entry_axes(entry):
        return scores
    return ctx.grid.all_gather_dim(scores, 0, entry_axes(entry))


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
    device (under grad mode, through the lookups' autograd route)."""

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
