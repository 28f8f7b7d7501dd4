"""Rank functions of the port's gloo mesh tests (tests/test_torch_lm_mesh.py,
tests/test_torch_dlrm_mesh.py, tests/test_torch_moe_ep.py): each runs a list of cases on one rank of a
``distributed.launch`` world and returns what the tests compare. This
module imports no JAX, so the spawned ranks stay light; the tests compute
the JAX package's references in their own process.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models import dlrm as pdlrm
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptf
from repro_torch.models.sharding import (AxisRules, gather_shard,
                                         local_shard, shard_dim)

A2A_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int16)


def a2a_block(rank: int, j: int, dtype) -> torch.Tensor:
    """The block rank ``rank`` sends to member ``j`` in
    ``all_to_all_blocks``: three values naming both, exact in ``dtype``
    (negative for the integers, so the int16 bytes carry a sign)."""
    if dtype.is_floating_point:
        v = torch.tensor([10 * rank + j + 0.5, -(10 * rank + j), 0.25 * j])
    else:
        v = torch.tensor([1000 * rank + j - 2000, -j, rank])
    return v.to(dtype)


def all_to_all_blocks(grid) -> dict:
    """``Grid.all_to_all`` over each axis of the grid and over all of it,
    in each of ``A2A_DTYPES``: this rank sends ``a2a_block(rank, j)`` to
    the member of flat index j; returns what it received, as float64
    arrays keyed by (axes, dtype name), with its coordinates."""
    out = {"coords": dict(grid.coords), "rank": grid.rank}
    for axes in [(a,) for a in grid.axis_names] + [tuple(grid.axis_names)]:
        n = int(np.prod([grid.axis_size(a) for a in axes]))
        for dt in A2A_DTYPES:
            t = torch.stack([a2a_block(grid.rank, j, dt) for j in range(n)])
            got = grid.all_to_all(t, axes)
            assert got.dtype == dt and got.shape == t.shape
            out[(axes, str(dt))] = got.double().numpy()
    return out


def lm_config(fields: dict) -> ptf.LMConfig:
    fields = dict(fields)
    fields["dtype"] = {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[fields["dtype"]]
    return ptf.LMConfig(**fields)


def _refusals(params, toks, cfg, ctx) -> dict:
    """What the ctx paths refuse and run: for an MoE config, the
    expert-parallel MoE (moe_impl="ep") on the case's tokens (runs), on a
    batch of 3 and on one position fewer (raises ``ValueError`` where the
    batch or the sequence does not split), and a decode step at a batch of
    3 (runs, the batch replicated); and grad mode under a ShardCtx (raises
    ``NotImplementedError``)."""
    out = {}
    if cfg.moe:
        ep = dataclasses.replace(ctx, moe_impl="ep")
        with torch.no_grad():
            ptf.forward(params, toks, cfg, ep)
            out["ep"] = "runs"
            for what, t in (("batch", toks[:3]), ("sequence", toks[:, :-1])):
                try:
                    ptf.forward(params, t, cfg, ep)
                    out[f"ep {what}"] = "runs"
                except ValueError as e:
                    out[f"ep {what}"] = str(e)
            cache = ptf.init_cache(cfg, 3, toks.shape[1], ctx=ep)
            ptf.decode_step(params, cache, toks[:3, 0],
                            torch.zeros(3, dtype=torch.int32,
                                        device=toks.device), cfg, ep)
            out["ep decode batch 3"] = "runs"
    try:
        ptf.forward(params, toks, cfg, ctx)
    except NotImplementedError as e:
        out["grad"] = str(e)
    return out


def lm_cases(grid, cases: list) -> list:
    """Each case: ``cfg`` (LMConfig fields, dtype by name), ``params`` (the
    whole weights as float32 numpy arrays), ``toks`` / ``labels`` [B, S],
    ``cache_len``, ``dec_tok`` / ``dec_pos`` [steps, B], ``seq_shard``,
    ``moe_impl``. Returns, gathered whole: the forward's logits, the loss,
    the prefill's last logits and cache, each decode step's logits, the
    weights' round trip, the refusals, the collectives' counts and the
    expert-parallel MoE's counts over the forward (``moe.STATS``, with its
    routing). A case ``{"all_to_all": True}`` returns
    ``all_to_all_blocks(grid)`` instead."""
    out = []
    for c in cases:
        if c.get("all_to_all"):
            out.append(all_to_all_blocks(grid))
            continue
        cfg = lm_config(c["cfg"])
        ctx = ptf.ShardCtx(grid, AxisRules.for_mesh(grid),
                           cache_seq_shard=c.get("seq_shard", False),
                           moe_impl=c.get("moe_impl", "ep"))
        params = convert.lm_shards_from_arrays(c["params"], cfg, ctx)
        dev = grid.device
        toks = torch.tensor(c["toks"], device=dev)
        B = toks.shape[0]
        res = {"mode": ptf._attn_mode(cfg, ctx)}
        grid.stats.reset()
        with torch.no_grad():
            pmoe.STATS.reset(record=True)
            lg = ptf.forward(params, toks, cfg, ctx)
            res["ep"] = pmoe.STATS.snapshot()
            res["routes"] = pmoe.STATS.routes
            pmoe.STATS.reset()              # the forward's alone
            res["logits"] = gather_shard(lg, ptf.logits_spec(cfg, ctx, B),
                                         grid).float().cpu().numpy()
            if "labels" in c:
                res["loss"] = float(ptf.loss_fn(
                    params, {"tokens": toks,
                             "labels": torch.tensor(c["labels"], device=dev)},
                    cfg, ctx))
            if "cache_len" in c:
                last, cache = ptf.prefill(params, toks, cfg, ctx,
                                          cache_len=c["cache_len"])
                last_spec = ptf.logits_spec(cfg, ctx, B, seq=False)
                res["last"] = gather_shard(last, last_spec,
                                           grid).float().cpu().numpy()
                res["cache"] = convert.lm_cache_arrays_from_shards(
                    cache, cfg, ctx, B)
                res["local_cache"] = tuple(cache["k"].shape)
                dec = []
                for tok, pos in zip(c["dec_tok"], c["dec_pos"]):
                    d, cache = ptf.decode_step(
                        params, cache, torch.tensor(tok, device=dev),
                        torch.tensor(pos, device=dev), cfg, ctx)
                    dec.append(gather_shard(d, last_spec,
                                            grid).float().cpu().numpy())
                res["decode"] = np.stack(dec, 1)
            back = convert.lm_arrays_from_shards(params, cfg, ctx)
        res["stats"] = grid.stats.snapshot()
        res["roundtrip"] = all(
            np.array_equal(a, b) for a, b in zip(
                _leaves(back), _leaves(c["params"])))
        res["refusals"] = _refusals(params, toks, cfg, ctx)
        out.append(res)
    return out


def _leaves(tree):
    from repro_torch import pytree
    return pytree.leaves(tree)


# ----------------------------------------------------------------- DLRM


def dlrm_cases(grid, cases: list) -> list:
    """Each case: ``cfg`` (DLRMConfig fields), ``params`` (the whole
    weights as numpy arrays), ``batch`` (numpy dense / sparse), ``hybrid``,
    and optionally ``cands`` [N, d] and ``user`` [1, n_dense]. Returns the
    logits gathered whole, the retrieval scores, the weights' round trip
    and the local tables' row counts."""
    from repro_torch.kernels import ops
    out = []
    for c in cases:
        cfg = pdlrm.DLRMConfig(**c["cfg"])
        ctx = ptf.ShardCtx(grid, AxisRules.for_mesh(grid))
        dev = grid.device
        params = convert.dlrm_shards_from_arrays(c["params"], cfg, ctx,
                                                 hybrid=c["hybrid"])
        batch = convert.dlrm_batch_from_arrays(c["batch"], device=dev)
        B = batch["dense"].shape[0]
        res = {"rows": [t.shape[0] for t in params["tables"]]}
        grid.stats.reset()
        ops.reset_launches()
        with torch.no_grad():
            y = pdlrm.dlrm_forward(params, batch, cfg, ctx=ctx,
                                   hybrid=c["hybrid"])
            res["launches"] = ops.launch_counts()
            res["logits"] = gather_shard(y, (pdlrm.batch_entry(ctx, B),),
                                         grid).cpu().numpy()
            res["stats"] = grid.stats.snapshot()
            if "cands" in c:
                N = c["cands"].shape[0]
                entry = pdlrm.batch_entry(ctx, N)
                from repro_torch.models.sharding import local_shard
                cands = local_shard(torch.tensor(c["cands"], device=dev),
                                    (entry, None), grid)
                u = pdlrm.dlrm_user_tower(
                    params, {"dense": torch.tensor(c["user"], device=dev)},
                    cfg, device=dev)[0]
                res["scores"] = pdlrm.retrieval_scores(
                    u, cands, ctx=ctx, n_candidates=N).cpu().numpy()
            back = convert.dlrm_arrays_from_shards(params, cfg, ctx,
                                                   hybrid=c["hybrid"])
        res["roundtrip"] = all(np.array_equal(a, b) for a, b in zip(
            back["tables"], c["params"]["tables"]))
        try:
            pdlrm.dlrm_forward(params, batch, cfg, ctx=ctx,
                               hybrid=c["hybrid"])
        except NotImplementedError as e:
            res["grad_refused"] = str(e)
        out.append(res)
    return out


# ------------------------------------------------------------ expert parallel


def moe_ep_cases(grid, cases: list) -> list:
    """Each case: ``dims`` (MoEDims fields), ``dtype`` by name, ``x``
    [B, S, D], ``wr`` [D, E], ``wig`` / ``wiu`` [E, D, F], ``wo`` [E, F, D]
    (float32 arrays, whole), ``train`` / ``decode``. The rank keeps its
    blocks (x under (dp, tp, None), the experts under (tp, fsdp, None) /
    (tp, None, fsdp) where D splits) and runs ``moe_ep_train`` on x and
    ``moe_ep_decode`` on ``x[:, :1]``; returns the outputs gathered whole
    (float32), ``moe.STATS``' counts of the train call and its routing."""
    rules = AxisRules.for_mesh(grid)
    kw = dict(dp=rules.dp, tp=rules.tp, fsdp=rules.fsdp)
    out = []
    for c in cases:
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[c["dtype"]]
        dims = pmoe.MoEDims(**c["dims"])
        x = torch.tensor(c["x"]).to(dt)
        B, S, D = x.shape
        wr = torch.tensor(c["wr"])
        e_ax = shard_dim(grid, dims.n_experts, rules.tp)
        d_ax = shard_dim(grid, D, rules.fsdp)
        ws = [local_shard(torch.tensor(c[n]).to(dt), spec_, grid).clone()
              for n, spec_ in (("wig", (e_ax, d_ax, None)),
                               ("wiu", (e_ax, d_ax, None)),
                               ("wo", (e_ax, None, d_ax)))]
        b_ax = shard_dim(grid, B, rules.dp)
        res = {}
        with torch.no_grad():
            if c["train"]:
                spec_ = (b_ax, shard_dim(grid, S, rules.tp), None)
                pmoe.STATS.reset(record=True)
                y = pmoe.moe_ep_train(local_shard(x, spec_, grid), wr, *ws,
                                     dims, grid, **kw)
                res["stats"] = pmoe.STATS.snapshot()
                res["routes"] = pmoe.STATS.routes
                pmoe.STATS.reset()
                res["train"] = gather_shard(y, spec_, grid).float().numpy()
            if c["decode"]:
                spec_ = (b_ax, None, None)
                y = pmoe.moe_ep_decode(local_shard(x[:, :1], spec_, grid), wr,
                                      *ws, dims, grid, **kw)
                res["decode"] = gather_shard(y, spec_, grid).float().numpy()
        out.append(res)
    return out
