"""Rank functions of the port's gloo mesh tests (tests/test_torch_lm_mesh.py,
tests/test_torch_dlrm_mesh.py): each runs a list of cases on one rank of a
``distributed.launch`` world and returns what the tests compare. This
module imports no JAX, so the spawned ranks stay light; the tests compute
the JAX package's references in their own process.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models import dlrm as pdlrm
from repro_torch.models import transformer as ptf
from repro_torch.models.sharding import AxisRules, gather_shard


def lm_config(fields: dict) -> ptf.LMConfig:
    fields = dict(fields)
    fields["dtype"] = {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[fields["dtype"]]
    return ptf.LMConfig(**fields)


def _refusals(params, toks, cfg, ctx) -> dict:
    """The messages of the two refusals: the expert-parallel MoE (an MoE
    config under moe_impl="ep") and grad mode under a ShardCtx."""
    out = {}
    if cfg.moe:
        ep = dataclasses.replace(ctx, moe_impl="ep")
        try:
            with torch.no_grad():
                ptf.forward(params, toks, cfg, ep)
        except NotImplementedError as e:
            out["ep"] = str(e)
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
    weights' round trip, the refusals and the collectives' counts."""
    out = []
    for c in cases:
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
            lg = ptf.forward(params, toks, cfg, ctx)
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
