"""The Mixture-of-Experts FFN, the port of the JAX package's
``repro/models/moe.py``: ``MoEDims``, the router, the SwiGLU expert FFN,
``moe_reference`` (every expert runs over every token and a masked
combine keeps the routed ones, O(E N D F) FLOPs), and the two
expert-parallel paths on ``torch.distributed`` (``distributed.Grid``).

``moe_ep_train`` (prefill and the teacher-forced forward on a mesh):
``x`` is the rank's block ``[B/dp, S/tp, D]`` of the JAX package's
``P(dp, tp, None)`` layout, flattened batch-major, and the experts are
split over ``tp`` (the rank holds ``E / tp``). Each (token, slot) pair
goes to the rank of its expert in one static-capacity all-to-all over
``tp``: a one-hot cumsum (``_pack``) gives each pair its position in its
destination's buffer of ``cap_s`` slots, in pair order; the receiving
rank packs the slots by local expert, in (source rank, slot) order, into
``cap_e`` slots each. Pairs past either capacity are dropped, GShard
style: their gates were normalised before the drop and their output is
zero. The expert outputs come back in a second all-to-all and are
combined at the owner, in the activations' dtype. ZeRO-3: where the fsdp
extent divides ``D``, the rank's expert blocks are all-gathered along
``D`` over ``fsdp`` inside the call.

``moe_ep_decode`` (a decode step): ``x`` ``[B, 1, D]`` is replicated
over ``tp`` (the batch over ``dp`` where it divides); every rank runs
only the pairs whose expert is its own, at a capacity that drops none,
and the outputs are SUM-reduced over ``tp``. The port's SUM of bfloat16
widens to float32 and rounds once (``distributed.Grid.all_reduce``)
where XLA's ``psum`` adds in bfloat16, so a bfloat16 decode over more
than two ``tp`` ranks may differ from the JAX package's by a rounding.

``check_ep`` raises ``ValueError`` where the JAX package's ``shard_map``
refuses these paths: experts that do not split over ``tp`` and, outside
decode, a batch that does not split over ``dp`` or a sequence that does
not split over ``tp``. ``STATS`` (``EPStats``) counts a rank's pairs,
drops, all-to-alls and expert-FFN time; ``STATS.reset(record=True)``
also keeps each dispatch's routing, from which a host recount of the
drops is made.

On a mesh under ``ShardCtx(moe_impl="reference")`` each rank runs
``moe_partial`` instead, its own experts over every token, and the
float32 partial outputs are SUM-reduced over ``tp``.

Numerics as in the JAX package: the router's logits and softmax are
float32; the top-k gates are renormalised with ``max(sum, 1e-9)``; the
expert FFN runs in the weights' dtype (bfloat16 in, bfloat16 out);
``moe_reference`` combines in float32, the expert-parallel paths in the
activations' dtype, each cast back to the input's dtype at the end.
``lax.top_k`` breaks ties toward the lower index, which ``torch.topk``
does not promise; with random weights no two probabilities tie.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import torch
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    cap_factor: float = 2.0


def _router(tokens: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """tokens [N, D] -> (gates float32 [N, k], renormalised; eids int32
    [N, k]), the k largest probabilities in descending order."""
    logits = tokens.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eids.to(torch.int32)


def _expert_ffn(buf: torch.Tensor, wi_g: torch.Tensor, wi_u: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D]: SwiGLU with each expert's weights."""
    g = torch.bmm(buf, wi_g)
    u = torch.bmm(buf, wi_u)
    return torch.bmm(F.silu(g) * u, wo)


def moe_reference(x: torch.Tensor, w_router: torch.Tensor,
                  wi_g: torch.Tensor, wi_u: torch.Tensor, wo: torch.Tensor,
                  dims: MoEDims) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: every expert over every token, each
    token's output the gate-weighted sum of its top-k experts' outputs."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    gates, eids = _router(tokens, w_router, dims.top_k)
    mask = F.one_hot(eids.long(), dims.n_experts).to(gates.dtype)  # [N,k,E]
    comb = (gates[..., None] * mask).sum(dim=1)                     # [N, E]
    outs = _expert_ffn(tokens.expand(dims.n_experts, -1, -1),
                       wi_g, wi_u, wo)                               # [E,N,D]
    y = torch.einsum("ne,end->nd", comb, outs.to(gates.dtype))
    return y.reshape(B, S, D).to(x.dtype)


def moe_partial(x: torch.Tensor, w_router: torch.Tensor, wi_g: torch.Tensor,
                wi_u: torch.Tensor, wo: torch.Tensor, dims: MoEDims,
                e0: int) -> torch.Tensor:
    """``moe_reference``'s float32 sum restricted to the experts
    ``[e0, e0 + wi_g.shape[0])`` (one rank's block): x [B, S, D] ->
    float32 [B, S, D], before the cast. The partials of all blocks sum to
    ``moe_reference``'s output in float32."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    gates, eids = _router(tokens, w_router, dims.top_k)
    mask = F.one_hot(eids.long(), dims.n_experts).to(gates.dtype)
    comb = (gates[..., None] * mask).sum(dim=1)[:, e0:e0 + wi_g.shape[0]]
    outs = _expert_ffn(tokens.expand(wi_g.shape[0], -1, -1), wi_g, wi_u, wo)
    y = torch.einsum("ne,end->nd", comb, outs.to(gates.dtype))
    return y.reshape(B, S, D)


def _pack(keys: torch.Tensor, n_groups: int, cap: int) -> torch.Tensor:
    """Each item's position in its group, in item order (a one-hot
    cumsum): int32 [N]; a key of -1 and a position past ``cap`` give
    ``cap`` (dropped). A key at or past ``n_groups`` has an empty one-hot
    row and position 0, as ``jax.nn.one_hot`` makes it."""
    oh = (keys[:, None] == torch.arange(n_groups, device=keys.device)
          ).to(torch.int32)                                  # [N, G]
    pos = ((torch.cumsum(oh, 0, dtype=torch.int32) - 1) * oh).amax(1)
    return torch.where((keys < 0) | (pos >= cap), cap, pos).to(torch.int32)


# ----------------------------------------------------------------- EP stats


@dataclasses.dataclass
class EPStats:
    """The expert-parallel MoE's counts on this rank since ``reset``:
    calls, the (token, slot) pairs it routed, the pairs dropped here at
    the source (past ``cap_s``) and the received slots dropped here at
    the experts (past ``cap_e``), its all-to-alls' calls, bytes and
    seconds (``distributed.CommStats``'s, host copies included), and the
    expert FFN's seconds (CUDA events on the card). The drop counts stay
    a running sum on the device and the events are folded in once they
    have completed, so a call waits for nothing and the counts take no
    more room as calls go by. With ``routes`` a list, each
    ``moe_ep_train`` call appends its routing: ``{"eids": int32
    [n_loc, k], "cap_s", "cap_e", "e_loc", "coords"}`` (``coords``: the
    rank's grid coordinates)."""
    calls: int = 0
    pairs: int = 0
    a2a_calls: int = 0
    a2a_bytes: int = 0
    a2a_seconds: float = 0.0
    ffn_seconds: float = 0.0
    routes: Optional[list] = None
    _drops: Optional[torch.Tensor] = None      # [source, experts]
    _events: list = dataclasses.field(default_factory=list)

    def reset(self, record: bool = False) -> None:
        self.calls = self.pairs = self.a2a_calls = self.a2a_bytes = 0
        self.a2a_seconds = self.ffn_seconds = 0.0
        self.routes = [] if record else None
        self._drops, self._events = None, []

    def _dropped(self, at_source: torch.Tensor,
                 at_experts: torch.Tensor) -> None:
        d = torch.stack([at_source.sum(), at_experts.sum()])
        self._drops = d if self._drops is None else self._drops + d

    def _fold(self) -> None:
        """Add the FFN times whose events have completed."""
        pending = []
        for t0, t1 in self._events:
            if t1.query():
                self.ffn_seconds += t0.elapsed_time(t1) / 1e3
            else:
                pending.append((t0, t1))
        self._events = pending

    def snapshot(self) -> dict:
        """The counts as numbers (reading the device's drop counts and
        FFN times waits for the card)."""
        for _, t1 in self._events:
            t1.synchronize()
        self._fold()
        send, expert = (0, 0) if self._drops is None else \
            (int(v) for v in self._drops.tolist())
        return {"calls": self.calls, "pairs": self.pairs,
                "dropped_send": send, "dropped_expert": expert,
                "dropped": send + expert, "a2a_calls": self.a2a_calls,
                "a2a_bytes": self.a2a_bytes, "a2a_seconds": self.a2a_seconds,
                "ffn_seconds": self.ffn_seconds}


STATS = EPStats()


def _timed_ffn(buf, wi_g, wi_u, wo) -> torch.Tensor:
    """``_expert_ffn`` with its time kept in ``STATS`` (CUDA events on the
    card, read once completed; the host clock on the CPU)."""
    if buf.device.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = _expert_ffn(buf, wi_g, wi_u, wo)
        t1.record()
        STATS._fold()
        STATS._events.append((t0, t1))
        return out
    t0 = time.perf_counter()
    out = _expert_ffn(buf, wi_g, wi_u, wo)
    STATS.ffn_seconds += time.perf_counter() - t0
    return out


def _all_to_all(t: torch.Tensor, grid, tp: str) -> torch.Tensor:
    before = grid.stats.snapshot()
    out = grid.all_to_all(t, (tp,))
    after = grid.stats.snapshot()
    STATS.a2a_calls += after["calls"] - before["calls"]
    STATS.a2a_bytes += after["bytes"] - before["bytes"]
    STATS.a2a_seconds += after["seconds"] - before["seconds"]
    return out


# ------------------------------------------------------------------ EP checks


def check_ep(dims: MoEDims, grid, batch: int, seq: int, *,
             dp: Sequence[str], tp: str, decode: bool) -> None:
    """Raise ``ValueError`` where the JAX package's ``shard_map`` refuses
    the expert-parallel MoE on ``grid``: ``n_experts`` not divisible by the
    ``tp`` extent and, outside decode, ``batch`` not divisible by the
    ``dp`` extent or ``seq`` by the ``tp`` extent (decode replicates a
    batch that does not split)."""
    tp_size, _ = _experts_local(dims, grid, tp)
    if decode:
        return
    n_dp = math.prod(grid.axis_size(a) for a in dp)
    if batch % n_dp:
        raise ValueError(f"the expert-parallel MoE splits the batch of "
                         f"{batch} over dp {tuple(dp)} ({n_dp}): it does not "
                         "divide")
    if seq % tp_size:
        raise ValueError(f"the expert-parallel MoE splits the sequence of "
                         f"{seq} over tp {tp!r} ({tp_size}): it does not "
                         "divide")


def _zero3(ws, dims: MoEDims, grid, fsdp: Sequence[str], e_loc: int) -> list:
    """The rank's expert blocks (wi_g, wi_u [e_loc, D', F], wo
    [e_loc, F, D']) whole along ``D``: all-gathered over the ``fsdp`` axes
    of extent above 1 where their extent divides ``D`` (the JAX package's
    ``reversed(fsdp_axes)`` gathers give the same flat block order)."""
    axes = tuple(a for a in fsdp if grid.axis_size(a) > 1)
    n = math.prod(grid.axis_size(a) for a in axes)
    D = dims.d_model
    d_loc = D // n if axes and D % n == 0 else D
    d_dims = (1, 1, 2)
    for w, d in zip(ws, d_dims):
        if w.shape[0] != e_loc or w.shape[d] != d_loc:
            raise ValueError(f"an expert block of shape {tuple(w.shape)}: "
                             f"want {e_loc} experts and {d_loc} of D = {D} "
                             f"along dimension {d}")
    if d_loc == D:
        return list(ws)
    return [grid.all_gather_dim(w, d, axes) for w, d in zip(ws, d_dims)]


def _experts_local(dims: MoEDims, grid, tp: str) -> tuple:
    """(the tp extent, the experts a rank holds)."""
    tp_size = grid.axis_size(tp)
    if dims.n_experts % tp_size:
        raise ValueError(f"the expert-parallel MoE splits {dims.n_experts} "
                         f"experts over tp {tp!r} ({tp_size}): it does not "
                         "divide")
    return tp_size, dims.n_experts // tp_size


# ----------------------------------------------------------------- EP (train)


def moe_ep_train(x: torch.Tensor, w_router: torch.Tensor, wi_g: torch.Tensor,
                 wi_u: torch.Tensor, wo: torch.Tensor, dims: MoEDims, grid, *,
                 dp: Sequence[str], tp: str,
                 fsdp: Sequence[str]) -> torch.Tensor:
    """The rank's block x [B/dp, S/tp, D] -> its block of the MoE's output
    (the module docstring). ``w_router`` [D, E] is whole; ``wi_g``,
    ``wi_u`` [E/tp, D', F] and ``wo`` [E/tp, F, D'] are the rank's experts
    (those of its ``tp`` index), ``D' = D / fsdp`` where the fsdp extent
    divides ``D``, else ``D``. Every rank of the grid calls it (the
    all-to-alls run over ``tp``; ``dp`` is the batch's axes, whose split
    the caller made)."""
    k = dims.top_k
    tp_size, e_loc = _experts_local(dims, grid, tp)
    Bl, Sl, D = x.shape
    n_loc = Bl * Sl
    # the JAX package's expressions, in its order, so the integers agree
    cap_s = max(1, int(n_loc * k / tp_size * dims.cap_factor))
    cap_e = max(1, int(tp_size * cap_s / e_loc * dims.cap_factor))
    wi_g, wi_u, wo = _zero3((wi_g, wi_u, wo), dims, grid, fsdp, e_loc)
    tokens = x.reshape(n_loc, D)
    gates, eids = _router(tokens, w_router, k)
    dest = (eids // e_loc).reshape(-1)                   # [n_loc * k]
    pos_s = _pack(dest, tp_size, cap_s)
    dropped_s = pos_s >= cap_s
    n_send = tp_size * cap_s                             # + 1: a drop row
    slot = torch.where(dropped_s, n_send, dest * cap_s + pos_s).long()
    send_x = tokens.new_zeros((n_send + 1, D))
    send_x[slot] = tokens.repeat_interleave(k, 0)
    send_e = torch.full((n_send + 1,), -1, dtype=torch.int32,
                        device=x.device)
    send_e[slot] = (eids % e_loc).reshape(-1)
    # dispatch
    recv_x = _all_to_all(send_x[:-1].reshape(tp_size, cap_s, D), grid, tp)
    recv_e = _all_to_all(send_e[:-1].reshape(tp_size, cap_s), grid, tp)
    # group by local expert, in (source rank, slot) order
    re = recv_e.reshape(-1)
    pos_e = _pack(re, e_loc, cap_e)
    dropped_e = (re >= 0) & (pos_e >= cap_e)
    n_buf = e_loc * cap_e
    eslot = torch.where((re < 0) | (pos_e >= cap_e), n_buf,
                        re * cap_e + pos_e).long()
    buf = recv_x.new_zeros((n_buf + 1, D))
    buf[eslot] = recv_x.reshape(-1, D)
    out = _timed_ffn(buf[:-1].reshape(e_loc, cap_e, D).to(wi_g.dtype),
                     wi_g, wi_u, wo)
    # each received slot's output (zeros where dropped or empty), returned
    back = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])[eslot]
    ret = _all_to_all(back.reshape(tp_size, cap_s, D), grid, tp)
    # combine at the owner, in the activations' dtype
    pair_out = torch.cat([ret.reshape(-1, D), ret.new_zeros((1, D))])[slot]
    y = (pair_out.reshape(n_loc, k, D)
         * gates[..., None].to(pair_out.dtype)).sum(1)
    STATS.calls += 1
    STATS.pairs += n_loc * k
    STATS._dropped(dropped_s, dropped_e)
    if STATS.routes is not None:
        STATS.routes.append({"eids": eids.cpu().numpy(), "cap_s": cap_s,
                             "cap_e": cap_e, "e_loc": e_loc,
                             "coords": dict(grid.coords)})
    return y.reshape(Bl, Sl, D).to(x.dtype)


# ---------------------------------------------------------------- EP (decode)


def moe_ep_decode(x: torch.Tensor, w_router: torch.Tensor,
                  wi_g: torch.Tensor, wi_u: torch.Tensor, wo: torch.Tensor,
                  dims: MoEDims, grid, *, dp: Sequence[str], tp: str,
                  fsdp: Sequence[str]) -> torch.Tensor:
    """x [b, 1, D], replicated over ``tp`` (the rank's batch block over
    ``dp`` where the batch divides, else the whole batch) -> the MoE's
    output for it, on every rank of its ``tp`` group. The weights as for
    ``moe_ep_train``. Each rank runs the pairs routed to its own experts
    (capacity ``n_loc * k``: nothing drops), combines them in the
    activations' dtype and SUM-reduces over ``tp`` (bfloat16 widened to
    float32 and rounded once)."""
    k = dims.top_k
    tp_size, e_loc = _experts_local(dims, grid, tp)
    wi_g, wi_u, wo = _zero3((wi_g, wi_u, wo), dims, grid, fsdp, e_loc)
    Bl, Sl, D = x.shape
    n_loc = Bl * Sl
    cap_e = max(1, n_loc * k)
    tokens = x.reshape(n_loc, D)
    gates, eids = _router(tokens, w_router, k)
    mine = (eids // e_loc) == grid.coord(tp)
    e_local = torch.where(mine, eids % e_loc, -1).reshape(-1)
    pos_e = _pack(e_local, e_loc, cap_e)
    n_buf = e_loc * cap_e
    eslot = torch.where(e_local < 0, n_buf, e_local * cap_e + pos_e).long()
    buf = tokens.new_zeros((n_buf + 1, D))
    buf[eslot] = tokens.repeat_interleave(k, 0)
    out = _timed_ffn(buf[:-1].reshape(e_loc, cap_e, D).to(wi_g.dtype),
                     wi_g, wi_u, wo)
    back = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])[eslot]
    y = (back.reshape(n_loc, k, D) * gates[..., None].to(back.dtype)).sum(1)
    y = grid.all_reduce(y, "sum", (tp,))
    STATS.calls += 1
    STATS.pairs += n_loc * k
    return y.reshape(Bl, Sl, D).to(x.dtype)
