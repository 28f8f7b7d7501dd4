"""The port's language models against the JAX package's, on the CPU: the
parts (``rmsnorm``, RoPE in both styles, ``flash_attention`` with causal,
window, padding and GQA, ``decode_attention``, the MoE router and
``moe_reference``), and whole models (``forward``, ``prefill``,
``decode_step``, ``loss_fn``) at the five ``reduced_config()``s, the JAX
package's weights carried across by ``convert.lm_params_from_arrays``.

Each configuration runs through one jitted call of the JAX package: the
forward, the prefill, three decode steps teacher-forced with its own
greedy tokens (a near-tie in the port's logits cannot cascade), at
positions that differ across the batch, and the loss. Bounds, set before
the comparisons:

* float32: every logit within ``F32_TOL`` = 1e-5 of the largest |logit|
  (float32 sums in another order; ~3e-7 seen), the prefill's cache within
  1e-5 absolute (post-RoPE keys of magnitude ~1), the loss within rtol
  1e-5; the parts within 1e-5 of their largest magnitude;
* bfloat16 (the same configurations with ``dtype=bfloat16``): within
  ``BF16_TOL`` = 1/64 of the largest |logit|, two to four bfloat16 ulps of
  it: each package's bfloat16 matmuls round their outputs after sums in
  their own order, so a logit may land an ulp or two apart. In the MoE
  configurations a token whose router margin (its k-th minus its
  (k+1)-th router logit, in any layer, as the port computes it) is under
  ``ROUTE_MARGIN`` = 2e-3 may be routed to another expert by the other
  package: its hidden state differs by a few bfloat16 ulps (2^-8
  relative), which over d_model = 64 terms of |w| ~ 0.02 moves a router
  logit by ~6e-4. Such rows are held only to being finite, and at most
  ``MAX_NEAR_TIES`` = 15% of the rows of a comparison (or one row, where
  that is fewer) may be such; every other row is held to ``BF16_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import (internlm2_1_8b as j_internlm, kimi_k2 as j_kimi,
                           llama4_scout as j_llama4, phi3_mini as j_phi3,
                           smollm_135m as j_smollm)
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import convert, pytree
from repro_torch.configs import cells as pcells
from repro_torch.configs import (internlm2_1_8b as p_internlm,
                                 kimi_k2 as p_kimi, llama4_scout as p_llama4,
                                 phi3_mini as p_phi3, smollm_135m as p_smollm)
from repro_torch.launch import serve
from repro_torch.models import layers as players
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptf

F32_TOL = 1e-5
CACHE_TOL = 1e-5
LOSS_RTOL = 1e-5
PART_TOL = 1e-5
BF16_TOL = 1.0 / 64
ROUTE_MARGIN = 2e-3
MAX_NEAR_TIES = 0.15

ARCHS = {"smollm-135m": (j_smollm, p_smollm),
         "phi3-mini-3.8b": (j_phi3, p_phi3),
         "internlm2-1.8b": (j_internlm, p_internlm),
         "llama4-scout-17b-a16e": (j_llama4, p_llama4),
         "kimi-k2-1t-a32b": (j_kimi, p_kimi)}
B, S, GEN = 2, 40, 3      # S > q_chunk = 32: two chunks, the second padded


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _configs(arch: str, dtype: str):
    jm, pm = ARCHS[arch]
    jcfg, pcfg = jm.reduced_config(), pm.reduced_config()
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    return jcfg, pcfg


def _jax_run(jcfg, params, toks, labels):
    """The JAX package's forward, prefill, GEN teacher-forced decode steps
    and loss, in one jitted call."""

    @jax.jit
    def run(params, toks, labels):
        logits = jtf.forward(params, toks, jcfg)
        last, cache = jtf.prefill(params, toks, jcfg)
        padded = {k: jnp.pad(v, ((0, 0), (0, 0), (0, GEN + 1), (0, 0),
                                 (0, 0))) for k, v in cache.items()}
        tok = jnp.argmax(last, -1).astype(jnp.int32)
        outs, fed = [], []
        for i in range(GEN):
            pos = S + i + jnp.arange(B, dtype=jnp.int32)  # differ per request
            lg, padded = jtf.decode_step(params, padded, tok, pos, jcfg)
            outs.append(lg)
            fed.append(tok)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
        loss = jtf.loss_fn(params, {"tokens": toks, "labels": labels}, jcfg)
        return (logits, last, cache, jnp.stack(outs, 1), jnp.stack(fed, 1),
                loss)

    return jax.tree.map(np.asarray, run(params, toks, labels))


class _Margins:
    """Records, for every call of the port's router, each token's margin
    between its k-th and (k+1)-th router logit."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = pmoe._router

        def rec(tokens, w, k):
            lg = torch.sort(tokens.float() @ w.float(), dim=-1,
                            descending=True).values
            self.calls.append(lg[:, k - 1] - lg[:, k])
            return orig(tokens, w, k)

        monkeypatch.setattr(pmoe, "_router", rec)

    def take(self) -> np.ndarray:
        """The least margin of each token over the calls since the last
        take (one call a layer); None without an MoE layer."""
        calls, self.calls = self.calls, []
        if not calls:
            return None
        return torch.stack(calls).min(0).values.numpy()


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    jcfg, pcfg = _configs(arch, dtype)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    want = _jax_run(jcfg, params, toks, labels)
    arrays = jax.tree.map(np.asarray, params)
    mp = pytest.MonkeyPatch()
    margins = _Margins(mp)
    tp = convert.lm_params_from_arrays(arrays, pcfg, device="cpu")
    tt = torch.tensor(toks)
    got = {}
    with torch.no_grad():
        got["logits"] = ptf.forward(tp, tt, pcfg, device="cpu")
        got["fwd_margin"] = margins.take()
        got["last"], cache = ptf.prefill(tp, tt, pcfg, device="cpu")
        got["cache"] = {k: v.clone() for k, v in cache.items()}
        got["pre_margin"] = margins.take()
        padded = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, GEN + 1))
                  for k, v in cache.items()}
        dec, dec_margin = [], []
        for i in range(GEN):
            pos = S + i + torch.arange(B, dtype=torch.int32)
            lg, padded = ptf.decode_step(tp, padded, torch.tensor(want[4][:, i]),
                                         pos, pcfg, device="cpu")
            dec.append(lg)
            dec_margin.append(margins.take())
        got["decode"] = torch.stack(dec, 1)
        got["dec_margin"] = (None if dec_margin[0] is None
                             else np.stack(dec_margin, 1))
        got["loss"] = ptf.loss_fn(tp, {"tokens": tt,
                                       "labels": torch.tensor(labels)},
                                  pcfg, device="cpu")
    mp.undo()
    return dict(arch=arch, dtype=dtype, jcfg=jcfg, pcfg=pcfg, want=want,
                got=got, arrays=arrays, toks=toks, labels=labels)


def _hold(got, want, margin, dtype, what):
    """Rows of logits [..., V] against the JAX package's (the module's
    docstring): float32 all within F32_TOL; bfloat16 within BF16_TOL but
    for near-tie rows of an MoE model, which must be finite."""
    got, want = _np(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    err = np.abs(got - want).max(-1) / scale
    if dtype == "f32":
        assert err.max() <= F32_TOL, (what, err.max())
        return
    keep = np.ones(err.shape, bool) if margin is None else \
        (margin.reshape(err.shape) >= ROUTE_MARGIN)
    near = int((~keep).sum())
    assert near <= max(1, int(MAX_NEAR_TIES * keep.size)), (what, near)
    assert err[keep].max() <= BF16_TOL, (what, err[keep].max())


def test_forward_matches_jax(case):
    g = case["got"]
    _hold(g["logits"], case["want"][0], g["fwd_margin"], case["dtype"],
          "forward")


def test_prefill_matches_jax(case):
    g, w = case["got"], case["want"]
    margin = g["pre_margin"]
    last_margin = None if margin is None else margin.reshape(B, S)[:, -1]
    _hold(g["last"], w[1], last_margin, case["dtype"], "prefill logits")
    for name in ("k", "v"):
        got, want = _np(g["cache"][name]), _f32(w[2][name])
        assert got.shape == want.shape == (case["pcfg"].n_layers, B, S,
                                           case["pcfg"].n_kv,
                                           case["pcfg"].d_head)
        err = np.abs(got - want).max(axis=(0, 3, 4))          # [B, S]
        if case["dtype"] == "f32":
            assert err.max() <= CACHE_TOL, (name, err.max())
        else:
            keep = np.ones(err.shape, bool) if margin is None else \
                margin.reshape(B, S) >= ROUTE_MARGIN
            # a bfloat16 value of magnitude < 8 is within 4 ulps at 1/16
            assert err[keep].max() <= BF16_TOL * 4 * np.abs(want).max(), name


def test_decode_matches_jax(case):
    g = case["got"]
    _hold(g["decode"], case["want"][3], g["dec_margin"], case["dtype"],
          "decode")


def test_loss_matches_jax(case):
    got, want = float(case["got"]["loss"]), float(case["want"][5])
    assert np.isfinite(got)
    if case["dtype"] == "f32":
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    else:
        # the loss is float32 over bfloat16 logits that agree within
        # BF16_TOL of their largest; ln V ~ 5.5, logits ~ 1
        np.testing.assert_allclose(got, want, rtol=BF16_TOL)


# ------------------------------------------------------------------- parts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _f32(jlayers.rmsnorm(jnp.asarray(x, jd), jnp.asarray(scale, jd)))
    got = players.rmsnorm(torch.tensor(x).to(td), torch.tensor(scale).to(td))
    assert got.dtype == td
    tol = PART_TOL if dtype == "float32" else 2 ** -7   # an ulp at [1, 2)
    assert _rel(_np(got), want) <= tol


@pytest.mark.parametrize("style", ["half", "interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(style, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # prefill positions [S], then decode positions [B, 1], one per request
    for pos in (np.arange(9), np.array([[5], [1000]])):
        xs = x if pos.ndim == 1 else x[:, :1]
        jc, js = jlayers.rope_freqs(jnp.asarray(pos), 16, 1e4)
        pc, ps = players.rope_freqs(torch.tensor(pos), 16, 1e4)
        assert _rel(_np(pc), _f32(jc)) <= PART_TOL
        assert _rel(_np(ps), _f32(js)) <= PART_TOL
        want = _f32(jlayers.apply_rope(jnp.asarray(xs, jd), jc, js,
                                       style=style))
        got = players.apply_rope(torch.tensor(xs).to(td), pc, ps, style=style)
        assert got.dtype == td and got.shape == xs.shape
        tol = PART_TOL if dtype == "float32" else 2 ** -7
        assert _rel(_np(got), want) <= tol


def test_apply_rope_styles_pair_differently():
    x = torch.arange(8.0).reshape(1, 1, 1, 8)
    c, s = players.rope_freqs(torch.tensor([1]), 8)
    half = players.apply_rope(x, c, s, style="half")
    inter = players.apply_rope(x, c, s, style="interleaved")
    assert not torch.equal(half, inter)
    with pytest.raises(ValueError, match="style"):
        players.apply_rope(x, c, s, style="neox")


FLASH_CASES = [
    # (Sq, H, KV, causal, window, q_chunk, kv_chunk)
    (64, 4, 4, True, None, 32, 32),       # two chunks each way
    (50, 4, 2, True, None, 32, 16),       # padding, GQA
    (70, 6, 2, True, 24, 32, 32),         # window across chunks, GQA
    (45, 4, 1, False, None, 16, 32),      # non-causal, padding, MQA
    (40, 2, 2, True, 8, 64, 64),          # one chunk, small window
]


@pytest.mark.parametrize("Sq,H,KV,causal,window,qc,kc", FLASH_CASES)
def test_flash_attention_matches_jax(Sq, H, KV, causal, window, qc, kc):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, KV, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, KV, 16)).astype(np.float32)
    want = _f32(jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc))
    got = players.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=causal,
                                  window=window, q_chunk=qc, kv_chunk=kc)
    assert got.shape == q.shape
    assert _rel(_np(got), want) <= PART_TOL


def test_flash_attention_matches_direct_softmax():
    """Against a direct float32 softmax over the whole masked score
    matrix, query head h reading key head h // G."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((1, 70, 6, 8)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 70, 2, 8)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((1, 70, 2, 8)), dtype=torch.float32)
    for window in (None, 24):
        got = players.flash_attention(q, k, v, window=window, q_chunk=32,
                                      kv_chunk=16)
        kk = k.repeat_interleave(3, dim=2)
        vv = v.repeat_interleave(3, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 8 ** -0.5
        i = torch.arange(70)
        mask = i[:, None] >= i[None, :]
        if window is not None:
            mask &= (i[:, None] // window) == (i[None, :] // window)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        want = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        assert _rel(_np(got), _np(want)) <= PART_TOL


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(window, dtype):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _f32(jlayers.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
        jnp.asarray(pos), window=window))
    got = players.decode_attention(
        torch.tensor(q).to(td), torch.tensor(kc).to(td),
        torch.tensor(vc).to(td), torch.tensor(pos), window=window)
    assert got.dtype == td
    tol = PART_TOL if dtype == "float32" else 2 ** -6
    assert _rel(_np(got), want) <= tol


@pytest.mark.parametrize("E,k", [(8, 2), (4, 1), (16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_and_moe_reference_match_jax(E, k, dtype):
    rng = np.random.default_rng(E + k)
    D, Fe = 32, 48
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    wr = (rng.standard_normal((D, E)) * 0.3).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((E, D, Fe), (E, D, Fe), (E, Fe, D))]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x, jd)
    tx = torch.tensor(x).to(td)
    jg, je = jmoe._router(jx.reshape(-1, D), jnp.asarray(wr), k)
    pg, pe = pmoe._router(tx.reshape(-1, D), torch.tensor(wr), k)
    assert pe.dtype == torch.int32 and pg.dtype == torch.float32
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    assert _rel(_np(pg), _f32(jg)) <= PART_TOL
    want = _f32(jmoe.moe_reference(jx, jnp.asarray(wr),
                                   *[jnp.asarray(a, jd) for a in w],
                                   jmoe.MoEDims(E, k, D, Fe)))
    got = pmoe.moe_reference(tx, torch.tensor(wr),
                             *[torch.tensor(a).to(td) for a in w],
                             pmoe.MoEDims(E, k, D, Fe))
    assert got.dtype == td and got.shape == x.shape
    tol = PART_TOL if dtype == "float32" else 2 ** -6
    assert _rel(_np(got), want) <= tol


def test_moe_reference_equals_a_per_token_loop():
    """Each token's output is the gate-weighted sum of its top-k experts'
    SwiGLU outputs, computed one token and one expert at a time."""
    rng = np.random.default_rng(11)
    E, k, D, Fe = 6, 3, 16, 24
    x = torch.tensor(rng.standard_normal((1, 9, D)), dtype=torch.float32)
    wr = torch.tensor(rng.standard_normal((D, E)), dtype=torch.float32)
    wg, wu, wo = (torch.tensor(rng.standard_normal(s) * 0.2,
                               dtype=torch.float32)
                  for s in ((E, D, Fe), (E, D, Fe), (E, Fe, D)))
    got = pmoe.moe_reference(x, wr, wg, wu, wo, pmoe.MoEDims(E, k, D, Fe))
    for n in range(9):
        probs = torch.softmax(x[0, n] @ wr, -1)
        top = torch.argsort(probs, descending=True)[:k]
        gates = probs[top] / probs[top].sum()
        want = sum(g * ((torch.nn.functional.silu(x[0, n] @ wg[e])
                         * (x[0, n] @ wu[e])) @ wo[e])
                   for g, e in zip(gates, top))
        assert _rel(_np(got[0, n]), _np(want)) <= PART_TOL


# ------------------------------------------------------------------ misc


def test_all_masked_labels_and_labels_past_the_vocabulary():
    """A batch whose labels are all -1 has loss 0 (the masked mean's
    denominator is at least 1); a label at the vocabulary raises. Masked
    labels among others are held to the JAX package's loss in
    ``test_loss_matches_jax`` (its first request's first five)."""
    _, pcfg = _configs("smollm-135m", "f32")
    tp = ptf.init_params(pcfg, device="cpu")
    toks = torch.tensor(_token_batch(pcfg.vocab, 2, 12)["tokens"])
    none = torch.full((2, 12), -1, dtype=torch.int32)
    assert float(ptf.loss_fn(tp, {"tokens": toks, "labels": none}, pcfg,
                             device="cpu")) == 0.0
    bad = torch.zeros((2, 12), dtype=torch.int32)
    bad[1, 1] = pcfg.vocab
    with pytest.raises(ValueError, match="vocabulary"):
        ptf.loss_fn(tp, {"tokens": toks, "labels": bad}, pcfg, device="cpu")


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "kimi-k2-1t-a32b"])
def test_remat_gives_equal_gradients(arch):
    _, pcfg = _configs(arch, "f32")
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(pcfg, remat=remat)
        params = ptf.init_params(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
        leaves = pytree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.tensor(v) for k, v in
                 _token_batch(cfg.vocab, 2, 40).items()}
        loss = ptf.loss_fn(params, batch, cfg, device="cpu")
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _token_batch(vocab, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_and_flops_match_jax(arch):
    jm, pm = ARCHS[arch]
    jcfg, pcfg = jm.make_config(), pm.make_config()
    assert pcfg.params_e9 == jcfg.params_e9
    assert pcfg.active_params_e9 == jcfg.active_params_e9
    for shape, sh in jcells.LM_SHAPES.items():
        assert pcells.LM_SHAPES[shape] == sh
        assert pcells.lm_model_flops(pcfg, sh["batch"], sh["seq"],
                                     sh["kind"]) == \
            jcells.lm_model_flops(jcfg, sh["batch"], sh["seq"], sh["kind"])
    # the published widths, copied verbatim
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pm.SHAPES == jm.SHAPES and pm.OPTIMIZER == jm.OPTIMIZER
    assert pm.ARCH_ID == jm.ARCH_ID and pm.FAMILY == jm.FAMILY == "lm"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_tree_matches_jax_init(arch):
    """The port's tree (names, shapes, dtypes) is the JAX package's, at the
    full published widths, without allocating them."""
    jm, pm = ARCHS[arch]
    for jcfg, pcfg in ((jm.make_config(), pm.make_config()),
                       (jm.reduced_config(), pm.reduced_config())):
        want = jax.eval_shape(lambda kk: jtf.init_params(jcfg, kk),
                              jax.random.PRNGKey(0))
        wpairs = jax.tree_util.tree_flatten_with_path(want)[0]
        got = pytree.flatten_with_paths(ptf.param_shapes(pcfg))[0]
        assert [jax.tree_util.keystr(p) for p, _ in wpairs] == \
            [p for p, _ in got]
        for (_, w), (_, g) in zip(wpairs, got):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_init_params_draws_and_places():
    _, pcfg = _configs("llama4-scout-17b-a16e", "bf16")
    a = ptf.init_params(pcfg, torch.Generator().manual_seed(5), device="cpu")
    b = ptf.init_params(pcfg, torch.Generator().manual_seed(5), device="cpu")
    for (path, x), y in zip(pytree.flatten_with_paths(a)[0],
                            pytree.leaves(b)):
        assert torch.equal(x, y), path
    lp = a["layers"]
    assert torch.equal(lp["ln1"], torch.ones_like(lp["ln1"]))
    assert lp["router"].dtype == torch.float32
    # the router holds bfloat16-rounded draws
    assert torch.equal(lp["router"], lp["router"].to(torch.bfloat16).float())
    std = lp["e_wi_g"].float().std().item()
    assert 0.018 < std < 0.022


def test_init_draws_large_leaves_slice_by_slice(monkeypatch):
    monkeypatch.setattr(ptf, "_DRAW_ELEMS", 100)
    sizes = []
    orig = torch.randn

    def spy(*a, **k):
        out = orig(*a, **k)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    _, pcfg = _configs("kimi-k2-1t-a32b", "f32")
    ptf.init_params(pcfg, device="cpu")
    assert max(sizes) <= max(100, pcfg.vocab)


def test_ctx_other_than_none_raises(tmp_path):
    """A ctx that is not a ``ShardCtx`` is refused, and so is one that
    cannot run: a mesh shape without ranks, and grad mode (naming its
    slice, 2.3). The expert-parallel MoE, ``ShardCtx``'s default, runs on
    a one-rank world and gives one device's logits (the sharded paths
    themselves: tests/test_torch_lm_mesh.py, tests/test_torch_moe_ep.py)."""
    import torch.distributed as dist
    from repro_torch.distributed import Grid
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import AxisRules
    _, pcfg = _configs("smollm-135m", "f32")
    params = ptf.init_params(pcfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(TypeError, match="ShardCtx"):
            ptf.forward(params, toks, pcfg, object(), device="cpu")
        cache = ptf.init_cache(pcfg, 1, 8, device="cpu")
        with pytest.raises(TypeError, match="ShardCtx"):
            ptf.decode_step(params, cache, toks[:, 0], torch.zeros(1), pcfg,
                            object(), device="cpu")
        mesh = make_host_mesh((1, 1), ("data", "model"))
        shape_only = ptf.ShardCtx(mesh, AxisRules.for_mesh(mesh),
                                  moe_impl="reference")
        with pytest.raises(TypeError, match="distributed.Grid"):
            ptf.forward(params, toks, pcfg, shape_only, device="cpu")
        _, moe_cfg = _configs("llama4-scout-17b-a16e", "f32")
        moe_params = ptf.init_params(moe_cfg, device="cpu")
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
            world_size=1)
        try:
            grid = Grid((1, 1), ("data", "model"), torch.device("cpu"))
            ep = ptf.ShardCtx(grid, AxisRules())
            assert ep.moe_impl == "ep"
            got = ptf.forward(moe_params, toks, moe_cfg, ep)
        finally:
            dist.destroy_process_group()
        want = ptf.forward(moe_params, toks, moe_cfg, device="cpu")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="training on a mesh"):
        ptf.forward(params, toks, pcfg, shape_only, device="cpu")
    with pytest.raises(NotImplementedError, match="2.3"):
        ptf.forward(params, toks, pcfg, shape_only, device="cpu")


def test_inputs_on_another_device_are_refused():
    _, pcfg = _configs("smollm-135m", "f32")
    params = ptf.init_params(pcfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="tokens"):
        ptf.forward(params, toks, pcfg, device="cpu")


def test_module_forward_equals_forward():
    _, pcfg = _configs("internlm2-1.8b", "f32")
    model = ptf.LM(pcfg, generator=torch.Generator().manual_seed(1),
                   device="cpu")
    toks = torch.tensor(_token_batch(pcfg.vocab, 2, 9)["tokens"])
    weights = model.weights()
    assert [n for n, _ in pytree.flatten_with_paths(weights)[0]] == \
        [n for n, _ in pytree.flatten_with_paths(ptf.param_shapes(pcfg))[0]]
    with torch.no_grad():
        assert torch.equal(model(toks),
                           ptf.forward(weights, toks, pcfg, device="cpu"))


def test_lm_converters_check_and_carry_bfloat16_bits():
    jcfg, pcfg = _configs("kimi-k2-1t-a32b", "bf16")
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jcfg, jax.random.PRNGKey(3)))
    tp = convert.lm_params_from_arrays(params, pcfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["embed"].view(torch.int16).numpy(),
        params["embed"].view(np.int16))
    bad = dict(params, head=params["head"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_arrays(bad, pcfg, device="cpu")
    missing = dict(params)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="wants"):
        convert.lm_params_from_arrays(missing, pcfg, device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convert.lm_params_from_arrays(
            dict(params, final_norm=params["final_norm"].astype(np.float64)),
            pcfg, device="cpu")
    cache = jax.tree.map(np.asarray, jtf.init_cache(jcfg, 2, 8))
    tc = convert.lm_cache_from_arrays(cache, pcfg, device="cpu")
    assert tc["k"].shape == (2, 2, 8, 2, 16) and tc["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="config"):
        convert.lm_cache_from_arrays(
            {"k": cache["k"][:1], "v": cache["v"][:1]}, pcfg, device="cpu")
    with pytest.raises(ValueError, match="'k', 'v'"):
        convert.lm_cache_from_arrays({"k": cache["k"]}, device="cpu")


def test_serve_logits_match_a_teacher_forced_forward():
    """``serve.generate``'s prefill-then-decode logits equal the forward
    over the prompt and the generated tokens, position for position (the
    check ``chip_smoke.py`` makes at full width), and ``serve.main``
    returns the same tokens for the same seed."""
    _, pcfg = _configs("llama4-scout-17b-a16e", "f32")
    argv = ["--arch", "llama4-scout-17b-a16e", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "37", "--gen", "6", "--seed", "4"]
    toks = serve.main(argv)
    params = ptf.init_params(pcfg, torch.Generator().manual_seed(4),
                             device="cpu")
    prompt = torch.tensor(serve.prompt_tokens(pcfg.vocab, 2, 37, 4))
    out = serve.generate(params, prompt, pcfg, 6, device="cpu")
    assert torch.equal(out["tokens"], toks) and toks.shape == (2, 6)
    full = torch.cat([prompt, out["tokens"]], dim=1)
    with torch.no_grad():
        ref = ptf.forward(params, full, pcfg, device="cpu")[:, 36:42]
    assert _rel(_np(out["logits"]), _np(ref)) <= F32_TOL
    assert torch.equal(out["tokens"], torch.argmax(out["logits"], -1).int())
