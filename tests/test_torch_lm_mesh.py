"""The port's language models on a mesh, in gloo worlds of CPU processes,
against the JAX package's single-device (``ctx=None``) jnp results on the
same numpy weights, and against its own sharded loss.

One world a mesh shape (``distributed.launch``), every case of that shape
inside it (``_mesh_ranks.lm_cases``); each rank gets the whole weights as
arrays and keeps its blocks (``convert.lm_shards_from_arrays``), runs
``forward``, ``loss_fn``, ``prefill`` (the cache gathered whole) and
teacher-forced ``decode_step``s, and gathers the logits whole. The cases:

* heads mode: phi3's and internlm2's ``reduced_config()`` in (2, 2)
  (FSDP over data, heads and d_ff over model, sequence parallelism), and
  phi3's in bfloat16;
* context mode: the JAX package's own 3-head configuration
  (tests/test_distributed.py) at tp = 2 in (2, 2), and smollm's reduced
  config at (1, 4) (2 KV heads over 4), the cache's sequence over tp;
* a sequence-sharded cache: phi3's reduced config in (2, 1) with
  ``cache_seq_shard``, decoding at positions in both sequence shards, and
  the 3-head configuration so in (2, 2) (context mode, FSDP, the cache's
  sequence over data: ``long_500k``'s layout);
* pod rules: smollm's reduced config in (2, 2, 2) (dp and fsdp over
  (pod, data));
* MoE: llama4-scout's reduced config with ``moe_impl="reference"`` in
  (2, 2), the experts over model;
* the expert-parallel MoE (``ShardCtx``'s default ``moe_impl="ep"``):
  llama4-scout's and kimi-k2's reduced configs in (2, 2), kimi-k2's at
  (1, 4) (context mode: 2 KV heads over 4), and llama4-scout's at
  ``moe_cap_factor=0.5``, where pairs drop; held to the JAX package's
  same calls under its ``ShardCtx`` on the same mesh of forced host
  devices (the 4-device subprocess below), at ``F32_TOL``, the cache
  within ``CACHE_TOL`` and the loss within ``LOSS_RTOL``; each rank's
  dropped pairs equal ``chip_smoke.py``'s host recount over the routing
  it returns (above zero at 0.5). Both packages refuse (``ValueError``)
  a batch of 3 where dp is 2 and a sequence of 39, and run a decode step
  at a batch of 3;
* ``Grid.all_to_all`` in float32, bfloat16, int32 and int16 over each
  axis of (2, 2) and (1, 4) and over the whole grid: block i of what a
  rank receives is exactly what member i sent it;
* grad mode under a ``ShardCtx`` is refused, naming its slice.

Bounds, set before the comparisons (those of tests/test_torch_lm.py):
float32 logits within ``F32_TOL`` = 1e-5 of the largest |logit| (float32
sums split over ranks in another order), the cache within 1e-5 absolute, the loss within rtol
1e-5; bfloat16 within ``BF16_TOL`` = 1/64 of the largest |logit| (a
row-parallel product's partials are rounded to bfloat16 before they are
summed), the loss within rtol 1/64. Every rank's gathered results must be
equal, and the weights must round-trip exactly.

Against the JAX package's own sharded loss: its ``loss_fn`` under its
``ShardCtx`` on a (2, 2) mesh of forced host devices (the pattern of
tests/test_distributed.py), in heads and in context mode, held to the
port's (2, 2) loss on the same weights within rtol 1e-5.
"""
import importlib.util
import pathlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _mesh_ranks import A2A_DTYPES, a2a_block, lm_cases
from conftest import run_multidevice
from repro.configs import (internlm2_1_8b as j_internlm, kimi_k2 as j_kimi,
                           llama4_scout as j_llama4, phi3_mini as j_phi3,
                           smollm_135m as j_smollm)
from repro.models import transformer as jtf
from repro_torch.distributed import launch

F32_TOL = 1e-5
CACHE_TOL = 1e-5
LOSS_RTOL = 1e-5
BF16_TOL = 1.0 / 64
WORLD_TIMEOUT_S = 240.0

# the JAX package's 3-head test configuration (heads not divisible by 2)
THREE_HEADS = jtf.LMConfig(name="t", n_layers=2, d_model=30, n_heads=3,
                           n_kv=3, d_head=10, d_ff=64, vocab=128,
                           dtype=jnp.float32, q_chunk=16, kv_chunk=16)
# the JAX package's 4-head test configuration (tests/test_distributed.py)
FOUR_HEADS = jtf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                          n_kv=2, d_head=8, d_ff=64, vocab=128,
                          dtype=jnp.float32, q_chunk=16, kv_chunk=16)
WORLDS = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S, CACHE = 4, 40, 48
STEPS = 3


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype=jnp.bfloat16)


# name -> (world, config, options)
CASES = {
    "phi3 heads": ("2x2", j_phi3.reduced_config(), {}),
    "internlm2 heads": ("2x2", j_internlm.reduced_config(), {}),
    "phi3 heads bf16": ("2x2", _bf16(j_phi3.reduced_config()), {}),
    "3-head context": ("2x2", THREE_HEADS, {}),
    "3-head context seq-sharded cache": ("2x2", THREE_HEADS,
                                         {"seq_shard": True}),
    "smollm context 1x4": ("1x4", j_smollm.reduced_config(), {}),
    "phi3 seq-sharded cache": ("2x1", j_phi3.reduced_config(),
                               {"seq_shard": True}),
    "smollm pod": ("2x2x2", j_smollm.reduced_config(), {}),
    "llama4 moe reference": ("2x2", j_llama4.reduced_config(),
                             {"moe_impl": "reference"}),
}
# the expert-parallel MoE, held to the JAX package's under its ShardCtx
EP_CASES = {
    "llama4 ep": ("2x2", j_llama4.reduced_config(), {}),
    "kimi ep": ("2x2", j_kimi.reduced_config(), {}),
    "kimi ep context 1x4": ("1x4", j_kimi.reduced_config(), {}),
    "llama4 ep cap 0.5": ("2x2", dataclasses.replace(
        j_llama4.reduced_config(), moe_cap_factor=0.5), {}),
}
REPO = pathlib.Path(__file__).resolve().parents[1]
# positions of the decode steps: past the prompt and, for the sequence
# shards of a 48-position cache over 2 ranks ([0, 24), [24, 48)), in both
DEC_POS = np.array([[40, 41, 44, 45], [20, 25, 33, 47], [21, 30, 46, 24]],
                   np.int32)


def _fields(cfg) -> dict:
    f = {x.name: getattr(cfg, x.name) for x in dataclasses.fields(cfg)}
    f["dtype"] = "bfloat16" if cfg.dtype == jnp.bfloat16 else "float32"
    return f


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    dec_tok = rng.integers(0, cfg.vocab, (STEPS, B)).astype(np.int32)
    return toks, labels, dec_tok


_JITTED = {}


def _jax_ref(cfg, params, toks, labels, dec_tok, dec_pos):
    """The JAX package's forward, prefill (the cache padded to CACHE),
    teacher-forced decode steps and loss, one jitted call a config."""
    if cfg in _JITTED:
        return jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                            _JITTED[cfg](params, toks, labels, dec_tok,
                                         dec_pos))

    @jax.jit
    def run(params, toks, labels, dec_tok, dec_pos):
        logits = jtf.forward(params, toks, cfg)
        last, cache = jtf.prefill(params, toks, cfg)
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, CACHE - S), (0, 0),
                                (0, 0))) for k, v in cache.items()}
        dec, c = [], cache
        for i in range(STEPS):
            lg, c = jtf.decode_step(params, c, dec_tok[i], dec_pos[i], cfg)
            dec.append(lg)
        loss = jtf.loss_fn(params, {"tokens": toks, "labels": labels}, cfg)
        return logits, last, cache, jnp.stack(dec, 1), loss
    _JITTED[cfg] = run
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                        run(params, toks, labels, dec_tok, dec_pos))


def _jax_mesh_script(path, out_path):
    """The JAX package on a (2, 2) or (1, 4) mesh of 4 forced host devices:
    the sharded losses, and for each expert-parallel case its forward,
    prefill (the cache padded to CACHE), teacher-forced decode steps and
    loss under its ``ShardCtx`` (one jitted call), and whether it refuses a
    batch of 3, a sequence one shorter and a decode step at a batch of 3
    (traced, not run)."""
    return f"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.models import transformer as tf
from repro.models.sharding import AxisRules
data = np.load({path!r}, allow_pickle=True).item()
out = {{}}
for name, (fields, params, toks, labels) in data["loss"].items():
    cfg = tf.LMConfig(**dict(fields, dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, params)
    batch = {{"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}}
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = tf.ShardCtx(mesh=mesh, rules=AxisRules.for_mesh(mesh))
    with set_mesh(mesh):
        loss = jax.jit(lambda p, b: tf.loss_fn(p, b, cfg, ctx))(params, batch)
    out[name] = [tf._attn_mode(cfg, ctx), float(loss)]
for name, (shape, fields, params, toks, labels, dec_tok,
           dec_pos) in data["ep"].items():
    cfg = tf.LMConfig(**dict(fields, dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, params)
    mesh = make_mesh(shape, ("data", "model"))
    ctx = tf.ShardCtx(mesh=mesh, rules=AxisRules.for_mesh(mesh))
    S = toks.shape[1]

    def run(params, toks, labels, dec_tok, dec_pos):
        logits = tf.forward(params, toks, cfg, ctx)
        last, cache = tf.prefill(params, toks, cfg, ctx)
        cache = {{k: jnp.pad(v, ((0, 0), (0, 0), (0, {CACHE} - S), (0, 0),
                                (0, 0))) for k, v in cache.items()}}
        dec, c = [], cache
        for i in range(dec_tok.shape[0]):
            lg, c = tf.decode_step(params, c, dec_tok[i], dec_pos[i], cfg, ctx)
            dec.append(lg)
        loss = tf.loss_fn(params, {{"tokens": toks, "labels": labels}}, cfg,
                          ctx)
        return logits, last, cache, jnp.stack(dec, 1), loss
    refused = {{}}
    with set_mesh(mesh):
        res = jax.jit(run)(params, toks, labels, dec_tok, dec_pos)
        fwd = jax.jit(lambda p, t: tf.forward(p, t, cfg, ctx))
        for what, t in (("batch", toks[:3]), ("sequence", toks[:, :-1])):
            try:
                fwd.lower(params, t)
                refused[what] = "runs"
            except ValueError as e:
                refused[what] = str(e)
        jax.jit(lambda p, c, t, q: tf.decode_step(p, c, t, q, cfg, ctx)).lower(
            params, tf.init_cache(cfg, 3, S), toks[:3, 0],
            jnp.zeros(3, jnp.int32))
        refused["decode batch 3"] = "runs"
    out[name] = dict(zip(("logits", "last", "cache", "decode", "loss"),
                         jax.tree.map(lambda a: np.asarray(a).astype(
                             np.float32), res)), refused=refused)
np.save({out_path!r}, out, allow_pickle=True)
print("done")
"""


SHARDED_LOSS = {"heads": (FOUR_HEADS, 8, 32), "context": (THREE_HEADS, 4, 32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world's results and the JAX package's references; the worlds
    and the sharded-loss subprocess run while the references compile."""
    cases, refs = {}, {}
    for i, (name, (world, cfg, opts)) in enumerate(CASES.items()):
        params = jtf.init_params(cfg, jax.random.PRNGKey(i))
        arrays = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                              params)
        toks, labels, dec_tok = _inputs(cfg, i)
        case = dict(cfg=_fields(cfg), params=arrays, toks=toks,
                    labels=labels, cache_len=CACHE, dec_tok=dec_tok,
                    dec_pos=DEC_POS, **opts)
        cases.setdefault(world, []).append((name, case))
        refs[name] = (cfg, params, toks, labels, dec_tok)
    ep_in = {}
    for i, (name, (world, cfg, opts)) in enumerate(EP_CASES.items()):
        params = jtf.init_params(cfg, jax.random.PRNGKey(50 + i))
        arrays = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                              params)
        toks, labels, dec_tok = _inputs(cfg, 50 + i)
        cases.setdefault(world, []).append((name, dict(
            cfg=_fields(cfg), params=arrays, toks=toks, labels=labels,
            cache_len=CACHE, dec_tok=dec_tok, dec_pos=DEC_POS, **opts)))
        ep_in[name] = (WORLDS[world][0], dict(_fields(cfg), dtype=None),
                       arrays, toks, labels, dec_tok, DEC_POS)
    for world in ("2x2", "1x4"):
        cases[world].append((f"all_to_all {world}", {"all_to_all": True}))
    loss_in = {}
    for mode, (cfg, b, s) in SHARDED_LOSS.items():
        params = jtf.init_params(cfg, jax.random.PRNGKey(100))
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                             cfg.vocab)).astype(np.int32)
        loss_in[mode] = (_fields(cfg), jax.tree.map(np.asarray, params),
                         toks, np.roll(toks, -1, 1))
        cases["2x2"].append((f"sharded loss {mode}", dict(
            cfg=_fields(cfg), params=jax.tree.map(
                lambda a: np.asarray(a).astype(np.float32), params),
            toks=toks, labels=np.roll(toks, -1, 1))))
    tmp = tmp_path_factory.mktemp("lm_mesh")
    path, out_path = str(tmp / "in.npy"), str(tmp / "out.npy")
    np.save(path, {"loss": {m: (dict(f, dtype=None), p, t, l)
                            for m, (f, p, t, l) in loss_in.items()},
                   "ep": ep_in}, allow_pickle=True)

    got, errors = {}, []

    def world(name):
        try:
            shape, axes = WORLDS[name]
            got[name] = launch(lm_cases, shape, axes,
                               ([c for _, c in cases[name]],), device="cpu",
                               timeout=WORLD_TIMEOUT_S)
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)

    def jax_mesh():
        try:
            run_multidevice(_jax_mesh_script(path, out_path), n_devices=4)
            got["jax_mesh"] = np.load(out_path, allow_pickle=True).item()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=world, args=(w,)) for w in WORLDS]
    threads.append(threading.Thread(target=jax_mesh))
    for t in threads:
        t.start()
    want = {name: _jax_ref(cfg, params, toks, labels, dec_tok, DEC_POS)
            for name, (cfg, params, toks, labels, dec_tok) in refs.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    results = {}
    for w, named in cases.items():
        for i, (name, _) in enumerate(named):
            results[name] = [r[i] for r in got[w]]
    return {"got": results, "want": want, "jax": got["jax_mesh"]}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_lm_matches_jax(run, name):
    ranks = run["got"][name]
    cfg = CASES[name][1]
    logits, last, cache, dec, loss = run["want"][name]
    bf16 = cfg.dtype == jnp.bfloat16
    tol = BF16_TOL if bf16 else F32_TOL
    r = ranks[0]
    assert _rel(r["logits"], logits) <= tol, ("forward", _rel(r["logits"],
                                                              logits))
    assert _rel(r["last"], last) <= tol, "prefill"
    assert _rel(r["decode"], dec) <= tol, ("decode", _rel(r["decode"], dec))
    np.testing.assert_allclose(r["loss"], float(loss),
                               rtol=BF16_TOL if bf16 else LOSS_RTOL)
    for k in ("k", "v"):
        err = np.abs(r["cache"][k] - cache[k]).max()
        assert err <= (BF16_TOL * 4 * np.abs(cache[k]).max() if bf16
                       else CACHE_TOL), (k, err)
    assert r["roundtrip"]
    for other in ranks[1:]:
        for k in ("logits", "last", "decode"):
            assert np.array_equal(other[k], r[k]), k
        assert other["loss"] == r["loss"]


def test_modes_and_layouts_are_the_ones_meant(run):
    """Each case runs the layout its name says: the attention mode, the
    cache's local shape, collectives on every rank."""
    g = run["got"]
    modes = {n: g[n][0]["mode"] for n in CASES}
    assert modes["phi3 heads"] == modes["internlm2 heads"] == "heads"
    assert modes["3-head context"] == modes["smollm context 1x4"] == "context"
    assert modes["smollm pod"] == "heads"
    # context at (1, 4): the cache's 48 positions over 4 ranks, KV whole
    assert g["smollm context 1x4"][0]["local_cache"] == (2, B, 12, 2, 16)
    # (2, 1) with cache_seq_shard: the sequence over data, the batch whole
    assert g["phi3 seq-sharded cache"][0]["local_cache"] == (2, B, 24, 4, 16)
    assert g["3-head context seq-sharded cache"][0]["mode"] == "context"
    assert g["3-head context seq-sharded cache"][0]["local_cache"] == \
        (2, B, 24, 3, 10)
    # heads mode in (2, 2): the batch over data, the KV heads over model
    assert g["phi3 heads"][0]["local_cache"] == (2, B // 2, CACHE, 2, 16)
    for name in CASES:
        assert all(r["stats"]["calls"] > 0 for r in g[name]), name


def test_ep_and_grad_mode_are_refused(run):
    """Grad mode under a ShardCtx is refused, naming its slice (2.3). The
    expert-parallel MoE runs, and refuses a batch or a sequence that does
    not split exactly where the JAX package's ``shard_map`` does."""
    moe = run["got"]["llama4 moe reference"][0]["refusals"]
    assert moe["ep"] == moe["ep decode batch 3"] == "runs"
    assert "batch of 3" in moe["ep batch"]
    assert "sequence of 39" in moe["ep sequence"]
    for name in EP_CASES:
        mine = run["got"][name][0]["refusals"]
        theirs = run["jax"][name]["refused"]
        assert mine["ep"] == "runs"
        for what in ("batch", "sequence"):
            assert (mine[f"ep {what}"] == "runs") == \
                (theirs[what] == "runs"), (what, mine, theirs)
        assert mine["ep decode batch 3"] == theirs["decode batch 3"] == "runs"
    for name in list(CASES) + list(EP_CASES):
        grad = run["got"][name][0]["refusals"]["grad"]
        assert "training on a mesh" in grad and "2.3" in grad


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_lm_matches_jax_ep(run, name):
    ranks = run["got"][name]
    want = run["jax"][name]
    r = ranks[0]
    for k in ("logits", "last", "decode"):
        assert r[k].shape == want[k].shape, k
        assert _rel(r[k], want[k]) <= F32_TOL, (k, _rel(r[k], want[k]))
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in ("k", "v"):
        assert np.abs(r["cache"][k] - want["cache"][k]).max() <= CACHE_TOL, k
    assert r["roundtrip"]
    for other in ranks[1:]:
        for k in ("logits", "last", "decode"):
            assert np.array_equal(other[k], r[k]), k
        assert other["loss"] == r["loss"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_lm_drops_match_host_recount(run, smoke, name):
    """The forward ran the expert-parallel MoE once a layer (two
    all-to-alls out, one back), in the attention mode its name says; each
    rank's dropped pairs equal the host recount, above zero at 0.5."""
    ranks = run["got"][name]
    cfg = EP_CASES[name][1]
    assert ranks[0]["mode"] == ("context" if "context" in name else "heads")
    for r in ranks:
        assert r["ep"]["calls"] == cfg.n_layers
        assert r["ep"]["a2a_calls"] == 3 * cfg.n_layers
    counted = [r["ep"]["dropped"] for r in ranks]
    assert counted == smoke.ep_recount([r["routes"] for r in ranks])
    if cfg.moe_cap_factor == 0.5:
        assert sum(counted) > 0
    assert run["got"]["llama4 moe reference"][0]["ep"]["calls"] == 0


def _members(coords: dict, names: tuple, shape: tuple, axes: tuple) -> list:
    """The ranks that share ``coords`` off ``axes``, by flat index along
    ``axes`` (the first major)."""
    sizes = [shape[names.index(a)] for a in axes]
    out = []
    for flat in range(int(np.prod(sizes))):
        c = dict(coords)
        for a, v in zip(axes, np.unravel_index(flat, sizes)):
            c[a] = int(v)
        out.append(int(np.ravel_multi_index([c[a] for a in names], shape)))
    return out


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_all_to_all_delivers_each_block(run, world):
    """Block i of what a rank receives is what member i of its group sent
    it, bit for bit, in every type."""
    shape, names = WORLDS[world]
    dtypes = {str(dt): dt for dt in A2A_DTYPES}
    ranks = run["got"][f"all_to_all {world}"]
    checked = 0
    for r in ranks:
        for key, got in r.items():
            if not isinstance(key, tuple):
                continue
            axes, dt = key
            members = _members(r["coords"], names, shape, axes)
            me = members.index(r["rank"])
            for i, m in enumerate(members):
                want = a2a_block(m, me, dtypes[dt]).double().numpy()
                np.testing.assert_array_equal(got[i], want)
            checked += 1
    assert checked == len(ranks) * (len(names) + 1) * len(A2A_DTYPES)


@pytest.mark.parametrize("mode", list(SHARDED_LOSS))
def test_loss_matches_jax_sharded_loss(run, mode):
    jmode, jloss = run["jax"][mode]
    assert jmode == mode
    got = run["got"][f"sharded loss {mode}"]
    assert got[0]["mode"] == mode
    np.testing.assert_allclose(got[0]["loss"], jloss, rtol=LOSS_RTOL)
    assert all(r["loss"] == got[0]["loss"] for r in got)
