"""The port's expert-parallel MoE (``models.moe``: ``_pack``,
``moe_ep_train``, ``moe_ep_decode``, ``check_ep``) against the JAX
package's own, on the same numpy inputs.

The JAX package's side runs on forced host devices, one
``conftest.run_multidevice`` subprocess a device count (4 for the (2, 2)
and (1, 4) meshes, 8 for the (2, 2, 2) pod mesh, whose dp and fsdp are
("pod", "data")); the port's in gloo worlds of CPU processes
(``distributed.launch``, ``_mesh_ranks.moe_ep_cases``), each rank holding
its blocks of x and of the experts and the outputs gathered whole. Both
sides run while the single-device references compute.

Cases: x [4, 8, 16], 8 experts top-2, d_ff 32, at capacity factors 4.0
(nothing drops), 1.0 and 0.5 (pairs drop), float32 and bfloat16, on each
mesh; on (2, 2) also every pair routed to one rank's experts (the other
rank receives only empty slots, two of the first rank's experts no
pair), one expert never routed (a local expert with no pair while every
rank receives), a [2, 2, 16] x (one token a rank, ``cap_s * tp`` past the
pairs sent) and a decode step at a batch of 3 (replicated over data).

Bounds, set before the comparisons:

* ``_pack``: bit-equal to the JAX package's (int32), in one process.
* float32 outputs of ``moe_ep_train`` and ``moe_ep_decode`` within
  ``F32_TOL`` = 1e-5 of the largest |y| of the JAX package's; bfloat16
  within ``BF16_TOL`` = 1/64 of it (the expert FFN's intermediate
  roundings may differ, and the decode's SUM over tp rounds once from
  float32 where XLA adds in bfloat16).
* At capacity factor 4.0 the same bounds against the JAX package's
  single-device ``moe_reference``.
* The drops each rank counts (``moe.STATS``) equal ``chip_smoke.py``'s
  host recount (``ep_recount``) over the routing the ranks return,
  exactly; zero at 4.0, above zero at 0.5.
* ``ValueError`` in both packages for a batch that does not split over
  dp (3 over 2), a sequence that does not split over tp (15 over 2) and
  experts that do not split over tp (6 over 4); the decode at a batch of
  3 runs in both.
"""
import importlib.util
import pathlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_ranks import moe_ep_cases
from conftest import run_multidevice
from repro.models import moe as jmoe
from repro_torch.distributed import launch
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe as pmoe

F32_TOL = 1e-5
BF16_TOL = 1.0 / 64
WORLD_TIMEOUT_S = 240.0
REPO = pathlib.Path(__file__).resolve().parents[1]

E, K, D, FF = 8, 2, 16, 32
WORLDS = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DEVICES = {"2x2": 4, "1x4": 4, "2x2x2": 8}


def _case(seed, *, shape=(4, 8, 16), cf=4.0, dtype="float32", route=None,
          n_experts=E, train=True, decode=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    wr = (rng.standard_normal((D, n_experts)) * 0.1).astype(np.float32)
    if route is not None:
        x = np.abs(x)
    if route == "one rank":          # experts 0 and 1: rank 0's (4 a rank)
        wr[:, :2] = 1.0
    elif route == "idle expert":     # expert 5 (rank 1's second) never
        wr[:, 5] = -1.0
    w = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in (("wig", (n_experts, D, FF)), ("wiu", (n_experts, D, FF)),
                      ("wo", (n_experts, FF, D)))}
    return dict(dims=dict(n_experts=n_experts, top_k=K, d_model=D, d_ff=FF,
                          cap_factor=cf),
                dtype=dtype, x=x, wr=wr, train=train, decode=decode, **w)


def _cases():
    """name -> (world, case)."""
    out, seed = {}, 0
    for world in WORLDS:
        for cf in (4.0, 1.0, 0.5):
            for dtype in ("float32", "bfloat16"):
                out[f"{world} cf {cf} {dtype}"] = (world, _case(
                    seed, cf=cf, dtype=dtype))
                seed += 1
    out["2x2 one rank"] = ("2x2", _case(100, cf=1.0, route="one rank"))
    out["2x2 one rank cf 4.0"] = ("2x2", _case(101, route="one rank"))
    out["2x2 idle expert"] = ("2x2", _case(102, cf=1.0, route="idle expert"))
    out["2x2 one token a rank"] = ("2x2", _case(103, shape=(2, 2, 16)))
    out["2x2 decode batch 3"] = ("2x2", _case(104, shape=(3, 1, 16),
                                              train=False))
    return out


CASES = _cases()
# where the JAX package's shard_map refuses: (world, case, kind)
REFUSED = {"batch 3 over dp 2": ("2x2", _case(200, shape=(3, 16, 16)),
                                 "train"),
           "sequence 15 over tp 2": ("2x2", _case(201, shape=(4, 15, 16)),
                                     "train"),
           "6 experts over tp 4": ("1x4", _case(202, n_experts=6), "train"),
           "6 experts over tp 4, decode": ("1x4", _case(203, n_experts=6),
                                           "decode")}


def _jax_script(path: str, out_path: str) -> str:
    return f"""
import functools
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.models import moe
data = np.load({path!r}, allow_pickle=True).item()
out = {{}}
for name, (shape, axes, c, kinds) in data.items():
    mesh = make_mesh(shape, axes)
    pod = "pod" in axes
    kw = dict(dp=("pod", "data") if pod else ("data",), tp="model",
              fsdp=("pod", "data") if pod else ("data",))
    dims = moe.MoEDims(**c["dims"])
    dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    x = jnp.asarray(c["x"], dt)
    ws = [jnp.asarray(c[n], dt) for n in ("wig", "wiu", "wo")]
    res = {{}}
    with set_mesh(mesh):
        for kind in kinds:
            fn = moe.moe_ep_train if kind == "train" else moe.moe_ep_decode
            xin = x if kind == "train" else x[:, :1]
            try:
                f = jax.jit(functools.partial(fn, dims=dims, mesh=mesh, **kw))
                y = f(xin, jnp.asarray(c["wr"]), *ws)
                res[kind] = np.asarray(y.astype(jnp.float32))
            except ValueError as e:
                res[kind + " error"] = str(e)
    out[name] = res
np.save({out_path!r}, out, allow_pickle=True)
print("done")
"""


def _kinds(c):
    return [k for k in ("train", "decode") if c[k]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's worlds and the JAX package's subprocesses, in threads,
    while the single-device references compute here."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    by_devices = {}
    for name, (world, c) in CASES.items():
        by_devices.setdefault(DEVICES[world], {})[name] = (
            WORLDS[world][0], WORLDS[world][1], c, _kinds(c))
    for name, (world, c, kind) in REFUSED.items():
        by_devices[DEVICES[world]][name] = (WORLDS[world][0],
                                            WORLDS[world][1], c, [kind])
    got, errors = {}, []

    def jax_side(n_dev, cases):
        try:
            path, out = str(tmp / f"in{n_dev}.npy"), str(tmp / f"out{n_dev}.npy")
            np.save(path, cases, allow_pickle=True)
            run_multidevice(_jax_script(path, out), n_devices=n_dev)
            got.update(np.load(out, allow_pickle=True).item())
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)

    def world(w):
        try:
            names = [n for n, (wn, _) in CASES.items() if wn == w]
            shape, axes = WORLDS[w]
            ranks = launch(moe_ep_cases, shape, axes,
                           ([CASES[n][1] for n in names],), device="cpu",
                           timeout=WORLD_TIMEOUT_S)
            got.update({("port", n): [r[i] for r in ranks]
                        for i, n in enumerate(names)})
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=jax_side, args=item)
               for item in by_devices.items()]
    threads += [threading.Thread(target=world, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    ref = {}
    for name, (_, c) in CASES.items():
        if c["dims"]["cap_factor"] != 4.0:
            continue
        dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
        dims = jmoe.MoEDims(**c["dims"])
        args = [jnp.asarray(c["wr"])] + [jnp.asarray(c[n], dt)
                                         for n in ("wig", "wiu", "wo")]
        x = jnp.asarray(c["x"], dt)
        ref[name] = {k: np.asarray(jmoe.moe_reference(xin, *args, dims)
                                   .astype(jnp.float32))
                     for k, xin in (("train", x), ("decode", x[:, :1]))}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"got": got, "ref": ref}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ _pack


@pytest.mark.parametrize("n_groups,cap", [(2, 1), (2, 5), (4, 3), (8, 2),
                                          (8, 100), (3, 1)])
def test_pack_is_bit_equal_to_jax(n_groups, cap):
    rng = np.random.default_rng(n_groups * 100 + cap)
    keys = rng.integers(-1, n_groups, 200).astype(np.int32)   # -1s included
    keys[:20] = 0                                             # overflow
    want = np.asarray(jmoe._pack(jnp.asarray(keys), n_groups, cap))
    got = pmoe._pack(torch.tensor(keys), n_groups, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ EP on meshes


@pytest.mark.parametrize("name", list(CASES))
def test_ep_matches_jax_ep(run, name):
    world, c = CASES[name]
    want = run["got"][name]
    ranks = run["got"][("port", name)]
    tol = BF16_TOL if c["dtype"] == "bfloat16" else F32_TOL
    for kind in _kinds(c):
        assert kind in want, want.get(kind + " error")
        got = ranks[0][kind]
        assert got.shape == want[kind].shape
        assert np.isfinite(got).all()
        assert _rel(got, want[kind]) <= tol, (kind, _rel(got, want[kind]))
        for other in ranks[1:]:
            assert np.array_equal(other[kind], got), kind
        if name in run["ref"]:
            assert _rel(got, run["ref"][name][kind]) <= tol, \
                (kind, "moe_reference", _rel(got, run["ref"][name][kind]))


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items()
                                  if c["train"]])
def test_ep_drops_match_host_recount(run, smoke, name):
    ranks = run["got"][("port", name)]
    counted = [r["stats"]["dropped"] for r in ranks]
    assert counted == smoke.ep_recount([r["routes"] for r in ranks])
    assert all(r["stats"]["a2a_calls"] == 3 for r in ranks)
    cf = CASES[name][1]["dims"]["cap_factor"]
    if cf == 4.0:
        assert sum(counted) == 0
    if cf == 0.5:
        assert sum(counted) > 0


def test_one_rank_routing_leaves_the_other_rank_empty(run):
    """Every pair went to rank 0's experts: the ranks of model index 1
    received only empty slots, and at capacity factor 1.0 the sources
    dropped the pairs past their ``cap_s``."""
    for name in ("2x2 one rank", "2x2 one rank cf 4.0"):
        for r in run["got"][("port", name)]:
            for route in r["routes"]:
                assert (np.asarray(route["eids"]) < 2).all()
    assert sum(r["stats"]["dropped_send"]
               for r in run["got"][("port", "2x2 one rank")]) > 0


@pytest.mark.parametrize("name", list(REFUSED))
def test_ep_refuses_where_jax_does(run, name):
    world, c, kind = REFUSED[name]
    assert kind + " error" in run["got"][name], "the JAX package ran"
    mesh = MeshShape(*WORLDS[world])
    dims = pmoe.MoEDims(**c["dims"])
    B, S, _ = c["x"].shape
    dp = ("data",)
    with pytest.raises(ValueError, match="does not divide"):
        pmoe.check_ep(dims, mesh, B, S, dp=dp, tp="model",
                      decode=kind == "decode")
    if "experts" in name:
        fn = pmoe.moe_ep_train if kind == "train" else pmoe.moe_ep_decode
        with pytest.raises(ValueError, match="experts over tp"):
            fn(torch.tensor(c["x"]), torch.tensor(c["wr"]),
               *(torch.tensor(c[n]) for n in ("wig", "wiu", "wo")), dims,
               mesh, dp=dp, tp="model", fsdp=dp)


def test_decode_batch_that_does_not_split_runs(run):
    """A decode step at a batch of 3 on (2, 2): both packages run it, the
    batch replicated over data."""
    mesh = MeshShape(*WORLDS["2x2"])
    pmoe.check_ep(pmoe.MoEDims(E, K, D, FF), mesh, 3, 1, dp=("data",),
                  tp="model", decode=True)
    assert "decode" in run["got"]["2x2 decode batch 3"]
