"""DLRM with row-sharded and hybrid tables, in gloo worlds of CPU
processes, against the JAX package's ``dlrm_forward`` (its jnp lookups)
and the port's single-device forward on the same numpy weights.

The configuration is ``dlrm_mlperf.reduced_config()`` with two more
tables at its width: one of 3 rows (padded to the ``tp`` extent, so at
tp = 4 a rank holds padding only) and one of 1,000,003 rows (at or past
the hybrid threshold once padded). One world a mesh shape, (1, 2), (2, 2)
and (1, 4), each running every table placement (all tables sharded, and
hybrid: only the big table sharded) at bags of one id (K = 1) and of
three with pads (K = 3), and in (2, 2) the retrieval scores over
candidates split over data.

Bounds, set before the comparisons: the logits within ``TOL`` = 1e-5 of
the largest |logit| of the JAX package's (tests/test_torch_dlrm.py's bound
for the single-device forward: float32 products summed in another order);
at K = 1 where the batch is not split (data = 1) bit-equal to the port's
single-device forward (each bag is one row, added on one rank to zeros on
the others); at K = 3 within 1e-6 of the largest |logit| of the port's
single-device forward (a bag's three rows summed in another order); the
retrieval scores within 1e-6 relative of the single-device scores. The
tables round-trip exactly, every rank's gathered logits are equal, the
sharded fields' all-reduce runs on every rank (none for a hybrid
placement with every small table whole, but the big table's), and grad
mode is refused naming its slice.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_ranks import dlrm_cases
from repro.configs import dlrm_mlperf as j_dlrm
from repro.models import dlrm as jdlrm
from repro_torch import convert
from repro_torch.configs import dlrm_mlperf as p_dlrm
from repro_torch.distributed import launch
from repro_torch.models import dlrm as pdlrm

TOL = 1e-5
SPLIT_TOL = 1e-6
WORLD_TIMEOUT_S = 240.0
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
VOCABS = j_dlrm.reduced_config().vocabs + (3, 1_000_003)
B, N_CAND = 8, 1000


def _cfgs():
    return (dataclasses.replace(j_dlrm.reduced_config(), vocabs=VOCABS),
            dataclasses.replace(p_dlrm.reduced_config(), vocabs=VOCABS))


def _arrays(cfg, seed=0):
    """The weights as numpy arrays: tables N(0, 1/d), He-normal MLPs."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    tables = [(rng.standard_normal((v, d), dtype=np.float32)
               / np.float32(np.sqrt(d))) for v in cfg.vocabs]

    def mlp(sizes):
        return [{"w": (rng.standard_normal((a, b), dtype=np.float32)
                       * np.float32(np.sqrt(2.0 / a))),
                 "b": rng.standard_normal(b, dtype=np.float32) * 0.1}
                for a, b in zip(sizes[:-1], sizes[1:])]
    top = [cfg.n_interactions + cfg.bot_mlp[-1]] + list(cfg.top_mlp)
    return {"tables": tables, "bot": mlp(list(cfg.bot_mlp)), "top": mlp(top)}


def _batch(cfg, K, seed):
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, v, (B, K)) for v in cfg.vocabs],
                      1).astype(np.int32)
    if K > 1:
        sparse[rng.random(sparse.shape) < 0.3] = -1
        sparse[0, :, :] = -1                      # one sample's bags empty
    # the big table's ids in every shard of it
    sparse[:, -1, 0] = np.linspace(0, cfg.vocabs[-1] - 1, B).astype(np.int32)
    return {"dense": rng.standard_normal((B, cfg.n_dense),
                                         dtype=np.float32),
            "sparse": sparse}


CASES = [(hybrid, K) for hybrid in (False, True) for K in (1, 3)]


@pytest.fixture(scope="module")
def run():
    jcfg, pcfg = _cfgs()
    arrays = _arrays(pcfg)
    fields = {f.name: getattr(pcfg, f.name)
              for f in dataclasses.fields(pcfg) if f.name != "dtype"}
    batches = {K: _batch(pcfg, K, K) for K in (1, 3)}
    rng = np.random.default_rng(9)
    cands = rng.standard_normal((N_CAND, pcfg.embed_dim), dtype=np.float32)
    user = rng.standard_normal((1, pcfg.n_dense), dtype=np.float32)
    got, errors = {}, []

    def world(name):
        try:
            cases = [dict(cfg=fields, params=arrays, batch=batches[K],
                          hybrid=hybrid) for hybrid, K in CASES]
            if name == "2x2":
                cases[0].update(cands=cands, user=user)
            got[name] = launch(dlrm_cases, WORLDS[name], ("data", "model"),
                               (cases,), device="cpu",
                               timeout=WORLD_TIMEOUT_S)
        except BaseException as e:          # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=world, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    jp = jax.tree.map(jnp.asarray, arrays)
    want = {K: np.asarray(jdlrm.dlrm_forward(
        jp, jax.tree.map(jnp.asarray, batches[K]), jcfg)) for K in (1, 3)}
    tp = convert.dlrm_params_from_arrays(arrays, pcfg, device="cpu")
    with torch.no_grad():
        single = {K: pdlrm.dlrm_forward(tp, convert.dlrm_batch_from_arrays(
            batches[K], device="cpu"), pcfg, device="cpu").numpy()
            for K in (1, 3)}
        u = pdlrm.dlrm_user_tower(tp, {"dense": torch.tensor(user)}, pcfg,
                                  device="cpu")[0]
        scores = pdlrm.retrieval_scores(u, torch.tensor(cands)).numpy()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"got": got, "want": want, "single": single, "scores": scores,
            "cfg": pcfg}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("hybrid,K", CASES)
def test_sharded_dlrm_matches_jax(run, world, hybrid, K):
    ranks = [r[CASES.index((hybrid, K))] for r in run["got"][world]]
    got, want, single = ranks[0]["logits"], run["want"][K], run["single"][K]
    assert got.shape == (B,) and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    if K == 1 and WORLDS[world][0] == 1:
        assert np.array_equal(got, single)
    else:
        assert np.abs(got - single).max() <= SPLIT_TOL * scale
    for r in ranks:
        assert np.array_equal(r["logits"], got)
        assert r["roundtrip"]
        assert "training-on-a-mesh" in r["grad_refused"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_placement_and_collectives(run, world):
    """All-sharded: every table's rows split over model (the 3-row table
    padded, a rank of four holding padding only); hybrid: only the big
    table split; the sharded fields reduced on every rank."""
    cfg = run["cfg"]
    tp = WORLDS[world][1]
    for hybrid, K in CASES:
        for r in (ranks[CASES.index((hybrid, K))]
                  for ranks in run["got"][world]):
            want = [-(-v // tp) if (not hybrid or v >= 1_000_000) else v
                    for v in cfg.vocabs]
            assert r["rows"] == want
            assert r["stats"]["calls"] >= 1
    assert pdlrm.padded_rows(3, 4) == 4


def test_retrieval_over_candidates_split_over_data(run):
    got = [r[0]["scores"] for r in run["got"]["2x2"]]
    want = run["scores"]
    for g in got:
        assert g.shape == (N_CAND,)
        np.testing.assert_allclose(g, want, rtol=SPLIT_TOL, atol=0)
