"""Training the port's language models against the JAX package's, on the
CPU: ``TokenPipeline``, one train step of each reduced configuration
against the JAX package's jitted ``make_train_step`` (AdamW; Muon for
kimi-k2) with the weights and the optimiser state carried across,
``launch.train``'s ``--resume``, a bfloat16 checkpoint written by the JAX
package and read by the port, and the architecture registry.

Bounds, set before the comparisons:

* the loss and the gradient's global norm within rtol 1e-5 (the
  forward's float32 bound, ``test_torch_lm.py``);
* AdamW's moments within rtol 1e-4 and atol 1e-7 (m) / 1e-9 (v), the
  weights within rtol 1e-4 and atol 3e-5, a tenth of the learning rate
  (``test_torch_train.py``'s bounds and reasons: where a gradient element
  is near ``eps`` its float32 error moves the step by a few hundredths of
  ``lr``);
* Muon's stacked leaves (kimi-k2): each leaf's update (the weight after
  the step less before) within ``MUON_UPDATE_RTOL`` = 5e-2 of the JAX
  package's in Frobenius norm, and every element of it within one Muon
  step, ``lr`` = 0.02 (scale 1 at these square widths); their bfloat16
  momentum (the gradient, after one step) within rtol 1e-2 / atol 1e-5.
  The Newton-Schulz iteration runs in bfloat16 in both packages: each of
  its five iterations rounds X, A and B to bfloat16 (2^-9 relative), and a
  gradient that differs in its last float32 bits flips some of those
  roundings, so the orthogonalised updates differ by ~1e-2 in norm; in
  the directions of a gradient's tiny singular values (an expert few
  tokens reach) the iteration's output is set by those last bits, so a
  single element may differ by a good part of a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import checkpoint as jckpt
from repro import optim as jopt
from repro.data import pipeline as jpipe
from repro.models import transformer as jtf
from repro.train import make_train_step as jmake_train_step
import repro_torch.configs as pconfigs
from repro_torch import checkpoint as pckpt
from repro_torch import convert, optim as popt, pytree
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as ptf
from repro_torch.train import make_train_step

LOSS_TOL = dict(rtol=1e-5)
M_TOL = dict(rtol=1e-4, atol=1e-7)
V_TOL = dict(rtol=1e-4, atol=1e-9)
W_TOL = dict(rtol=1e-4, atol=3e-5)
MUON_UPDATE_RTOL = 5e-2
MUON_LR = 0.02
MUON_MOM_TOL = dict(rtol=1e-2, atol=1e-5)
LM_ARCHS = ["smollm-135m", "phi3-mini-3.8b", "internlm2-1.8b",
            "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
@pytest.mark.parametrize("step", [0, 7])
def test_token_pipeline_bit_equal(step, host_id, n_hosts):
    want = jpipe.TokenPipeline(vocab=1000, batch=8, seq=33, seed=5).get_batch(
        step, host_id, n_hosts)
    got = TokenPipeline(vocab=1000, batch=8, seq=33, seed=5).get_batch(
        step, host_id, n_hosts)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def _np_leaves(tree):
    return [np.asarray(x).astype(np.float32)
            for x in jax.tree_util.tree_leaves(tree)]


def _close(got_tree, want_tree, tol_of):
    got = pytree.flatten_with_paths(got_tree)[0]
    want = _np_leaves(want_tree)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.detach().float().numpy(), w,
                                   err_msg=path, **tol_of(g))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_jax(arch):
    jmod, pmod = jconfigs.get(arch), pconfigs.get(arch)
    jcfg, pcfg = jmod.reduced_config(), pmod.reduced_config()
    muon = pmod.OPTIMIZER == "muon"
    jo, po = (jopt.muon(), popt.muon()) if muon else (jopt.adamw(),
                                                      popt.adamw())
    params = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    arrays = jax.tree.map(np.asarray, params)
    batch = jpipe.TokenPipeline(jcfg.vocab, 4, 24, seed=2).get_batch(0)
    jstep, jinit = jmake_train_step(lambda p, b: jtf.loss_fn(p, b, jcfg), jo)
    js = jinit(params)
    jp, js, jm = jax.jit(jstep)(params, js, batch)

    pp = convert.lm_params_from_arrays(arrays, pcfg, device="cpu")
    pstep, pinit = make_train_step(
        lambda p, b: ptf.loss_fn(p, b, pcfg, device="cpu"), po)
    ps = convert.opt_state_from_arrays(
        jax.tree.map(np.asarray, jinit(params)), device="cpu")
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    pp, ps, pm = pstep(pp, ps, pb)

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               **LOSS_TOL)
    assert int(ps["step"]) == int(js["step"]) == 1
    if muon:
        for (path, g), w, a in zip(pytree.flatten_with_paths(pp)[0],
                                   jax.tree_util.tree_leaves(jp),
                                   jax.tree_util.tree_leaves(arrays)):
            if g.ndim < 3:
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                           err_msg=path, **W_TOL)
                continue
            got_u = g.detach().numpy() - a
            want_u = np.asarray(w) - a
            assert np.linalg.norm(got_u - want_u) <= \
                MUON_UPDATE_RTOL * np.linalg.norm(want_u), path
            assert np.abs(got_u - want_u).max() <= MUON_LR, path
        states = pytree.leaves(ps["opt"], is_leaf=lambda x: isinstance(x, dict)
                               and set(x) == {"mom", "m", "v"})
        jstates = jax.tree_util.tree_leaves(
            js["opt"], is_leaf=lambda x: isinstance(x, dict)
            and set(x) == {"mom", "m", "v"})
        for st, jst in zip(states, jstates):
            _close(st["mom"], jst["mom"], lambda t: MUON_MOM_TOL)
            _close(st["m"], jst["m"], lambda t: M_TOL)
            _close(st["v"], jst["v"], lambda t: V_TOL)
    else:
        _close(pp, jp, lambda t: W_TOL)
        _close(ps["opt"]["m"], js["opt"]["m"], lambda t: M_TOL)
        _close(ps["opt"]["v"], js["opt"]["v"], lambda t: V_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b"])
def test_train_main_resumes_bit_equal(arch, tmp_path):
    """Four straight steps give the losses of two steps, a checkpoint, and
    a ``--resume`` of two more, bit for bit on the CPU (AdamW; Muon for
    kimi-k2, whose state holds a bfloat16 momentum)."""
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--seed", "3", "--log-every", "1"]
    straight = ptrain.main(base + ["--steps", "4"])
    ckpt = str(tmp_path / "ckpt")
    first = ptrain.main(base + ["--steps", "2", "--ckpt-dir", ckpt,
                                "--ckpt-every", "2"])
    assert pckpt.latest_step(ckpt) == 2
    out = ptrain.run(ptrain.parse_args(
        base + ["--steps", "4", "--ckpt-dir", ckpt, "--ckpt-every", "2",
                "--resume"]))
    assert out["start"] == 2 and len(out["step_s"]) == 2
    assert len(straight) == 4 and np.isfinite(straight).all()
    assert first + out["losses"] == straight
    assert pckpt.latest_step(ckpt) == 4


def test_bfloat16_checkpoint_of_the_jax_package_restores(tmp_path):
    """A reduced bfloat16 LM's weights saved by the JAX package's
    ``checkpoint.save`` (its bfloat16 leaves as numpy's void type), read by
    the port's ``restore``: the same leaves, bit for bit, and so the same
    logits as the weights carried by ``lm_params_from_arrays``."""
    jcfg = dataclasses.replace(jconfigs.get("llama4-scout-17b-a16e")
                               .reduced_config(), dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pconfigs.get("llama4-scout-17b-a16e")
                               .reduced_config(), dtype=torch.bfloat16)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(4))
    jckpt.save(str(tmp_path), 5, params, metadata={"step": 5})
    got, meta = pckpt.restore(str(tmp_path), 5, ptf.param_shapes(pcfg),
                              device="cpu")
    assert meta["step"] == 5
    want = convert.lm_params_from_arrays(jax.tree.map(np.asarray, params),
                                         pcfg, device="cpu")
    for (path, g), w in zip(pytree.flatten_with_paths(got)[0],
                            pytree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    toks = torch.tensor(TokenPipeline(pcfg.vocab, 2, 20).get_batch(0)
                        ["tokens"])
    with torch.no_grad():
        assert torch.equal(ptf.forward(got, toks, pcfg, device="cpu"),
                           ptf.forward(want, toks, pcfg, device="cpu"))


def test_registry_matches_jax_but_bfs_graph500():
    assert list(pconfigs.ARCHS) == [a for a in jconfigs.ARCHS
                                    if a != "bfs-graph500"]
    assert pconfigs.ASSIGNED == jconfigs.ASSIGNED
    for arch in pconfigs.ASSIGNED:
        assert pconfigs.get(arch).ARCH_ID == arch
        assert pconfigs.get(arch).FAMILY == jconfigs.get(arch).FAMILY
        assert pconfigs.shapes_for(arch) == jconfigs.shapes_for(arch)
    with pytest.raises(KeyError, match="bfs-graph500"):
        pconfigs.get("bfs-graph500")
