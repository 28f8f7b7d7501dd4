"""The port stands alone: it imports neither JAX nor the JAX package, and
without a card its entry points raise instead of running on the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, graph500, profile_graph500, pytree
from repro_torch.core import bfs as pbfs
from repro_torch.core import formats as pf
from repro_torch.core import multi_bfs as pmulti
from repro_torch.core import multi_sssp as pmsssp
from repro_torch.core import sssp as psssp
from repro_torch.graphs.generators import kronecker, with_random_weights

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    assert len(PORT_FILES) > 10
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/core/betweenness.py",
            "src/repro_torch/core/sssp.py",
            "src/repro_torch/core/multi_sssp.py",
            "src/repro_torch/configs/sssp_graph500.py",
            "src/repro_torch/models/gnn.py",
            "src/repro_torch/configs/gcn_cora.py",
            "src/repro_torch/models/dlrm.py",
            "src/repro_torch/configs/dlrm_mlperf.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/kernels/ref.py",
            "src/repro_torch/serving/__init__.py",
            "src/repro_torch/serving/batcher.py",
            "src/repro_torch/serving/dispatch.py",
            "src/repro_torch/serving/metrics.py",
            "src/repro_torch/serving/session.py",
            "src/repro_torch/serving/router.py",
            "src/repro_torch/core/dist_bfs.py",
            "src/repro_torch/distributed.py",
            "src/repro_torch/core/debug.py",
            "src/repro_torch/analysis/__init__.py",
            "src/repro_torch/analysis/contracts.py",
            "src/repro_torch/analysis/laws.py",
            "src/repro_torch/analysis/lint.py",
            "src/repro_torch/analysis/registry.py",
            "src/repro_torch/pytree.py",
            "src/repro_torch/optim/__init__.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/compress.py",
            "src/repro_torch/train/__init__.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/checkpoint/store.py",
            "src/repro_torch/kernels/autograd.py",
            "src/repro_torch/configs/cells.py",
            "src/repro_torch/configs/gin_tu.py",
            "src/repro_torch/configs/egnn.py",
            "src/repro_torch/configs/nequip.py",
            "src/repro_torch/graphs/sampler.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/smollm_135m.py",
            "src/repro_torch/configs/phi3_mini.py",
            "src/repro_torch/configs/internlm2_1_8b.py",
            "src/repro_torch/configs/llama4_scout.py",
            "src/repro_torch/configs/kimi_k2.py",
            "src/repro_torch/data/__init__.py",
            "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/profile_lm.py"} <= names
    assert (REPO / "src/repro_torch/analysis/lint_allow.txt").is_file()
    assert (REPO / "src/repro_torch/kernels/csrc/semiring_probe.cu").is_file()
    bad = {str(p.relative_to(REPO)): sorted(set(_imported_roots(p)) & {"jax", "repro"})
           for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = pf.build_slimsell(kronecker(6, 4, seed=0), C=8, L=16)
    return host


def test_to_torch_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        no_card.to_torch()
    assert no_card.to_torch("cpu").device == torch.device("cpu")


def test_entry_points_without_card_raise(no_card, monkeypatch):
    ran = []
    monkeypatch.setattr(pbfs.eng, "run_fused", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbfs.bfs(no_card, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.multi_source_bfs(no_card, [0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run_graph500(scale=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_graph500.main(["--scale", "5", "--batch", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_arrays({"d": np.zeros(3, np.int32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tiled_from_arrays(
            {k: getattr(no_card, k) for k in convert.LAYOUT_ARRAYS},
            {k: getattr(no_card, k) for k in convert.LAYOUT_META})
    assert not ran


def test_cpu_layout_is_not_moved_to_another_device(no_card):
    cpu = no_card.to_torch("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmulti.multi_source_bfs(cpu, [0])
    with pytest.raises(ValueError, match="layout is on cpu"):
        pbfs.bfs(cpu, 0, device="meta")


def test_betweenness_without_card_raises(no_card, monkeypatch):
    from repro_torch.core import betweenness as pbc
    from repro_torch.core.options import EngineConfig
    ran = []
    monkeypatch.setattr(pbc.eng, "run_fused", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(pbc.eng, "run_hostloop",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.betweenness(no_card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbc.betweenness(no_card, [0, 1], batch_size=1,
                        config=EngineConfig(mode="hostloop"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbc.betweenness(no_card.to_torch("cpu"), [0])
    assert not ran


def test_sssp_entry_points_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(psssp.eng, "run_fused", lambda *a, **k: ran.append(1))
    host = pf.build_slimsell(with_random_weights(kronecker(6, 4, seed=0)),
                             C=8, L=16)
    monkeypatch.setattr(pmsssp.eng, "run_fused", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psssp.sssp(host, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmsssp.multi_source_sssp(host, [0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.multi_source_sssp(host.to_torch("cpu"), [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run_graph500_sssp(scale=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run_graph500_sssp(scale=5, batched=True, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_graph500.main(["--scale", "5", "--batch", "2", "--sssp"])
    assert not ran


def test_gcn_entry_points_without_card_raise(monkeypatch):
    from repro_torch.configs.gcn_cora import reduced_config
    from repro_torch.models import gnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.gcn_init(cfg)
    params = repro_torch.gcn_init(cfg, device="cpu")
    csr = kronecker(6, 4, seed=0)
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    batch = {"node_feat": torch.zeros(csr.n, cfg.d_in),
             "edge_index": torch.from_numpy(np.stack([src, csr.indices])),
             "deg": torch.from_numpy(csr.deg),
             "tiled": pf.build_slimsell(csr, C=8, L=16).to_torch("cpu")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.gcn_forward(params, batch, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.GCN(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gcn_params_from_arrays({"w": [w.numpy() for w in params["w"]]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gnn_batch_from_arrays({k: v.numpy() for k, v in batch.items()
                                       if k != "tiled"})
    assert repro_torch.gcn_forward(params, batch, cfg, device="cpu").shape == \
        (csr.n, cfg.n_classes)


def test_dlrm_entry_points_without_card_raise(monkeypatch):
    from repro_torch.configs.dlrm_mlperf import reduced_config
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.models import dlrm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.dlrm_init(cfg)
    params = repro_torch.dlrm_init(cfg, device="cpu")
    arrays = CriteoPipeline(cfg.vocabs, 8).get_batch(0)
    batch = convert.dlrm_batch_from_arrays(arrays, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.dlrm_forward(params, batch, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dlrm.dlrm_loss(params, dict(batch, label=torch.zeros(8)), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dlrm.DLRM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.dlrm_params_from_arrays(
            {"tables": [t.numpy() for t in params["tables"]],
             **{k: [{n: v.numpy() for n, v in layer.items()} for layer in params[k]]
                for k in ("bot", "top")}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.dlrm_batch_from_arrays(arrays)
    assert repro_torch.dlrm_forward(params, batch, cfg, device="cpu").shape == (8,)


def test_profile_spmm_without_card_raises(monkeypatch):
    """The SpMM diagnostic measures the card: it raises before it builds a
    graph when there is none."""
    from repro_torch import profile_spmm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile_spmm, "kronecker",
                        lambda *a, **k: pytest.fail("built a graph"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_spmm.main(["--scale", "5"])


def test_dispatcher_without_card_raises(no_card, monkeypatch):
    """The dispatcher resolves its layout's device as the entry points do:
    without a card and without ``device=`` it raises, whether the layout is
    on the host or already on the CPU."""
    from repro_torch.core.options import EngineConfig
    from repro_torch.serving import Dispatcher, ServingMetrics
    monkeypatch.setattr(pbfs.eng, "run_fused", lambda *a, **k: pytest.fail())
    for layout in (no_card, no_card.to_torch("cpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Dispatcher(layout, EngineConfig(), ServingMetrics())
    disp = Dispatcher(no_card, EngineConfig(), ServingMetrics(), device="cpu")
    assert disp.device == torch.device("cpu")


def test_session_router_and_harnesses_without_card_raise(no_card,
                                                         monkeypatch):
    """The session, the router and both harnesses resolve their device as
    the entry points do: without a card and without ``device=`` they raise,
    before any layout is built or any sweep runs."""
    from repro_torch.serving import GraphSession, Router
    from repro_torch.serving import dispatch
    import sys
    session_mod = sys.modules["repro_torch.serving.session"]
    monkeypatch.setattr(pbfs.eng, "run_fused", lambda *a, **k: pytest.fail())
    monkeypatch.setattr(session_mod, "build_slimsell",
                        lambda *a, **k: pytest.fail("built a layout"))
    monkeypatch.setattr(dispatch, "Dispatcher",
                        lambda *a, **k: pytest.fail("made a dispatcher"))
    edges = np.array([[0, 1], [1, 2]])
    for layout in (no_card, no_card.to_torch("cpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphSession(layout)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Router().add_graph("g", layout)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.session(edges)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.GraphSession(edges, background=True)
    csr = kronecker(6, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run_graph500(scale=6, csr=csr, tiled=no_card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run_graph500_sssp(scale=6, csr=with_random_weights(csr))
    assert repro_torch.Router is Router
    assert repro_torch.EngineConfig().signature() == ("push", "fused")


def test_dist_factories_and_launcher_without_card_raise(monkeypatch):
    """The distributed factories and the launcher resolve their device
    first: without a card and without ``device="cpu"`` they raise before
    they read the grid, build a spec or start a rank."""
    from repro_torch import distributed
    from repro_torch.core import dist_bfs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed.mp, "get_context",
                        lambda *a, **k: pytest.fail("started a rank"))
    meta = {"n": 8, "C": 4, "L": 8, "R": 2, "Co": 2, "n_col": 4,
            "chunks_per_shard": 1, "t_max": 1}
    grid = None   # never read: the device is resolved first
    for factory in (dist_bfs.make_dist_bfs, dist_bfs.make_dist_multi_bfs,
                    dist_bfs.make_dist_sssp, dist_bfs.make_dist_multi_sssp,
                    dist_bfs.make_dist_cc, dist_bfs.make_dist_pagerank,
                    dist_bfs.make_dist_brandes, dist_bfs.make_dist_bfs_sliced):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(grid, meta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_bfs.make_dist_khop(grid, meta, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_bfs.make_dist_multi_bfs(grid, meta, "boolean", packed=True,
                                     batch_width=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.launch(dist_bfs.run_cases, (2, 2), ("data", "model"),
                           ([],))


def test_training_entry_points_without_card_raise(no_card, tmp_path):
    """The checkpoint restore and the state converter want the card unless
    told otherwise; the optimisers and the train step run where their
    tensors lie."""
    import torch as _torch
    from repro_torch.checkpoint import store
    store.save(str(tmp_path), 1, {"w": _torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.restore(str(tmp_path), 1, {"w": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.opt_state_from_arrays({"m": np.zeros(2, np.float32)})
    got, _ = store.restore(str(tmp_path), 1, {"w": 0}, device="cpu")
    assert got["w"].device == _torch.device("cpu")


def test_gnn_entry_points_without_card_raise(no_card):
    """GIN, EGNN and NequIP (init, forward, module) and the GNN converters
    want the card unless told otherwise; on the CPU they run."""
    from repro_torch.configs import egnn, gin_tu, nequip
    from repro_torch.models import gnn
    csr = kronecker(6, 4, seed=0)
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    arrays = {"node_feat": np.zeros((csr.n, 8), np.float32),
              "pos": np.random.default_rng(0).standard_normal(
                  (csr.n, 3)).astype(np.float32),
              "species": np.zeros(csr.n, np.int32),
              "edge_index": np.stack([csr.indices, src]).astype(np.int32),
              "graph_ids": np.zeros(csr.n, np.int32), "n_graphs": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gnn_batch_from_arrays(arrays)
    batch = convert.gnn_batch_from_arrays(arrays, device="cpu")
    for cfg, init, forward, module in (
            (gin_tu.reduced_config(), gnn.gin_init, gnn.gin_forward, gnn.GIN),
            (egnn.reduced_config(), gnn.egnn_init, gnn.egnn_forward, gnn.EGNN),
            (nequip.reduced_config(), gnn.nequip_init, gnn.nequip_forward,
             gnn.NequIP)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module(cfg)
        params = init(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            forward(params, batch, cfg)
        kind = {gnn.GIN: "gin", gnn.EGNN: "egnn", gnn.NequIP: "nequip"}[module]
        arrays_p = pytree.tree_map(lambda t: t.numpy(), params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.gnn_params_from_arrays(kind, arrays_p, cfg)
        out = forward(params, batch, cfg, device="cpu")
        assert pytree.leaves(out)[0].device.type == "cpu"


def test_lm_entry_points_and_drivers_without_card_raise(no_card, tmp_path,
                                                        monkeypatch):
    """The language models (init, forward, prefill, decode, loss, the
    module, the cache, the converters) and both drivers want the card
    unless told otherwise, and raise before they draw a weight; with
    ``device="cpu"`` / ``--device cpu`` they run."""
    from repro_torch import profile_lm
    from repro_torch.configs import smollm_135m
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as tf
    cfg = smollm_135m.reduced_config()
    drew = []
    orig = tf._normal_into
    monkeypatch.setattr(tf, "_normal_into",
                        lambda *a, **k: drew.append(1) or orig(*a, **k))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_lm.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_cache(cfg, 1, 4)
    assert not drew
    params = tf.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    arrays = pytree.tree_map(lambda t: t.numpy(), params)
    for call in (lambda: tf.forward(params, toks, cfg),
                 lambda: tf.prefill(params, toks, cfg),
                 lambda: tf.decode_step(params, cache, toks[:, 0],
                                        torch.zeros(1, dtype=torch.int32), cfg),
                 lambda: tf.loss_fn(params, {"tokens": toks, "labels": toks},
                                    cfg),
                 lambda: convert.lm_params_from_arrays(arrays, cfg),
                 lambda: convert.lm_cache_from_arrays(
                     {k: v.numpy() for k, v in cache.items()})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    logits, _ = tf.prefill(params, toks, cfg, device="cpu")
    assert logits.device == torch.device("cpu")
    out = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                      "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    assert out.shape == (1, 2)
    losses = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                         "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert len(losses) == 1
