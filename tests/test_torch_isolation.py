"""The port stands alone: it imports neither JAX nor the JAX package, and
without a card its entry points raise instead of running on the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, graph500, profile_graph500
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
    assert {"src/repro_torch/core/sssp.py",
            "src/repro_torch/core/multi_sssp.py",
            "src/repro_torch/configs/sssp_graph500.py",
            "src/repro_torch/models/gnn.py",
            "src/repro_torch/configs/gcn_cora.py"} <= names
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
        convert.gcn_batch_from_arrays({k: v.numpy() for k, v in batch.items()
                                       if k != "tiled"})
    assert repro_torch.gcn_forward(params, batch, cfg, device="cpu").shape == \
        (csr.n, cfg.n_classes)
