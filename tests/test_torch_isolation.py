"""The port stands alone: no file of ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package, and entry points with
no device ask for CUDA and raise without it."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for base, _, names in os.walk(pkg):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    scanned = {os.path.relpath(f, os.path.join(ROOT, "src", "repro_torch"))
               for f in files}
    assert {"obs/metrics.py", "obs/trace.py", "obs/__init__.py",
            "obs/export.py", "serving/admission.py", "serving/server.py",
            "serving/service.py", "core/tradeoff.py",
            "launch/serve.py", "core/baselines.py", "core/mlp.py",
            "examples/quickstart.py", "distrib/__init__.py",
            "distrib/collectives.py", "distrib/sharding.py",
            "launch/mesh.py", "configs/paper_retrieval.py",
            "configs/deepseek_v3_671b.py", "examples/serve_retrieval.py",
            "examples/recsys_funnel.py", "examples/train_lm.py",
            "launch/train.py", "models/transformer.py",
            "data/graph_data.py", "models/sampler.py", "models/gnn.py",
            "configs/graphsage_reddit.py", "examples/gnn_sage.py",
            "analysis/__init__.py", "analysis/__main__.py",
            "analysis/astutil.py", "analysis/findings.py",
            "analysis/hostsync.py", "analysis/locks.py",
            "analysis/sanitizers.py"} <= scanned
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.core import experiment, mlp
    from repro_torch.device import resolve_device
    from repro_torch.configs import deepseek_v3_671b
    from repro_torch.examples import (quickstart, recsys_funnel,
                                      serve_retrieval, train_lm)
    from repro_torch.launch import train
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import pipeline
    from repro_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    cfg = pipeline.ServingConfig(knob="rho", cutoffs=(8, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiment.build_system(experiment.ExperimentConfig(
            n_docs=50, vocab=80, n_queries=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--n-docs", "50", "--n-queries", "4", "--census", ""])
    for driver in (quickstart, serve_retrieval, recsys_funnel, train_lm):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            driver.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "deepseek-v3-671b", "--ckpt-dir", ""])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp.train_mlp(np.zeros((4, 2), np.float32), np.zeros(4),
                      n_classes=2)
    lm = tinyllama_1_1b.smoke_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_params(lm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_cache(lm, 2, 8)
    mla = deepseek_v3_671b.smoke_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_params(mla)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_cache(mla, 2, 8)


def test_gnn_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import convert
    from repro_torch.configs import graphsage_reddit
    from repro_torch.examples import gnn_sage
    from repro_torch.models import gnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = graphsage_reddit.smoke_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn_sage.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn.init_sage(cfg)
    numpy_params = gnn.init_sage(cfg, abstract=True)
    numpy_params["layers"] = [
        {k: np.zeros(v.shape, np.float32) for k, v in lp.items()}
        for lp in numpy_params["layers"]]
    for k in ("head", "graph_head"):
        numpy_params[k] = np.zeros(numpy_params[k].shape, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.sage_from_numpy(numpy_params)
    assert gnn.init_sage(cfg, device="cpu")["head"].device.type == "cpu"
