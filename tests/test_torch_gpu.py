"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the serving path on the card against the CPU.

Every test here carries the ``gpu`` marker and skips (in the
``cuda_device`` fixture) where no card is present.  The file imports no
JAX, so it also runs on a machine that has only the port's stack:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: exact.  Impacts are integer-valued and top-k is a selection;
the tiny serving system below has no two pool docs whose stage-2 scores
are within float32 rounding of each other, so ranked lists are equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cascade, experiment, labeling
from repro_torch.kernels.impact_scan import kernel as is_kernel
from repro_torch.kernels.topk import kernel as tk_kernel
from repro_torch.retrieval.index import block_doc_bounds
from repro_torch.serving import pipeline


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,nd,bp,bd", [
    (6, 700, 3000, 128, 512), (3, 65, 40, 32, 16), (2, 4096, 50_000,
                                                    512, 2048)])
def test_impact_scan_cuda_matches_plain(cuda_device, q, p, nd, bp, bd):
    r = np.random.default_rng(q + p)
    docs = r.integers(-1, nd, (q, p)).astype(np.int32)
    imps = r.integers(0, 256, (q, p)).astype(np.float32)
    rho = np.array([0, 1, p // 2, p + 50, p, 7][:q], np.int32)
    d, i, rv = (torch.from_numpy(a).to(cuda_device) for a in (docs, imps, rho))
    seg = block_doc_bounds(d, block_p=bp, n_docs=nd)
    before = is_kernel.n_launches
    out, cnt = is_kernel.impact_scan(d, i, rv, *seg, n_docs=nd, block_p=bp,
                                     block_d=bd, with_stats=True)
    assert is_kernel.n_launches == before + 1
    ref, rcnt = is_kernel.impact_scan_plain(d, i, rv, *seg, n_docs=nd,
                                            block_p=bp, block_d=bd,
                                            with_stats=True)
    assert torch.equal(out, ref) and torch.equal(cnt, rcnt)


@pytest.mark.gpu
@pytest.mark.parametrize("kp,bn", [(1, 4096), (100, 4096), (128, 1024),
                                   (3, 2)])
def test_block_topk_cuda_matches_plain(cuda_device, kp, bn):
    s = np.round(np.random.default_rng(kp).normal(size=(4, 9001)) * 4)
    s = torch.from_numpy(s.astype(np.float32)).to(cuda_device)
    before = tk_kernel.n_launches
    kv, ki = tk_kernel.block_topk(s, kp=kp, block_n=bn)
    assert tk_kernel.n_launches == before + 1
    pv, pi = tk_kernel.block_topk_plain(s, kp=kp, block_n=bn)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_serve_batch_on_card_matches_cpu(cuda_device, knob):
    sys_ = experiment.build_system(experiment.ExperimentConfig(
        n_docs=1500, vocab=4000, n_queries=96, stream_cap=256,
        pool_depth=400, gold_depth=100, query_batch=48, seed=3),
        device=cuda_device)
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    med = experiment.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
    labels = labeling.envelope_labels(med, 0.05).numpy()
    casc = cascade.train_cascade(sys_.features, labels, n_cutoffs=len(cuts),
                                 forest_kwargs=dict(n_trees=5, max_depth=4),
                                 device=cuda_device)
    cfg = pipeline.ServingConfig(knob=knob, cutoffs=cuts, rerank_depth=30,
                                 stream_cap=256)
    gpu = pipeline.RetrievalServer(sys_.index, casc, cfg, device=cuda_device)
    cpu = pipeline.RetrievalServer(sys_.index.to("cpu"), casc.to("cpu"), cfg,
                                   device="cpu")
    qt = sys_.queries.terms[:37]
    before = is_kernel.n_launches
    a = gpu.serve_batch(qt)
    assert is_kernel.n_launches == before + 1
    b = cpu.serve_batch(qt)
    np.testing.assert_array_equal(a["classes"], b["classes"])
    np.testing.assert_array_equal(a["ranked"], b["ranked"])
    np.testing.assert_array_equal(a["ranked"],
                                  gpu.serve_batch_reference(qt)["ranked"])
