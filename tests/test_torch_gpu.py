"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the serving path and the recsys funnel on the card against
the CPU, and the service's threads on the card against its inline mode.

Every test here carries the ``gpu`` marker and skips (in the
``cuda_device`` fixture) where no card is present.  The file imports no
JAX, so it also runs on a machine that has only the port's stack:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances, with their reasons:
  * impact_scan and topk: exact.  Impacts are integer-valued and top-k
    is a selection; the tiny serving system below has no two pool docs
    whose stage-2 scores are within float32 rounding of each other, so
    ranked lists are equal.
  * flash_attention: 2e-5 in float32, 2e-2 in bfloat16 (against the
    plain softmax: exp and the order of sums differ; the tensor-core
    route also casts P to bfloat16 for P.V, as the reference model path
    does).
  * embedding_bag: bit-equal, in float32 and in bfloat16; the kernel and
    its plain version both add the slots left to right, a bfloat16 sum
    rounded after every add.
  * retrieve_topk's selection (``top_k``) at the funnel's 1 M width:
    ids and value bits equal to the CPU's.
  * run_methods on the card: labels, predictions and table equal to the
    CPU's (host-fitted forests, trees added in the same order); an MLP
    cascade's classes on the card equal its classes on the CPU from the
    same parameters, except where a node's probability lies within 1e-6
    of the threshold (float32 products in another order), left out.
  * funnel: classes and k equal; ranked lists equal except where two
    items' stage-2 scores lie within 1e-5 (float32 products in another
    order on the card than on the CPU).
  * the continuous scheduler on the card: ranked lists equal to one
    batch-once ``engine.serve`` of the stream on the card (chunked sums
    of integer-valued impacts are exact), threaded equal to inline; a
    request served while predictor versions are published beside the
    traffic gets the classes of the version it reports.
  * training: BST's gradients through the kernel within 2e-5 of each
    leaf's largest magnitude of the plain attention's (float32 sums in
    another order); two identical wide-deep steps bit-equal (the
    gathers' backward adds duplicate ids in a fixed order).
  * LM serving at smoke size (float32): prefill and 8 greedy decode
    steps on the card against the CPU, greedy tokens equal and logits
    within 2e-5 (``tests/test_torch_lm.py``'s float32 tolerance: the
    kernel's and the products' sums run in another order); deepseek's
    MLA among them, launching no flash.
  * LM training at smoke size (float32): the loss within 2e-5 relative
    and each gradient leaf within 2e-5 of its largest magnitude, card
    against CPU; the blocked flash backward against the whole-matrix
    one on the card within 2e-5 (float32) or 2^-7 (bfloat16: float32
    sums in another order, rounded to bfloat16 at the end) of each
    gradient's largest magnitude.
  * GraphSAGE at smoke size (float32): a blocks step's loss within 1e-5
    relative and each gradient within rtol 1e-4 / atol 1e-6, card
    against CPU fed the same blocks (tests/test_torch_gnn.py's
    tolerances against the JAX package: products and sums in another
    order); two runs of the step on the card bit-equal (fixed-order
    segment sums, integer-valued degree counts).
  * the sync sanitizer: ``no_syncs`` fails an ``.item()`` of a CUDA
    tensor and passes an elementwise op.
  * the engine's program cache (CUDA graphs): replayed ranked lists
    equal eager calls of the same stage functions bit for bit (the same
    kernels on the same inputs); a live scheduler state is bit-unchanged
    by a warmup mid-flight; a replay counts the launches an eager run
    does.  The same holds for the sharded engine's six programs and the
    sharded scheduler's four, over meshes laid on the card.
  * the decode programs (CUDA graphs of ``decode_step``): tokens, logits
    and the cache bit-equal to eager ``decode_step`` at each step, with
    the program built in the middle of the generation (the same kernels
    on the same inputs; the build's eager run writes the slot the replay
    writes again).
  * the funnel's programs (CUDA graphs of ``_stage_funnel``): ranked
    lists bit-equal to eager calls of the stage function (the same
    kernels on the same inputs); flash_attention counted at a replay
    only.  ``top_k`` at (128, 1 M) with planted boundary ties: ids equal
    to the keyed selection's (a selection: exact).
"""

import contextlib
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import cascade, experiment, labeling
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.impact_scan import kernel as is_kernel
from repro_torch.kernels.topk import kernel as tk_kernel
from repro_torch.kernels.topk.edge_scores import KINDS, edge_scores
from repro_torch.models import layers
from repro_torch.models.recsys import bst, retrieval_tower
from repro_torch.retrieval.index import block_doc_bounds
from repro_torch.serving import admission, funnel, pipeline, service


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    layers.full_fp32_matmul()
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
@pytest.mark.parametrize("q,nd,bd", [
    (6, 120_000, 2048),     # three doc tiles a query, each re-reads
    (6, 120_000, 777),      # stats tiles that straddle the doc tiles
    (128, 50_000, 2048),    # the serving shape: one block a query
])
def test_impact_scan_cuda_wide_and_serving(cuda_device, q, nd, bd):
    p, bp = 4096, 512
    r = np.random.default_rng(nd + bd)
    docs = r.integers(-1, nd, (q, p)).astype(np.int32)
    imps = r.integers(0, 256, (q, p)).astype(np.float32)
    docs[2], imps[2] = -1, -1.0                   # a row of padding only
    rho = np.resize(np.array([0, 1, p // 2, p, p + 50, p], np.int32), q)
    d, i, rv = (torch.from_numpy(a).to(cuda_device) for a in (docs, imps, rho))
    seg = block_doc_bounds(d, block_p=bp, n_docs=nd)
    out, cnt = is_kernel.impact_scan(d, i, rv, *seg, n_docs=nd, block_p=bp,
                                     block_d=bd, with_stats=True)
    ref, rcnt = is_kernel.impact_scan_plain(d, i, rv, *seg, n_docs=nd,
                                            block_p=bp, block_d=bd,
                                            with_stats=True)
    assert torch.equal(out, ref) and torch.equal(cnt, rcnt)
    assert not out[0].any() and not out[2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("q,nd,bd", [
    (2, 2 ** 31 - 8, 2 ** 30 + 5),   # n_docs + block_d passes 2**31
    (2, 2 ** 30 + 8, 1),             # Q * n_doc_blocks passes 2**31
])
def test_impact_scan_cuda_stats_past_int32(cuda_device, q, nd, bd):
    """The stats' tile bounds and offsets past 2**31 (each case holds
    about 17 GB on the card): two posting blocks of two postings, each
    over a narrow doc range, one at each end of the collection."""
    docs = [10, 12, nd - 3, nd - 1]
    imps = [5.0, 4.0, 3.0, 2.0]
    rho = [4, 2]                     # both posting blocks, the first only
    d = torch.tensor([docs] * q, dtype=torch.int32, device=cuda_device)
    i = torch.tensor([imps] * q, device=cuda_device)
    rv = torch.tensor(rho[:q], dtype=torch.int32, device=cuda_device)
    seg = block_doc_bounds(d, block_p=2, n_docs=nd)
    out, cnt = is_kernel.impact_scan(d, i, rv, *seg, n_docs=nd, block_p=2,
                                     block_d=bd, with_stats=True)
    for row in range(q):
        want = {}
        for b in range(rho[row] // 2):
            for tile in range(docs[2 * b] // bd, docs[2 * b + 1] // bd + 1):
                want[tile] = want.get(tile, 0) + 1
        assert int(cnt[row].sum(dtype=torch.int64)) == sum(want.values())
        assert all(int(cnt[row, t]) == v for t, v in want.items())
        live = slice(0, rho[row])
        assert float(out[row].sum(dtype=torch.float64)) == sum(imps[live])
        assert all(float(out[row, doc]) == imp
                   for doc, imp in zip(docs[live], imps[live]))
    del out, cnt
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("nd", [0, 2 ** 31])
def test_impact_scan_cuda_rejects_n_docs(cuda_device, nd):
    """Doc ids are int32: the kernel takes 1 <= n_docs < 2**31."""
    d = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    i = torch.ones((2, 8), device=cuda_device)
    rv = torch.full((2,), 8, dtype=torch.int32, device=cuda_device)
    seg = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="n_docs"):
        is_kernel.impact_scan(d, i, rv, seg, seg, n_docs=nd, block_p=8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kp,bn", [
    ("rounded_normal", 1, 4096), ("rounded_normal", 100, 4096),
    ("rounded_normal", 128, 1024), ("rounded_normal", 3, 2)]
    + [(kind, 100, bn) for kind in KINDS for bn in (4096, 32_768)])
def test_block_topk_cuda_matches_plain(cuda_device, kind, kp, bn):
    if kind == "rounded_normal":
        s = np.round(np.random.default_rng(kp).normal(size=(4, 9001)) * 4)
    else:
        s = edge_scores(kind, 4, 50_000, seed=bn)
    s = torch.from_numpy(s.astype(np.float32)).to(cuda_device)
    before = tk_kernel.n_launches
    kv, ki = tk_kernel.block_topk(s, kp=kp, block_n=bn)
    assert tk_kernel.n_launches == before + 1
    pv, pi = tk_kernel.block_topk_plain(s.cpu(), kp=kp, block_n=bn)
    assert torch.equal(ki.cpu(), pi)
    # bit for bit: a -0.0 comes out as -0.0
    assert torch.equal(kv.cpu().view(torch.int32), pv.view(torch.int32))


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


def _card_server(cuda_device, knob, mesh=None, kind="forest", **cfg_kw):
    """A tiny system's server on the card (over ``mesh``, if given; the
    ``ServingConfig`` takes ``cfg_kw``; ``kind`` the cascade's nodes) and
    37 of its queries."""
    sys_ = experiment.build_system(experiment.ExperimentConfig(
        n_docs=1500, vocab=4000, n_queries=96, stream_cap=256,
        pool_depth=400, gold_depth=100, query_batch=48, seed=3),
        device=cuda_device)
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    med = experiment.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
    labels = labeling.envelope_labels(med, 0.05).numpy()
    casc = cascade.train_cascade(sys_.features, labels, n_cutoffs=len(cuts),
                                 kind=kind,
                                 forest_kwargs=dict(n_trees=5, max_depth=4),
                                 mlp_kwargs=dict(hidden=(16,), epochs=3,
                                                 batch=32),
                                 device=cuda_device)
    server = pipeline.RetrievalServer(
        sys_.index, casc, pipeline.ServingConfig(
            knob=knob, cutoffs=cuts, rerank_depth=30, stream_cap=256,
            **cfg_kw), device=cuda_device, mesh=mesh)
    return server, sys_.queries.terms[:37]


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_service_threaded_equals_inline_on_card(cuda_device, knob):
    """Threaded (requests queued before the workers start, so the batches
    are the FIFO chunks) equals inline, predict on a stream of its own;
    the engine's stage spans, fenced on the exec thread's stream, stay
    inside the batch's ``execute`` span (``service_ms``)."""
    server, qt = _card_server(cuda_device, knob)

    def make():
        o = obs.Observability.create()
        return o, service.RetrievalService(
            service.EngineBackend(server, query_len=qt.shape[1]),
            admission.AdmissionConfig(max_batch=16, pad_multiple=8),
            service.WarmupPolicy(census_path=None), obs=o)

    _, svc = make()
    inline = svc.serve_all(list(qt), deadline_ms=1e6)
    o, svc = make()
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc:
        threaded = [f.result(timeout=120.0) for f in futs]
    for a, b in zip(inline, threaded):
        np.testing.assert_array_equal(a["ranked"], b["ranked"])
        assert a["class"] == b["class"] and a["width"] == b["width"]
    for lo, hi in ((0, 16), (16, 32), (32, 37)):
        np.testing.assert_array_equal(
            np.stack([r["ranked"] for r in threaded[lo:hi]]),
            server.serve_batch(qt[lo:hi])["ranked"])
    spans = o.trace.spans()
    executes = {h.attrs["batch"]: h for h in spans if h.name == "execute"}
    assert len(executes) == 3
    for bseq, ex in executes.items():
        # the warmup thread's runs carry no batch
        stages = [h for h in spans if h.name.startswith("engine.")
                  and (h.attrs or {}).get("batch") == bseq]
        assert len(stages) == 4
        assert all(ex.t0 <= h.t0 and h.t1 <= ex.t1 for h in stages)
        assert sum(h.dur_ms for h in stages) <= ex.dur_ms
    assert o.trace.counts()["n_open"] == 0
    assert not svc.warmup.failed


@pytest.mark.gpu
def test_device_intervals_sit_inside_their_spans_on_card(cuda_device):
    """A running traced service on the card: each batch's predict
    program and engine stages carry their CUDA event pair's interval on
    the recorder's clock.  A stage's interval ends inside its span (the
    fence is in it), the predict program's inside the batch's predict
    span (its readback waits for it); each starts after its span began.
    Slack 0.5 ms: the anchor's clock reading may be late by the
    interpreter lock's hand-over (the benchmark's clock check measures
    the tie itself)."""
    server, qt = _card_server(cuda_device, "rho")
    o = obs.Observability.create()
    svc = service.RetrievalService(
        service.EngineBackend(server, query_len=qt.shape[1]),
        admission.AdmissionConfig(max_batch=16, pad_multiple=8),
        service.WarmupPolicy(census_path=None), obs=o)
    svc.warmup_now([8, 16])
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc:
        for f in futs:
            f.result(timeout=120.0)
    spans = o.trace.spans()
    slack = 5e-4
    for p in (h for h in spans if h.name == "predict"):
        b = p.attrs["batch"]
        mine = [h for h in spans if (h.attrs or {}).get("batch") == b]
        (prog,) = [h for h in mine if h.name == "predict.program"]
        stages = [h for h in mine if h.name.startswith("engine.")]
        assert len(stages) == 4
        assert prog.t0 - slack <= prog.attrs["dev_t0"] \
            <= prog.attrs["dev_t1"] <= p.t1 + slack
        for h in stages:
            a = h.attrs
            assert h.t0 - slack <= a["dev_t0"] <= a["dev_t1"] <= h.t1 + slack
            assert a["dev_ms"] > 0.0 and a["dev_stream"].startswith("cuda:")
    assert prog.attrs["dev_stream"] != stages[0].attrs["dev_stream"]
    assert o.trace.counts()["n_open"] == 0
    assert o.metrics.counters().get("trace.dev_dropped", 0) == 0


@pytest.mark.gpu
def test_device_timer_waits_for_nothing_on_card(cuda_device):
    """The timer's records, anchor and resolution make no call that waits
    for the card; back-to-back sleeps on one stream read as abutting
    intervals of one length, the first starting as its call began (the
    stream was idle)."""
    from repro_torch.analysis.sanitizers import no_syncs
    from repro_torch.obs import device as obs_device

    o = obs.Observability.create()
    timer = obs_device.timer(o, cuda_device)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    o.trace.watch()
    try:
        with no_syncs() as rec:
            timer.anchor()
            spans = []
            for _ in range(8):
                with o.trace.span("engine.stage1") as sp:
                    timer.call(sp, torch.cuda._sleep, int(2e6))
                spans.append(sp)
            o.trace.spans()
        assert rec.syncs == []
        torch.cuda.synchronize()
        t_done = o.trace.clock()
        o.trace.spans()
    finally:
        o.trace.unwatch()
    a = [h.attrs for h in spans]
    assert all("dev_t0" in x for x in a)
    assert spans[0].t0 - 1e-4 <= a[0]["dev_t0"] <= spans[0].t1 + 1e-4
    assert a[-1]["dev_t1"] <= t_done
    ms = [x["dev_ms"] for x in a]
    assert max(ms) <= 1.1 * min(ms) and min(ms) > 0.1
    for x, y in zip(a, a[1:]):
        assert abs(y["dev_t0"] - x["dev_t1"]) <= 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,hd,causal,window,dtype", [
    (4096, 21, 4, False, None, torch.float32),    # the funnel's attention
    (8, 64, 32, True, None, torch.float32),
    (4, 256, 64, True, 16, torch.float32),
    (3, 300, 128, False, 40, torch.float32),      # ragged S, window only
    (16, 64, 32, True, None, torch.bfloat16),
    (5, 7, 8, False, None, torch.bfloat16),
])
def test_flash_attention_cuda_matches_plain(cuda_device, bh, s, hd, causal,
                                            window, dtype):
    r = np.random.default_rng(bh + s + hd)
    q, k, v = (torch.from_numpy(r.normal(size=(bh, s, hd)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(3))
    before = fa_kernel.n_launches
    out = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert fa_kernel.n_launches == before + 1
    ref = fa_kernel.flash_attention_fwd_plain(q, k, v, causal=causal,
                                              window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _hold_flash(q, k, v, causal, window):
    """One launch, a contiguous (B, S, Hq, hd) output within 2e-5 (fp32)
    or 2e-2 (bf16) of the plain version."""
    before = fa_kernel.n_launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.n_launches == before + 1
    assert out.is_contiguous() and out.dtype == q.dtype
    ref = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 use_kernel=False)
    assert out.shape == ref.shape == q.shape
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dtype", [
    (6400, 21, 8, 8, 4, False, None, torch.float32),  # BST, a served batch
    (6400, 21, 8, 8, 4, False, None, torch.bfloat16),
    (37, 32, 4, 2, 8, True, None, torch.float32),     # the short path's cap
    (37, 33, 4, 2, 8, True, None, torch.float32),     # one past: general
    (37, 32, 4, 4, 16, False, 7, torch.bfloat16),
    (37, 33, 4, 1, 16, True, 7, torch.bfloat16),
    (9, 21, 8, 2, 8, False, None, torch.float32),
    (9, 21, 8, 4, 16, True, None, torch.float32),
    (9, 17, 8, 8, 4, True, 3, torch.bfloat16),
    (3, 5, 6, 3, 4, False, 2, torch.float32),
])
def test_flash_attention_cuda_model_layout(cuda_device, b, s, hq, hkv, hd,
                                           causal, window, dtype):
    r = np.random.default_rng(b + s + hq + hd)
    q = torch.from_numpy(r.normal(size=(b, s, hq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(r.normal(size=(b, s, hkv, hd)).astype(
        np.float32)) for _ in range(2))
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    _hold_flash(q, k, v, causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,route", [
    ("batch_stride", "short_bulk"),     # batch stride 2 S H hd
    ("sliced_batch", "short_bulk"),     # x[1:], rows still aligned
    ("transposed", "short_loads"),      # (B, H, S, hd) storage
    ("head_slice", "short_loads"),      # hd 4 of a wider last axis
    ("broadcast", "short_loads"),       # k, v heads expanded, stride 0
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_strided(cuda_device, kind, route, dtype):
    b, s, h, hd = 301, 21, 8, 4
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    if kind == "batch_stride":
        q, k, v = (randn(2 * b, s, h, hd)[::2] for _ in range(3))
    elif kind == "sliced_batch":
        q, k, v = (randn(b + 1, s, h, hd)[1:] for _ in range(3))
    elif kind == "transposed":
        q, k, v = (randn(b, h, s, hd).transpose(1, 2) for _ in range(3))
    elif kind == "head_slice":
        q, k, v = (randn(b, s, h, 2 * hd)[..., hd:] for _ in range(3))
    else:
        q = randn(b, s, h, hd)
        k, v = (randn(b, s, 1, hd).expand(b, s, h, hd) for _ in range(2))
    _hold_flash(q, k, v, causal=kind == "transposed", window=None)
    assert fa_kernel.last_route == route


@pytest.mark.gpu
@pytest.mark.parametrize("make,route", [
    (lambda z: (z(6, 21, 8, 4),) * 3, "short_bulk"),        # BST's layout
    (lambda z: (z(6, 21, 8, 4)[::2], z(6, 21, 8, 4)[1::2],
                z(6, 21, 8, 4)[:3]), "short_bulk"),           # batch steps
    (lambda z: (z(6, 8, 21, 4).transpose(1, 2), z(6, 21, 8, 4),
                z(6, 21, 8, 4)), "short_loads"),
    (lambda z: (z(6, 21, 8, 4), z(6, 21, 8, 8)[..., :4],
                z(6, 21, 8, 4)), "short_loads"),             # head slice
    (lambda z: (z(6, 21, 8, 4), z(6, 21, 1, 4).expand(6, 21, 8, 4),
                z(6, 21, 1, 4).expand(6, 21, 8, 4)), "short_loads"),
    (lambda z: (z(6, 21, 8, 4), z(6, 21, 2, 4), z(6, 21, 2, 4)),
     "short_bulk"),                                           # GQA
    (lambda z: (z(2, 5, 3, 4, dtype=torch.bfloat16),) * 3,
     "short_loads"),                                          # 120-byte rows
    (lambda z: (z(2, 32, 4, 16),) * 3, "short_bulk"),         # the caps
    (lambda z: (z(2, 33, 4, 16),) * 3, "general"),
    (lambda z: (z(2, 21, 8, 32),) * 3, "general"),
    (lambda z: (z(2, 32, 64, 16),) * 3, "general"),           # rows > 32 KB
    (lambda z: (z(2, 40, 4, 16), z(2, 40, 4, 17)[..., 1:],
                z(2, 40, 4, 17)[..., 1:]), "general"),        # K/V at 4 bytes
])
def test_flash_attention_cuda_route(cuda_device, make, route):
    """The launcher's choice of path: the bulk copies need each batch row
    of q, k and v to be one 16-byte aligned span a multiple of 16 bytes
    long, and a 16-byte aligned batch stride."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)

    def z(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * shape[-1] ** -0.25).to(dtype)

    q, k, v = make(z)
    _hold_flash(q, k, v, causal=False, window=None)
    assert fa_kernel.last_route == route


@pytest.mark.gpu
@pytest.mark.parametrize("v,d,b,l,mean", [
    (100_000, 32, 1024, 8, False), (1000, 32, 777, 1, False),
    (5000, 64, 300, 7, True), (300, 5, 90, 4, True), (50, 200, 33, 3, False),
])
def test_embedding_bag_cuda_matches_plain(cuda_device, v, d, b, l, mean):
    r = np.random.default_rng(v + d + l)
    table = torch.from_numpy(r.normal(size=(v, d)).astype(np.float32)).to(
        cuda_device)
    ids = r.integers(-1, v, (b, l)).astype(np.int32)
    ids[::7] = -1                                 # bags of padding only
    ids = torch.from_numpy(ids).to(cuda_device)
    before = eb_kernel.n_launches
    out = eb_kernel.embedding_bag_kernel(table, ids, mean=mean)
    assert eb_kernel.n_launches == before + 1
    ref = eb_ref.embedding_bag_ref(table, ids, mean=mean)
    assert torch.equal(out, ref)
    assert not out[::7].any()


@pytest.mark.gpu
@pytest.mark.parametrize("v,d,b,l,mean", [
    (100_000, 32, 1024, 8, False), (5000, 64, 300, 7, True),
    (300, 5, 90, 4, True), (50, 200, 33, 3, False), (1000, 8, 77, 20, True),
])
def test_embedding_bag_cuda_bfloat16_matches_plain(cuda_device, v, d, b, l,
                                                   mean):
    r = np.random.default_rng(v + d + l)
    table = torch.from_numpy(r.normal(0, d ** -0.5, (v, d)).astype(
        np.float32)).to(device=cuda_device, dtype=torch.bfloat16)
    ids = r.integers(-1, v, (b, l)).astype(np.int32)
    ids[::7] = -1
    ids = torch.from_numpy(ids).to(cuda_device)
    before = eb_kernel.n_launches
    out = eb_kernel.embedding_bag_kernel(table, ids, mean=mean)
    assert eb_kernel.n_launches == before + 1
    assert out.dtype == torch.bfloat16
    ref = eb_ref.embedding_bag_ref(table, ids, mean=mean)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert not out[::7].any()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        eb_kernel.embedding_bag_kernel(table.half(), ids)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 100, 1000])
def test_top_k_cuda_boundary_ties_at_the_funnel_width(cuda_device, k):
    """1 M candidates a row, the k-th score tied many times over, and
    mixed-sign zeros: the card selects what the CPU selects."""
    r = np.random.default_rng(k)
    scores = np.round(r.normal(size=(4, 1_000_000)) * 3).astype(np.float32)
    scores[1] = np.where(r.random(1_000_000) < 0.5, 0.0, -0.0)
    scores[1, 7] = 1.0
    scores[2, :] = 1.0
    scores[2, 123_456] = 2.0
    scores[3] = r.normal(size=1_000_000)
    # rows 0-2 tie at the k-th score (the keyed selection); row 3 alone
    # has no tie (the float32 selection)
    for rows in (slice(0, 4), slice(3, 4)):
        got = retrieval_tower.top_k(
            torch.from_numpy(scores[rows]).to(cuda_device), k)
        want = retrieval_tower.top_k(torch.from_numpy(scores[rows]), k)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu().view(torch.int32),
                           want[1].view(torch.int32))
    assert want[0][0, :3].tolist() == retrieval_tower.top_k(
        torch.from_numpy(scores), k)[0][3, :3].tolist()
    assert retrieval_tower.top_k(torch.from_numpy(scores[2:3]), k)[0][
        0, :3].tolist() == [123_456, 0, 1][:k]


@pytest.mark.gpu
def test_service_reset_stats_and_handoff_depth_on_card(cuda_device):
    server, qt = _card_server(cuda_device, "rho")
    svc = service.RetrievalService(
        service.EngineBackend(server, query_len=qt.shape[1]),
        admission.AdmissionConfig(max_batch=16, pad_multiple=8),
        service.WarmupPolicy(census_path=None))
    svc.warmup_now([16])
    warm = svc.serve_all(list(qt[:16]), deadline_ms=1e6)
    svc.reset_stats()
    assert svc.stats().n_queries == 0 and svc.stats().latencies_ms == []
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc:
        got = [f.result(timeout=120.0) for f in futs]
    stats = svc.stats()
    assert stats.n_queries == len(qt) and len(stats.service_ms) == 3
    for a, b in zip(warm, got):
        np.testing.assert_array_equal(a["ranked"], b["ranked"])


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_run_methods_on_card_matches_cpu(cuda_device, knob):
    cfg = experiment.ExperimentConfig(
        n_docs=1500, vocab=4000, n_queries=96, stream_cap=256,
        pool_depth=400, gold_depth=100, query_batch=48, seed=3)
    sys_ = experiment.build_system(cfg, device=cuda_device)
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    med = experiment.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
    kw = dict(tau=0.05, n_folds=3, forest_kwargs=dict(n_trees=6,
                                                      max_depth=5))
    gpu = experiment.run_methods(sys_, med, cuts, **kw)
    cpu_sys = dataclasses.replace(sys_, index=sys_.index.to("cpu"))
    cpu = experiment.run_methods(cpu_sys, med, cuts, **kw)
    np.testing.assert_array_equal(gpu.labels, cpu.labels)
    for name, pred in cpu.preds.items():
        np.testing.assert_array_equal(gpu.preds[name], pred)
    assert gpu.table == cpu.table
    # tuned thresholds and Algorithm 2 on the card, an MLP cascade
    casc = cascade.train_cascade(sys_.features[:64], gpu.labels[:64],
                                 n_cutoffs=len(cuts), device=cuda_device,
                                 forest_kwargs=dict(n_trees=6, max_depth=5))
    tv = cascade.tune_thresholds(casc, sys_.features[64:], med[64:], cuts,
                                 0.05)
    assert torch.equal(
        cascade.predict_batched(casc, torch.from_numpy(
            sys_.features[64:]).to(cuda_device), tv).cpu(),
        cascade.predict_batched(casc.to("cpu"),
                                torch.from_numpy(sys_.features[64:]), tv))
    x = torch.from_numpy(sys_.features)
    batched = cascade.predict_batched(casc, x.to(cuda_device), 0.8).cpu()
    for i in range(32):
        assert cascade.predict_sequential(casc, sys_.features[i],
                                          0.8) == batched[i]
    mlp = cascade.train_cascade(sys_.features, gpu.labels,
                                n_cutoffs=len(cuts), kind="mlp",
                                mlp_kwargs=dict(epochs=3, batch=32),
                                device=cuda_device)
    p_gpu = mlp.proba0(x.to(cuda_device)).cpu()
    p_cpu = mlp.to("cpu").proba0(x)
    assert torch.allclose(p_gpu, p_cpu, rtol=1e-5, atol=1e-6)
    near = ((p_gpu - 0.8).abs() <= 1e-6).any(dim=1)
    got = cascade.classes_from_proba(p_gpu, 0.8)
    want = cascade.classes_from_proba(p_cpu, 0.8)
    assert torch.equal(got[~near], want[~near])


@pytest.mark.gpu
def test_funnel_on_card_matches_cpu(cuda_device):
    tcfg = retrieval_tower.TowerConfig(d_user_in=16, embed_dim=16,
                                       hidden=(32,), n_candidates=5000)
    bcfg = bst.BSTConfig(embed_dim=16, seq_len=8, n_heads=4, item_vocab=5000,
                         n_profile=4, mlp=(64, 32))
    cfg = funnel.FunnelConfig(tower=tcfg, bst=bcfg, pool_depth=1000,
                              eval_depth=30)
    tower = retrieval_tower.init_tower(tcfg, seed=0, device="cpu")
    model = bst.init_bst(bcfg, seed=1, device="cpu")
    r = np.random.default_rng(0)
    uf = r.normal(size=(96, 16)).astype(np.float32)
    hist = r.integers(0, 5000, (96, 8)).astype(np.int32)
    hist[np.arange(8)[None, :] >= r.integers(1, 9, (96, 1))] = -1
    gold, runs = funnel.funnel_gold_runs(cfg, tower, model, uf, hist)
    labels, _ = funnel.label_requests(cfg, gold, runs)
    feats = funnel.request_features(torch.from_numpy(uf),
                                    torch.from_numpy(hist)).numpy()
    casc = cascade.train_cascade(feats[:64], labels[:64],
                                 n_cutoffs=len(cfg.cutoffs),
                                 forest_kwargs=dict(n_trees=5, max_depth=4),
                                 device="cpu")
    cpu = funnel.Funnel(cfg, tower, model, casc, device="cpu")
    gpu = funnel.Funnel(cfg, tower, model, casc, device=cuda_device)
    before = fa_kernel.n_launches
    a = gpu.serve(uf[64:], hist[64:])
    assert fa_kernel.n_launches == before + bcfg.n_blocks
    b = cpu.serve(uf[64:], hist[64:])
    np.testing.assert_array_equal(a["classes"], b["classes"])
    np.testing.assert_array_equal(a["k"], b["k"])
    _assert_funnel_ranked(gpu, uf[64:], hist[64:], a, b)
    # classes spread over every cutoff: the card against the CPU and
    # against each request executed alone on the card
    classes = np.arange(32) % (len(cfg.cutoffs) + 1)
    a = gpu.execute(uf[64:], hist[64:], classes)
    assert set(a["k"].tolist()) == set(cfg.cutoffs)
    _assert_funnel_ranked(gpu, uf[64:], hist[64:], a,
                          cpu.execute(uf[64:], hist[64:], classes))
    alone = {"ranked": np.concatenate([
        gpu.execute(uf[64 + q:65 + q], hist[64 + q:65 + q],
                    classes[q:q + 1])["ranked"] for q in range(32)])}
    _assert_funnel_ranked(gpu, uf[64:], hist[64:], a, alone)


def _card_funnel(cuda_device):
    """A small funnel on the card (5000 items, a pool of 1000), with a
    cascade that predicts class 0 for everything, and 64 requests."""
    tcfg = retrieval_tower.TowerConfig(d_user_in=16, embed_dim=16,
                                       hidden=(32,), n_candidates=5000)
    bcfg = bst.BSTConfig(embed_dim=16, seq_len=8, n_heads=4, item_vocab=5000,
                         n_profile=4, mlp=(64, 32))
    cfg = funnel.FunnelConfig(tower=tcfg, bst=bcfg, pool_depth=1000,
                              eval_depth=30)
    r = np.random.default_rng(28)
    uf = r.normal(size=(64, 16)).astype(np.float32)
    hist = r.integers(0, 5000, (64, 8)).astype(np.int32)
    hist[np.arange(8)[None, :] >= r.integers(1, 9, (64, 1))] = -1
    feats = funnel.request_features(torch.from_numpy(uf),
                                    torch.from_numpy(hist)).numpy()
    casc = cascade.train_cascade(feats, np.zeros(64, np.int32),
                                 n_cutoffs=len(cfg.cutoffs),
                                 forest_kwargs=dict(n_trees=2, max_depth=2),
                                 device="cpu")
    gpu = funnel.Funnel(cfg, retrieval_tower.init_tower(tcfg, seed=0,
                                                        device=cuda_device),
                        bst.init_bst(bcfg, seed=1, device=cuda_device), casc,
                        device=cuda_device)
    return gpu, uf, hist


def _eager_funnel(gpu, uf, hist, classes):
    """The ranked lists of an eager call of the stage function, as
    ``execute`` returns them."""
    ks = gpu.params_of(classes)
    _, args, kwargs = gpu.stage_call(uf, hist, ks,
                                     np.full_like(ks, max(gpu.cfg.cutoffs)))
    r = funnel._stage_funnel(*args, **kwargs).cpu().numpy()
    out = np.full((len(ks), gpu.cfg.eval_depth), -1, np.int32)
    out[:, :r.shape[1]] = r
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 32])
def test_replayed_funnel_equals_the_eager_stage_on_card(cuda_device, batch):
    """Two padded sizes x three pool widths (k 10, 50, 1000): the build's
    call and a replay give the eager stage function's lists bit for bit,
    one program a width."""
    gpu, uf, hist = _card_funnel(cuda_device)
    for top in (0, 2, 6):
        classes = (np.arange(batch) % (top + 1)).astype(np.int32)
        want = _eager_funnel(gpu, uf[:batch], hist[:batch], classes)
        for _ in range(2):
            got = gpu.execute(uf[:batch], hist[:batch], classes)
            np.testing.assert_array_equal(got["ranked"], want)
    assert gpu.n_compiles == 3
    stats = gpu.programs.stats()
    assert stats["graphs"] == 3 and stats["replays"] == 6


@pytest.mark.gpu
def test_funnel_programs_share_one_pool_on_card(cuda_device):
    """Programs at two padded sizes are captured into the cache's one
    graph pool; ``clear`` drops them, and the next call builds again and
    gives the same lists."""
    gpu, uf, hist = _card_funnel(cuda_device)
    classes = (np.arange(32) % 3).astype(np.int32)
    want = {b: gpu.execute(uf[:b], hist[:b], classes[:b])["ranked"]
            for b in (8, 32)}
    assert gpu.n_compiles == 2 and gpu.programs.pool_sizes() == [None]
    gpu.programs.clear()
    assert gpu.programs.stats()["graphs"] == 0
    assert gpu.programs.pool_sizes() == []
    for b in (8, 32):
        got = gpu.execute(uf[:b], hist[:b], classes[:b])["ranked"]
        np.testing.assert_array_equal(got, want[b])
    assert gpu.n_compiles == 4 and gpu.programs.stats()["graphs"] == 2


@pytest.mark.gpu
def test_funnel_counts_flash_launches_at_replay_only(cuda_device):
    gpu, uf, hist = _card_funnel(cuda_device)
    n_blocks = gpu.cfg.bst.n_blocks
    ks = np.full(16, 50)
    name, args, kwargs = gpu.stage_call(uf[:16], hist[:16], ks, ks)
    n0 = fa_kernel.n_launches
    prog = gpu.programs.compiled(name, funnel._stage_funnel, args, kwargs)
    assert fa_kernel.n_launches == n0          # the build counts nothing
    for i in (1, 2):
        prog(*args)
        assert fa_kernel.n_launches == n0 + i * n_blocks
    funnel._stage_funnel(*args, **kwargs)        # an eager run counts
    assert fa_kernel.n_launches == n0 + 3 * n_blocks


@pytest.mark.gpu
@pytest.mark.parametrize("k", [50, 1000])
def test_top_k_equals_the_keyed_selection_at_batch_128(cuda_device, k):
    """(128, 1 M) scores with ties planted at each row's k-th value (a
    few ids before and after the k-th's), and rows whose boundary falls
    among mixed-sign zeros."""
    r = np.random.default_rng(k)
    scores = torch.from_numpy(r.normal(size=(128, 1_000_000)).astype(
        np.float32)).to(cuda_device)
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    plant = torch.from_numpy(r.integers(0, 1_000_000, (128, 40))).to(
        cuda_device)
    scores.scatter_(1, plant, kth.expand(128, 40))
    scores[:8] = torch.where(scores[:8] > 4.0, scores[:8], torch.where(
        scores[:8] > 0, 0.0, -0.0))
    got_i, got_v = retrieval_tower.top_k(scores, k)
    want = retrieval_tower._top_k_keyed(scores, k)
    assert torch.equal(got_i, want)
    assert torch.equal(got_v.view(torch.int32),
                       scores.gather(1, want).view(torch.int32))


def _assert_funnel_ranked(gpu, uf, hist, a, b):
    """Ranked lists equal, or each differing position holds two items
    whose stage-2 scores on the card (at ``a``'s k) lie within 1e-5:
    float32 sums in another order on the two devices or batch sizes."""
    dev = gpu.device
    ids, vals = retrieval_tower.retrieve_topk(
        gpu.tower_params, gpu.cfg.tower, torch.from_numpy(uf).to(dev),
        int(a["k"].max()))
    s2 = funnel._bst_scores(gpu.bst_params, gpu.cfg.bst,
                            torch.from_numpy(hist).to(dev), ids, vals,
                            norm_width=torch.from_numpy(a["k"]).to(dev)).cpu()
    ids = ids.cpu()
    for q, i in zip(*np.nonzero(a["ranked"] != b["ranked"])):
        row = dict(zip(ids[q].tolist(), s2[q].tolist()))
        x, y = int(a["ranked"][q, i]), int(b["ranked"][q, i])
        assert x >= 0 and y >= 0 and abs(row[x] - row[y]) <= 1e-5, (q, i)


@pytest.mark.gpu
def test_impact_scan_and_topk_cuda_at_the_continuous_shapes(cuda_device):
    """The scheduler's kernel shapes: impact_scan on one (32, 512) chunk
    window over 50 000 docs with idle slots (rho 0, bounds (n_docs, -1)),
    topk on one (8, 50 000) finalize group at kp 100."""
    q, p, nd = 32, 512, 50_000
    r = np.random.default_rng(5)
    docs = r.integers(0, nd, (q, p)).astype(np.int32)
    imps = -np.sort(-r.integers(0, 256, (q, p)), axis=1).astype(np.float32)
    rho = r.integers(0, p + 1, q).astype(np.int32)
    idle = [2, 9, 30]
    docs[idle], imps[idle], rho[idle] = -1, -1.0, 0
    d, i, rv = (torch.from_numpy(a).to(cuda_device) for a in (docs, imps, rho))
    seg = block_doc_bounds(d, block_p=p, n_docs=nd)
    assert (seg[0][idle] == nd).all() and (seg[1][idle] == -1).all()
    out = is_kernel.impact_scan(d, i, rv, *seg, n_docs=nd, block_p=p)
    assert torch.equal(out, is_kernel.impact_scan_plain(d, i, rv, *seg,
                                                        n_docs=nd, block_p=p))
    rows = out[:8].contiguous()
    gv, gi = tk_kernel.block_topk(rows, kp=100)
    wv, wi = tk_kernel.block_topk_plain(rows, kp=100)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_continuous_on_card_equals_batch_once(cuda_device, knob):
    """The continuous scheduler on the card: every list equals one
    ``engine.serve`` of the stream on the card, impact_scan launches
    equal the chunk dispatches (topk the rho finalizes; k's pool is
    wider than KP_MAX), and the tick thread equals the inline run."""
    server, qt = _card_server(cuda_device, knob)
    classes = server.predict_classes(qt)
    ref, _ = server.engine.serve(qt, server.params_of(classes))

    def run(threaded):
        backend = service.ContinuousBackend(server, query_len=qt.shape[1],
                                            slots=16, grain=4, window=8)
        svc = service.RetrievalService(backend)
        backend.scheduler.warmup()
        n0 = (is_kernel.n_launches, tk_kernel.n_launches)
        futs = svc.submit_many(list(qt), deadline_ms=1e6)
        if threaded:
            with svc:
                out = [f.result(timeout=120.0) for f in futs]
        else:
            svc.flush()
            while svc.outstanding:
                assert svc.step()
            out = [f.result() for f in futs]
        return out, backend.scheduler.stats(), (
            is_kernel.n_launches - n0[0], tk_kernel.n_launches - n0[1])

    inline, st, (n_is, n_tk) = run(False)
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in inline]),
                                  ref)
    assert [r["class"] for r in inline] == classes.tolist()
    assert n_is == st["n_chunk_calls"] > 0
    assert n_tk == (st["n_finalize_calls"] if knob == "rho" else 0)
    threaded, _, _ = run(True)
    for a, b in zip(inline, threaded):
        np.testing.assert_array_equal(a["ranked"], b["ranked"])


@pytest.mark.gpu
def test_hot_swap_under_threaded_traffic_on_card(cuda_device):
    """Versions published (a fence on the publishing thread) and
    installed while a threaded batch-once service replays its predict
    graphs on its own stream: every request's classes are those of the
    version it reports, row for row (a batch reads one version's tables
    and reports that version), both cascades served traffic, and the
    swaps built no predict program."""
    from repro_torch.core import features
    from repro_torch.online import PredictorStore
    server, qt = _card_server(cuda_device, "rho")
    boot = server.cascade
    x = features.query_features(torch.from_numpy(qt).to(cuda_device),
                                server.stats, server.ctf, server.df)
    labels = np.random.default_rng(9).integers(0, boot.n_cutoffs + 1,
                                               qt.shape[0])
    other = cascade.train_cascade(x.cpu().numpy(), labels,
                                  n_cutoffs=boot.n_cutoffs,
                                  forest_kwargs=dict(n_trees=5, max_depth=4),
                                  device=cuda_device)
    t = server.cfg.threshold
    want = [cascade.predict_batched(c, x, t).cpu().numpy()
            for c in (boot, other)]
    assert (want[0] != want[1]).any()
    thr = [t] * boot.n_cutoffs
    store = PredictorStore(boot, thr, device=cuda_device)
    store.install(server)
    svc = service.RetrievalService(
        service.EngineBackend(server, query_len=qt.shape[1]),
        admission.AdmissionConfig(max_batch=8, pad_multiple=8),
        service.WarmupPolicy(census_path=None))
    svc.warmup_now([8])
    built = server.predict_programs.n_compiles
    results = []
    with svc:
        for v in range(1, 7):
            futs = svc.submit_many(list(qt), deadline_ms=1e6)
            store.publish(other if v % 2 else boot, thr)
            store.install(server)
            results.append([f.result(timeout=120.0) for f in futs])
    assert server.predictor_version == 6
    assert server.predict_programs.n_compiles == built
    stats = server.predict_programs.stats()
    assert stats["graphs"] == stats["programs"] > 0
    versions = set()
    for res in results:
        for i, r in enumerate(res):
            versions.add(r["predictor_version"])
            assert r["class"] == want[r["predictor_version"] % 2][i]
    assert len(versions) >= 2


#: the tiny system's slack over 4 shards: shard 0 owns up to 196 of a
#: query's 256 postings (impact ties at a term's cut keep the lowest doc
#: ids), over the default slack's slot of 128; 3.5 gives 224
CARD_SLACK = 3.5


@pytest.fixture
def card_positions(cuda_device):
    """Four mesh positions laid over the card, for one test."""
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.force_host_device_count(4)
    yield mesh_lib
    mesh_lib.force_host_device_count(0)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_sharded_engine_on_card_equals_unsharded(card_positions, knob):
    """Four shards on the card: the lists equal the unsharded engine's on
    the card, with impact_scan launched once a shard (and topk on rho,
    kl = 30; k's pool of 400 > KP_MAX takes the plain sort), and the
    continuous scheduler over the mesh equals one ``engine.serve``."""
    dev = torch.device("cuda")
    server, qt = _card_server(dev, knob)
    sharded, _ = _card_server(
        dev, knob, card_positions.make_serving_mesh(4, device=dev),
        partition_slack=CARD_SLACK)
    want = server.serve_batch(qt)
    n0 = (is_kernel.n_launches, tk_kernel.n_launches)
    got = sharded.serve_batch(qt)
    n_is, n_tk = (is_kernel.n_launches - n0[0], tk_kernel.n_launches - n0[1])
    np.testing.assert_array_equal(got["ranked"], want["ranked"])
    assert (n_is, n_tk) == (4, 4 if knob == "rho" else 0)
    classes = sharded.predict_classes(qt)
    ref, _ = sharded.engine.serve(qt, sharded.params_of(classes))
    np.testing.assert_array_equal(ref, want["ranked"])
    svc = service.RetrievalService(service.ContinuousBackend(
        sharded, query_len=qt.shape[1], slots=16, grain=4, window=8))
    res = svc.serve_all(list(qt), deadline_ms=1e6)
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]), ref)


@pytest.mark.gpu
def test_sharded_stage2_is_deterministic_on_card(card_positions):
    """Stage 2 over the compacted score streams adds term by term: two
    identical calls on the card are bit-equal, and equal the unsharded
    stage 2 on the card (one scatter over the compacted stream would add
    in atomic order)."""
    from repro_torch.serving import engine
    dev = torch.device("cuda")
    server, qt = _card_server(
        dev, "rho", card_positions.make_serving_mesh(4, device=dev),
        partition_slack=CARD_SLACK)
    e = server.engine
    group = e.groups[0]
    q = torch.from_numpy(np.pad(qt, ((0, 3), (0, 0)), constant_values=-1)
                         .astype(np.int32)).cuda()
    qids = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    rows, over, _ = engine._sh_gather(
        [sh.index + (q,) for sh in group], e._los, cap=e.cfg.stream_cap,
        shard_cap=e.shard_cap, block_p=e.block_p, width=e.shard_width,
        slack=e.cfg.partition_slack)
    assert int(over[0].max()) == 0

    def stage2():
        out = engine._sh_stage2(
            [r[5:8] + (sh.doc_len, qids) for r, sh in zip(rows, group)],
            e._los, width=e.shard_width, n_docs=e.n_docs,
            n_terms=q.shape[1])
        return torch.cat(out, dim=1)[:, :e.n_docs]

    a, b = stage2(), stage2()
    assert torch.equal(a, b)
    sdocs, s3 = engine.jass.gather_score_streams(
        e.offsets, e.pdoc, e.pscore, q, cap=e.cfg.stream_cap)
    ref = engine._stage2(sdocs, s3, e.doc_len, qids, n_docs=e.n_docs,
                         n_terms=q.shape[1])
    assert torch.equal(a, ref)


@pytest.mark.gpu
def test_bst_gradients_through_the_kernel_equal_the_plain_path(cuda_device):
    """BST at its full config (batch 256): one kernel launch in the
    forward, and every gradient leaf within 2e-5 of its largest
    magnitude of the plain attention's (float32 sums in another
    order); the attention's weights and the item table get gradients."""
    from repro_torch.configs import bst as bst_configs
    from repro_torch.data import recsys_data
    from repro_torch.tree import leaves_with_paths
    cfg = bst_configs.model_config()
    params = bst.init_bst(cfg, seed=0, device=cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             recsys_data.bst_batch(cfg, 256, 0).items()}
    flat = leaves_with_paths(params)

    def grads(use_kernel):
        for _, p in flat:
            p.requires_grad_(True)
        loss = bst.bst_loss(params, cfg, batch, use_kernel=use_kernel)
        g = torch.autograd.grad(loss, [p for _, p in flat])
        for _, p in flat:
            p.requires_grad_(False)
        return g

    before = fa_kernel.n_launches
    got = grads(True)
    assert fa_kernel.n_launches == before + 1
    want = grads(False)
    for (path, _), a, b in zip(flat, got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-5 * scale, path
        if path in (("blocks", 0, "wq"), ("blocks", 0, "wk"),
                    ("blocks", 0, "wv"), ("item_table",)):
            assert scale > 0 and float(a.abs().max()) > 0, path


@pytest.mark.gpu
def test_wide_deep_steps_on_the_card_are_bit_equal(cuda_device):
    """Two identical wide-deep smoke steps at batch 4096 (each of the 200
    ids of a field read some 20 times: the gathers' backward adds
    duplicates) give the same parameters and moments bit for bit."""
    from repro_torch.configs import wide_deep as wd_configs
    from repro_torch.data import recsys_data
    from repro_torch.launch import train
    from repro_torch.models.recsys import wide_deep
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    cfg = wd_configs.smoke_config()
    runs = []
    for _ in range(2):
        params = wide_deep.init_wide_deep(cfg, seed=0, device=cuda_device)
        opt = adamw.init_opt_state(params)
        step = train.make_step(wide_deep.wide_deep_loss, cfg,
                               adamw.AdamWConfig(lr=3e-3, weight_decay=1e-5))
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
                     recsys_data.wide_deep_batch(cfg, 4096, i).items()}
            params, opt, _ = step(params, opt, batch)
        runs.append(leaves({"params": params, "opt": opt}))
    for a, b in zip(*runs):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def _lm_serve(cfg, toks, device, steps=8):
    """Prefill of ``toks`` on ``device``, its keys and values into a
    cache of S + steps, then ``steps`` greedy decode steps: the logits
    of the prefill and of each step, and the tokens, on the CPU."""
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, seed=0, device=device)
    logits, pre = transformer.prefill(params, cfg,
                                      torch.from_numpy(toks).to(device))
    b, s = toks.shape
    cache = transformer.init_cache(cfg, b, s + steps, device=device)
    for g in pre:
        for x in pre[g]:
            cache[g][x][:, :, :pre[g][x].shape[2]] = pre[g][x]
    out = [(None, logits.cpu())]
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
        tok, lg, cache = transformer.decode_step(params, cfg, cache, tok, pos)
        out.append((tok.cpu(), lg.cpu()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("tinyllama-1.1b", 24), ("qwen2-0.5b", 24),
                                    ("qwen3-4b", 24), ("mixtral-8x22b", 32),
                                    ("deepseek-v3-671b", 24)])
def test_lm_smoke_serving_on_card_matches_cpu(cuda_device, arch, s):
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import lm_pipeline
    cfg = cfgbase.get(arch).smoke_config()
    toks = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
        vocab=cfg.vocab, batch=2, seq_len=s, seed=1)).batch(0)["tokens"]
    before = fa_kernel.n_launches
    card = _lm_serve(cfg, toks, cuda_device)
    # deepseek's MLA (value head dim 16 against 24) takes the plain path
    want = 0 if cfg.attn_type == "mla" else cfg.n_layers
    assert fa_kernel.n_launches == before + want
    for (tc, lc), (tp, lp) in zip(card, _lm_serve(cfg, toks, "cpu")):
        if tp is not None:
            assert torch.equal(tc, tp)
        torch.testing.assert_close(lc, lp, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hkv,hd", [(4, 64), (8, 128)])
def test_flash_attention_cuda_lm_shape_bf16(cuda_device, hkv, hd):
    """Causal GQA in bfloat16 at a small LM shape (tinyllama's heads at
    hd 64, qwen3-4b's at hd 128): one launch of the tensor-core route,
    within 2e-2 of the plain version."""
    r = np.random.default_rng(hd)
    q = torch.from_numpy(r.normal(size=(2, 640, 32, hd)).astype(np.float32))
    k, v = (torch.from_numpy(r.normal(size=(2, 640, hkv, hd)).astype(
        np.float32)) for _ in range(2))
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    _hold_flash(q, k, v, True, None)
    assert fa_kernel.last_route == "general_tc"


def _bf16_normal(r, *shape):
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 4, 7, 8])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 200, 640])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_cuda_tensor_core_route(cuda_device, hd, s, g):
    """The tensor-core route at ragged S (one key, either side of the 64-
    row warpgroup and the 128-key tile, several tiles), every GQA group
    (g = 7: qwen2-0.5b's 14 / 2 heads), causal, non-causal and windowed
    (a window inside one tile and one across tiles): each call one
    launch of ``general_tc`` within 2e-2 of the plain version."""
    r = np.random.default_rng(hd + s + g)
    hkv = 1 if g == 8 else 2
    q = _bf16_normal(r, 2, s, g * hkv, hd)
    k, v = (_bf16_normal(r, 2, s, hkv, hd) for _ in range(2))
    for causal, window in ((True, None), (False, None), (True, 16),
                           (False, 100)):
        _hold_flash(q, k, v, causal, window)
        assert fa_kernel.last_route == "general_tc", (causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kind", ["fused", "batch_stride"])
def test_flash_attention_cuda_tensor_core_strides(cuda_device, hd, kind):
    """The tensor-core route reads strided operands in place: q, k and v
    as slices of one fused (B, S, Hq + 2 Hkv, hd) projection, and every
    operand with a batch stride past S H hd."""
    r = np.random.default_rng(hd)
    b, s, hq, hkv = 3, 200, 8, 2
    if kind == "fused":
        x = _bf16_normal(r, b, s, hq + 2 * hkv, hd)
        q, k, v = x[:, :, :hq], x[:, :, hq:hq + hkv], x[:, :, hq + hkv:]
    else:
        q = _bf16_normal(r, 2 * b, s, hq, hd)[::2]
        k, v = (_bf16_normal(r, b + 1, s, hkv, hd)[1:] for _ in range(2))
    _hold_flash(q, k, v, True, None)
    assert fa_kernel.last_route == "general_tc"
    _hold_flash(q, k, v, False, 16)
    assert fa_kernel.last_route == "general_tc"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32", "hd32", "head_slice",
                                  "broadcast"])
def test_flash_attention_cuda_keeps_the_cuda_core_route(cuda_device, kind):
    """What the tensor-core route does not take keeps ``general``:
    float32 (within 2e-5), hd 32, a sliced head dim (a 2-byte aligned
    base) and broadcast KV heads (stride 0)."""
    r = np.random.default_rng(11)
    b, s, hq, hkv, hd = 2, 200, 8, 2, 64
    if kind == "float32":
        q = _bf16_normal(r, b, s, hq, hd).float()
        k, v = (_bf16_normal(r, b, s, hkv, hd).float() for _ in range(2))
    elif kind == "hd32":
        q = _bf16_normal(r, b, s, hq, 32)
        k, v = (_bf16_normal(r, b, s, hkv, 32) for _ in range(2))
    elif kind == "head_slice":
        q = _bf16_normal(r, b, s, hq, hd + 1)[..., 1:]
        k, v = (_bf16_normal(r, b, s, hkv, hd + 1)[..., 1:]
                for _ in range(2))
    else:
        q = _bf16_normal(r, b, s, hq, hd)
        k, v = (_bf16_normal(r, b, s, 1, hd).expand(b, s, hq, hd)
                for _ in range(2))
    _hold_flash(q, k, v, True, None)
    assert fa_kernel.last_route == "general"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,hd,window", [
    (700, 8, 2, 64, None), (333, 4, 4, 128, None), (500, 6, 3, 64, 100)])
def test_flash_blocked_backward_on_card_matches_whole(cuda_device, dtype, s,
                                                      hq, hkv, hd, window):
    """The blocked backward on the card (causal, GQA, a window, S not a
    multiple of the block) against the whole-matrix one on the card:
    float32 within 2e-5 of each gradient's largest magnitude, bfloat16
    within 2^-7 of it (two bf16 steps: the float32 sums round to bf16 at
    the end)."""
    r = np.random.default_rng(s + hd)
    q, k, v, do = (torch.from_numpy(r.normal(size=(2, s, h, hd)).astype(
        np.float32)).to(cuda_device, dtype) for h in (hq, hkv, hkv, hq))
    o = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    got = fa_ops.flash_attention_bwd_blocked(q, k, v, o, do, causal=True,
                                             window=window, block_q=128)
    want = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=True,
                                      window=window)
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_lm_train_loss_on_card_matches_cpu(cuda_device, arch):
    """``train_loss`` and its gradients at the smoke config (float32) on
    the card against the CPU: the loss within 2e-5 relative, each
    gradient leaf within 2e-5 of its largest magnitude (the kernel's
    forward and the products' sums run in another order); flash launches
    twice a layer on the card for GQA (forward and its recompute under
    remat="full"), never for MLA, and its backward, timed by CUDA events
    where ``ops.backward_events`` asks, once a layer."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.data import lm_pipeline
    from repro_torch.models import transformer
    from repro_torch.tree import leaves

    cfg = cfgbase.get(arch).smoke_config()
    batch = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
        vocab=cfg.vocab, batch=2, seq_len=64, seed=1)).batch(0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = transformer.init_params(cfg, seed=0, device=dev)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        before = fa_kernel.n_launches
        fa_ops.backward_events = events = []
        try:
            loss = transformer.train_loss(params, cfg, *(
                torch.from_numpy(batch[k]).to(dev)
                for k in ("tokens", "targets", "mask")))
            grads = torch.autograd.grad(loss, flat)
        finally:
            fa_ops.backward_events = None
        torch.cuda.synchronize()
        out[dev.type] = (float(loss.detach()), [g.cpu() for g in grads],
                         fa_kernel.n_launches - before,
                         [a.elapsed_time(b) for a, b in events])
    (lc, gc, nc, ms), (lp, gp, _, ms_cpu) = out["cuda"], out["cpu"]
    assert nc == (0 if cfg.attn_type == "mla" else 2 * cfg.n_layers)
    assert len(ms) == nc // 2 and all(t > 0 for t in ms) and ms_cpu == []
    assert abs(lc - lp) <= 2e-5 * abs(lp)
    for a, b in zip(gc, gp):
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


def _sage_grads(params, cfg, batch):
    from repro_torch.examples.gnn_sage import blocks_loss
    from repro_torch.launch.train import value_and_grad
    from repro_torch.tree import leaves
    loss, grads = value_and_grad(lambda p: blocks_loss(p, cfg, batch),
                                 params)
    return loss, leaves(grads)


@pytest.mark.gpu
def test_sage_blocks_step_on_card_matches_cpu_and_repeats(cuda_device):
    """GraphSAGE's smoke config: blocks sampled on the card, one step's
    loss and gradients against the CPU fed the same blocks, and two runs
    on the card bit-equal."""
    from repro_torch.configs import graphsage_reddit
    from repro_torch.data import graph_data
    from repro_torch.models import gnn, sampler

    cfg = graphsage_reddit.smoke_config()
    g = graph_data.make_graph(graph_data.GraphConfig(
        n_nodes=500, n_edges=4000, d_feat=cfg.d_in,
        n_classes=cfg.n_classes, seed=0))
    indptr, indices = sampler.csr_from_edges(g["edges"], 500,
                                             device=cuda_device)
    want_ptr, want_idx = sampler.csr_from_edges(g["edges"], 500)
    assert np.array_equal(indptr.cpu().numpy(), want_ptr)
    assert np.array_equal(indices.cpu().numpy(), want_idx)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    seeds = torch.arange(0, 500, 7, dtype=torch.int32, device=cuda_device)
    fr, bl = sampler.sample_blocks(gen, indptr, indices, seeds, (6, 4))
    feats = torch.from_numpy(g["feats"]).to(cuda_device)
    labels = torch.from_numpy(g["labels"]).to(cuda_device)
    batch = {"feats": [feats[f.long()] for f in fr], "blocks": bl,
             "labels": labels[seeds.long()]}
    cpu = torch.device("cpu")
    batch_cpu = {"feats": [f.cpu() for f in batch["feats"]],
                 "blocks": [{k: (v.cpu() if torch.is_tensor(v) else v)
                             for k, v in b.items()} for b in bl],
                 "labels": batch["labels"].cpu()}
    params = gnn.init_sage(cfg, seed=0, device=cuda_device)
    loss_a, g_a = _sage_grads(params, cfg, batch)
    loss_b, g_b = _sage_grads(params, cfg, batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))
    loss_h, g_h = _sage_grads(gnn.init_sage(cfg, seed=0, device=cpu), cfg,
                              batch_cpu)
    assert abs(float(loss_a) - float(loss_h)) <= 1e-5 * abs(float(loss_h))
    for a, b in zip(g_a, g_h):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_no_syncs_catches_an_item_and_passes_an_elementwise_op(cuda_device):
    from repro_torch.analysis.sanitizers import SyncError, no_syncs

    x = torch.arange(1024, dtype=torch.float32, device=cuda_device)
    with no_syncs() as rec:
        y = x * 2 + 1
    assert rec.syncs == [] and y.shape == x.shape
    with pytest.raises(SyncError, match="unvetted"):
        with no_syncs() as rec:
            x.sum().item()
    (sync,) = rec.syncs
    assert sync.status == "unvetted" and sync.file == "<outside the port>"
    # a sync inside the port is put at its innermost port frame: the
    # data-dependent shapes of ``scatter_rows`` fail unless allowed
    ids = torch.tensor([3, 1, 3, 0], device=cuda_device)
    rows = torch.ones(4, 2, device=cuda_device)
    with pytest.raises(SyncError, match="models/layers.py:.* scatter_rows"):
        with no_syncs():
            layers.scatter_rows(rows, ids, 5)
    with no_syncs(allowed={("models/layers.py", "scatter_rows")}) as rec:
        out = layers.scatter_rows(rows, ids, 5)
    assert rec.syncs and {s.status for s in rec.syncs} == {"allowed"}
    assert out[3].tolist() == [2.0, 2.0]
    # the timing fence is vetted wherever it is called from
    from repro_torch.device import fence
    with no_syncs() as rec:
        fence(cuda_device)
    assert [s.status for s in rec.syncs] == ["vetted"]
    assert rec.syncs[0].frame.startswith("device.py:")


# ------------------------------------------------------- program cache --

def _eager_serve(e, qt, pv, dv=None):
    """``engine.serve``'s four stages called eagerly -- the module-level
    functions the cache captured -- on the same padded device tensors."""
    from repro_torch.serving import engine as t_engine
    cfg = e.cfg
    q, p = e._to_device(qt, fill=-1), e._to_device(pv, fill=1)
    qids = torch.arange(q.shape[0], dtype=torch.int32, device=e.device)
    kern = dict(n_docs=e.n_docs, block_p=e.block_p, block_d=e.block_d)
    ds, im, lo, hi, sd, s3 = t_engine._stage_gather(
        e.offsets, e.pdoc, e.pimp, e.pscore, q, cap=cfg.stream_cap,
        block_p=e.block_p, n_docs=e.n_docs)
    if cfg.knob == "rho":
        pool = t_engine._stage1_rho(ds, im, lo, hi, p,
                                    depth=cfg.rerank_depth, **kern)
    else:
        pool = t_engine._stage1_k(ds, im, lo, hi, p, max_k=e.max_k, **kern)
    s2 = t_engine._stage2(sd, s3, e.doc_len, qids, n_docs=e.n_docs,
                          n_terms=q.shape[1])
    if dv is None:
        r = t_engine._stage_rerank(s2, pool, depth=cfg.rerank_depth)
    else:
        r = t_engine._stage_rerank_dyn(s2, pool, e._to_device(dv, fill=1),
                                       depth=cfg.rerank_depth)
    return t_engine._pad_ranked(r[:qt.shape[0]].cpu().numpy(),
                                cfg.rerank_depth)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_replayed_programs_equal_the_eager_stages_on_card(cuda_device,
                                                          knob):
    """Every program of the warmed grid is a CUDA graph, and replayed
    lists equal eager calls of the same stage functions bit for bit,
    with and without a depth vector; a shape replayed on other rows
    takes the new rows (the static inputs are refreshed)."""
    server, qt = _card_server(cuda_device, knob)
    e = server.engine
    grid = [8, 16, 24, 32, 40]
    built = e.warmup(grid, qt.shape[1], with_depth=True)
    stats = e.program_stats()
    assert built == stats["programs"] == stats["graphs"] == 5 * len(grid)
    assert e._programs.pool_sizes() == grid  # one graph pool a shape
    r0 = stats["replays"]
    rng = np.random.default_rng(5)
    for n in (5, 16, 37, 37, 30):
        rows = qt[rng.permutation(qt.shape[0])[:n]]
        pv = server.params_of(server.predict_classes(rows))
        dv = rng.integers(1, 31, n)
        for d in (None, dv):
            got, _ = e.serve(rows, pv, depth_vec=d)
            np.testing.assert_array_equal(got, _eager_serve(e, rows, pv, d))
    assert e.n_compiles == built
    assert e.program_stats()["replays"] - r0 == 5 * 2 * 4


@pytest.mark.gpu
def test_launch_counters_count_a_replay_as_an_eager_run(cuda_device):
    server, qt = _card_server(cuda_device, "rho")
    e = server.engine
    pv = server.params_of(server.predict_classes(qt))

    def counts(fn):
        n0 = (is_kernel.n_launches, tk_kernel.n_launches)
        fn()
        return (is_kernel.n_launches - n0[0], tk_kernel.n_launches - n0[1])

    # a build's own runs count nothing: a cold shape counts its replay
    assert counts(lambda: e.serve(qt, pv)) == (1, 1)
    assert e.program_stats()["graphs"] == 4
    assert counts(lambda: e.serve(qt, pv)) == counts(
        lambda: _eager_serve(e, qt, pv)) == (1, 1)


@pytest.mark.gpu
def test_warmup_mid_flight_leaves_live_state_unchanged_on_card(cuda_device):
    """A scheduler stopped mid-flight on the card: a warmup replays all
    four programs on a scratch table and leaves every live tensor as it
    was; the run then ends with the batch-once lists."""
    server, qt = _card_server(cuda_device, "k")
    rows = qt[:6]
    backend = service.ContinuousBackend(server, query_len=qt.shape[1],
                                        slots=8, grain=4)
    svc = service.RetrievalService(backend)
    futs = svc.submit_many(list(rows), deadline_ms=1e6)
    svc.flush()
    svc.step()
    sched = backend.scheduler
    assert sched.table.active()
    fields = ("ds", "im", "seg_lo", "seg_hi", "sdocs", "s3", "acc")
    state = sched._state
    before = [getattr(state, f).clone() for f in fields]
    for _ in range(2):
        sched.prog.warmup(8, qt.shape[1])
    torch.cuda.synchronize()
    for f, b in zip(fields, before):
        assert torch.equal(getattr(state, f), b), f
    while svc.outstanding:
        assert svc.step()
    ref, _ = server.engine.serve(
        rows, server.params_of(server.predict_classes(rows)))
    np.testing.assert_array_equal(np.stack([f.result()["ranked"]
                                            for f in futs]), ref)
    assert server.engine.program_stats()["graphs"] == \
        server.engine.n_compiles


def _eager_predict(server, rows, knob, stage):
    """A predict stage function called eagerly on the server's padded
    device operands (the ones its program copies in)."""
    args, kw = server._operands(rows, knob)
    return stage(*args, **kw)[:rows.shape[0]].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["forest", "mlp"])
def test_replayed_predicts_equal_the_eager_stages_on_card(cuda_device,
                                                          kind):
    """Every predict and margin program of the grid is a CUDA graph in a
    pool of the server's own (one a padded shape), and replayed classes
    and margins equal eager calls of the same stage functions bit for
    bit, on rows that change from call to call."""
    server, qt = _card_server(cuda_device, "rho", kind=kind)
    pp = server.predict_programs
    grid = [8, 16, 24, 32, 40]
    terms = np.concatenate([qt, qt[::-1]])
    rng = np.random.default_rng(8)
    for rep in range(2):
        for b in grid:
            rows = terms[rng.permutation(len(terms))[:b - rep * 3]]
            np.testing.assert_array_equal(
                server.predict_classes(rows),
                _eager_predict(server, rows, "rho", pipeline._stage_predict))
            np.testing.assert_array_equal(
                server.predict_margin(rows),
                _eager_predict(server, rows, "rho", pipeline._stage_margin))
    stats = pp.stats()
    assert stats["programs"] == stats["graphs"] == pp.n_compiles \
        == 2 * len(grid)
    assert stats["replays"] == 2 * 2 * len(grid)
    assert pp.pool_sizes() == grid
    assert server.engine.n_compiles == 0       # no stage was served


@pytest.mark.gpu
def test_a_predict_on_the_admission_stream_runs_beside_the_engine(
        cuda_device):
    """The admission thread's predict replays on its own stream from the
    server's own pools: it ends while the default stream (the execution
    thread's) is still busy, and while an engine replay of the same
    padded shape holds its pool."""
    import threading
    server, qt = _card_server(cuda_device, "rho")
    pv = server.params_of(server.predict_classes(qt))
    server.engine.serve(qt, pv)                 # the engine's shape 40
    want = server.predict_classes(qt)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):               # the pinned copy's block
        server.predict_classes(qt)
    out, spent = [], []

    def admit():
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            out.append(server.predict_classes(qt))
            spent.append(time.perf_counter() - t0)

    busy = torch.cuda.Event()
    with server.engine._programs._pools[40].lock:
        torch.cuda._sleep(int(3e9))              # ~1.5-2 s of the card
        busy.record()
        t = threading.Thread(target=admit)
        t.start()
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert not busy.query()                  # the sleep still runs
    np.testing.assert_array_equal(out[0], want)
    assert spent[0] < 0.5, spent
    assert server.predict_programs._pools[40] is not \
        server.engine._programs._pools[40]


def _syncing_stage(x):
    return x * float(x.sum())


@pytest.mark.gpu
def test_a_stage_that_cannot_be_captured_raises(cuda_device):
    """No fallback: a stage that syncs inside its capture raises, the
    cache keeps no entry for it, and the card serves on."""
    server, qt = _card_server(cuda_device, "rho")
    e = server.engine
    x = e.doc_len[:8].to(torch.float32)
    with pytest.raises(RuntimeError):
        e._compiled("syncing", _syncing_stage, (x,), {})
    assert e.n_compiles == 0 and e.program_stats()["programs"] == 0
    pv = server.params_of(server.predict_classes(qt))
    np.testing.assert_array_equal(e.serve(qt, pv)[0],
                                  _eager_serve(e, qt, pv))


# ------------------------------------------- sharded and decode programs --

@contextlib.contextmanager
def _stage_functions(engine):
    """Within the block the engine's stages, and its scheduler's, run as
    their functions called directly (the eager path the cache
    captured), not as programs."""
    engine._compiled = (lambda name, fn, args, kwargs, consts=():
                        functools.partial(fn, **kwargs))
    try:
        yield
    finally:
        del engine._compiled


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_programs_replayed_equal_eager_on_card(card_positions, shape):
    """The sharded engine's six programs on the card (model=2, and data
    x model 2x2): each a CUDA graph, the lists of the warmed grid bit-
    equal to the stage functions called eagerly and to the unsharded
    engine, impact_scan and topk counted once a shard and data group at
    each replay, and mixed batches on the warm grid building nothing
    with no unvetted sync (``hot_path``); then on model=2 the sharded
    scheduler's four programs, its lists equal to the batch-once
    serve."""
    from repro_torch.analysis import sanitizers
    dev = torch.device("cuda")
    data, model = shape
    server, qt = _card_server(dev, "rho")
    sharded, _ = _card_server(
        dev, "rho", card_positions.make_serving_mesh(model, data, device=dev),
        partition_slack=CARD_SLACK)
    e = sharded.engine
    built = e.warmup([8, 16, 40], qt.shape[1], with_depth=True)
    stats = e.program_stats()
    assert built == stats["programs"] == stats["graphs"] == 7 * 3
    rng = np.random.default_rng(11)
    plan = []
    for n in (5, 16, 37, 11):
        rows = qt[rng.permutation(qt.shape[0])[:n]]
        plan.append((rows, sharded.params_of(sharded.predict_classes(rows)),
                     rng.integers(1, 31, n)))
    replayed, launches = [], []
    with sanitizers.hot_path(e) as rec:
        for rows, pv, dv in plan:
            n0 = (is_kernel.n_launches, tk_kernel.n_launches)
            replayed.append((e.serve(rows, pv)[0],
                             e.serve(rows, pv, depth_vec=dv)[0]))
            launches.append((is_kernel.n_launches - n0[0],
                             tk_kernel.n_launches - n0[1]))
    assert rec.new_compiles == 0 and rec.syncs.unvetted() == []
    assert launches == [(2 * data * model,) * 2] * len(plan)
    for (rows, pv, dv), (got, got_dv) in zip(plan, replayed):
        with _stage_functions(e):
            np.testing.assert_array_equal(got, e.serve(rows, pv)[0])
        np.testing.assert_array_equal(got, server.engine.serve(rows, pv)[0])
        np.testing.assert_array_equal(
            got_dv, server.engine.serve(rows, pv, depth_vec=dv)[0])
    if data == 1:
        backend = service.ContinuousBackend(sharded, query_len=qt.shape[1],
                                            slots=16, grain=4, window=8)
        svc = service.RetrievalService(backend)
        assert backend.warmup_shape(8) == 4
        with sanitizers.compile_sentinel(e):
            res = svc.serve_all(list(qt), deadline_ms=1e6)
        ref, _ = server.engine.serve(
            qt, server.params_of(server.predict_classes(qt)))
        np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]),
                                      ref)
    assert e.program_stats()["graphs"] == e.n_compiles


def _decode_run(cfg, toks, params, step, start, steps=8):
    """Prefill on the card, then ``steps`` greedy steps: eager before
    ``start``, through ``step`` after.  Returns [(token, logits)] and the
    cache."""
    from repro_torch.models import transformer
    logits, pre = transformer.prefill(params, cfg,
                                      torch.from_numpy(toks).cuda())
    b, s = toks.shape
    cache = transformer.init_cache(cfg, b, s + steps, device="cuda")
    for g in pre:
        for x in pre[g]:
            cache[g][x][:, :, :pre[g][x].shape[2]] = pre[g][x]
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = []
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        if i < start:
            tok, lg, cache = transformer.decode_step(params, cfg, cache, tok,
                                                     pos)
        else:
            tok, lg, cache = step(params, cache, tok, pos)
        out.append((tok.clone(), lg.clone()))
    return out, cache


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("tinyllama-1.1b", 24), ("qwen2-0.5b", 24),
                                    ("qwen3-4b", 24), ("mixtral-8x22b", 32),
                                    ("deepseek-v3-671b", 24)])
def test_replayed_decode_equals_eager_on_card(cuda_device, arch, s):
    """Each LM arch's smoke config (float32): greedy steps through the
    decode programs, the program built at step 3 of 8 on that step's own
    inputs, bit-equal to eager steps in tokens, logits and the cache; one
    CUDA graph, replayed for each later step, which launches no kernel
    of the port's (the decode attention is torch ops)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import lm_pipeline
    from repro_torch.models import transformer
    from repro_torch.serving.decode import DecodePrograms
    from repro_torch.tree import leaves
    cfg = cfgbase.get(arch).smoke_config()
    toks = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
        vocab=cfg.vocab, batch=2, seq_len=s, seed=1)).batch(0)["tokens"]
    params = transformer.init_params(cfg, seed=0, device=cuda_device)
    progs = DecodePrograms(params, cfg)
    want, want_cache = _decode_run(cfg, toks, params, None, start=8)
    kernels = (is_kernel, tk_kernel, fa_kernel, eb_kernel)
    n0 = [k.n_launches for k in kernels]
    got, cache = _decode_run(cfg, toks, params, progs, start=3)
    assert [k.n_launches for k in kernels] == [
        n + (cfg.n_layers if k is fa_kernel and cfg.attn_type != "mla"
             else 0) for k, n in zip(kernels, n0)]   # the prefill's flash
    for (gt, gl), (wt, wl) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gl, wl)
    for a, b in zip(leaves(cache), leaves(want_cache)):
        assert torch.equal(a, b)
    stats = progs.stats()
    assert (progs.n_compiles, stats["graphs"], stats["replays"]) == (1, 1, 5)


def _syncing_decode(params, cfg, cache, token, pos):
    return token * int(pos.sum()), params["lm_head"][:1].float(), cache


@pytest.mark.gpu
def test_a_sharded_or_decode_program_that_cannot_be_captured_raises(
        card_positions, monkeypatch):
    """No fallback: a sharded stage or a decode step that syncs inside its
    capture raises, its cache keeps no entry, and serving goes on."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer
    from repro_torch.serving.decode import DecodePrograms
    dev = torch.device("cuda")
    server, qt = _card_server(
        dev, "rho", card_positions.make_serving_mesh(2, device=dev),
        partition_slack=CARD_SLACK)
    e = server.engine
    x = e.doc_len[:8].to(torch.float32)
    with pytest.raises(RuntimeError):
        e._compiled("syncing", _syncing_stage, (x,), {})
    assert e.n_compiles == 0 and e.program_stats()["programs"] == 0
    assert server.serve_batch(qt)["ranked"].shape == (37, 30)
    cfg = cfgbase.get("tinyllama-1.1b").smoke_config()
    params = transformer.init_params(cfg, seed=0, device=dev)
    cache = transformer.init_cache(cfg, 2, 16, device=dev)
    progs = DecodePrograms(params, cfg)
    tok = torch.zeros(2, dtype=torch.int32, device=dev)
    monkeypatch.setattr(transformer, "decode_step", _syncing_decode)
    with pytest.raises(RuntimeError):
        progs(params, cache, tok, tok)
    assert progs.n_compiles == 0 and progs.programs.keys() == []
    monkeypatch.undo()
    assert progs(params, cache, tok, tok)[2] is cache
    assert progs.n_compiles == 1
