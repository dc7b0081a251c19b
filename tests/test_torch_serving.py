"""The port's batch-once serving path against the JAX package's.

The JAX-built index and cascade are carried across as numpy arrays
(``repro_torch.convert``), so both servers see the same postings, scores
and forests.  Tolerance: ranked lists and classes equal.  Stage 1 is
exact (integer impacts), the scorer accumulators add in the reference's
order, and stage-2 scores agree to rtol 1e-6; with no two docs of a pool
that close, the ranked lists are identical, and these tests demand it.
"""

import numpy as np
import pytest
import torch

from repro.core import cascade as j_cascade
from repro.core import experiment as j_exp
from repro.core import labeling as j_labeling
from repro.serving import pipeline as j_pipeline
from repro_torch import convert
from repro_torch.core import knobs as t_knobs
from repro_torch.serving import pipeline as t_pipeline

N = 37                      # deliberately not a multiple of the pad grid


@pytest.fixture(scope="module")
def carried(tiny_system):
    ix = tiny_system.index
    ts = ix.term_stats
    tindex = convert.index_from_numpy(
        offsets=ix.offsets, postings_doc=ix.postings_doc,
        postings_impact=ix.postings_impact,
        postings_score=ix.postings_score, doc_len=ix.corpus.doc_len,
        stats=ts.stats, ctf=ts.ctf, df=ts.df, device="cpu")
    out = {}
    for knob in ("rho", "k"):
        cuts = (tiny_system.k_cutoffs if knob == "k"
                else tiny_system.rho_cutoffs)
        med = j_exp.med_tables(tiny_system, knob, metrics=("rbp",))["rbp"]
        labels = np.asarray(j_labeling.envelope_labels(med, 0.05))
        casc = j_cascade.train_cascade(
            tiny_system.features, labels, n_cutoffs=len(cuts),
            forest_kwargs=dict(n_trees=5, max_depth=4))
        tcasc = convert.cascade_from_numpy(
            "forest", [{k: np.asarray(v) for k, v in p.items()}
                       for p in casc.node_params],
            casc.max_depth, casc.n_cutoffs, device="cpu")
        out[knob] = (cuts, casc, tcasc)
    return tiny_system, tindex, out


def _servers(carried, knob, **cfg_kw):
    sys_, tindex, per_knob = carried
    cuts, casc, tcasc = per_knob[knob]
    kw = dict(knob=knob, cutoffs=cuts, rerank_depth=30,
              stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
              kernel_block_d=512, **cfg_kw)
    js = j_pipeline.RetrievalServer(
        sys_.index, casc, j_pipeline.ServingConfig(use_kernel=False, **kw))
    ts = t_pipeline.RetrievalServer(
        tindex, tcasc, t_pipeline.ServingConfig(**kw), device="cpu")
    return js, ts, sys_.queries.terms


@pytest.mark.parametrize("start", [0, N])
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_serve_batch_matches_jax(carried, knob, start):
    """On CPU tensors the engine's kernel route runs the kernels' plain
    versions; two disjoint query batches per knob."""
    js, ts, terms = _servers(carried, knob)
    qt = terms[start:start + N]
    a, b = js.serve_batch(qt), ts.serve_batch(qt)
    np.testing.assert_array_equal(b["classes"], a["classes"])
    np.testing.assert_array_equal(b["widths"], a["widths"])
    np.testing.assert_array_equal(b["ranked"], a["ranked"])
    assert b["ranked"].shape == (N, 30)
    assert set(b["timings"]) == set(a["timings"])
    # one program per stage and padded shape, the JAX engine's count
    assert b["n_compiles"] == a["n_compiles"] > 0
    # the per-bucket oracle agrees with the batch-once path
    ref = ts.serve_batch_reference(qt)
    np.testing.assert_array_equal(ref["ranked"], b["ranked"])
    np.testing.assert_array_equal(ref["widths"], b["widths"])
    assert len(np.unique(b["classes"])) > 1       # several buckets live


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_serve_batch_with_depth_vector_matches_jax(carried, knob):
    """The third knob with no depth cascade installed: every query at the
    reference depth (a no-op mask), so the depth path equals the
    depth-free one; then a pinned per-query depth through serve_fixed."""
    cuts = carried[2][knob][0]
    pool = 30 if knob == "rho" else max(cuts)
    grid = t_knobs.depth_cutoffs(pool)
    js, ts, terms = _servers(carried, knob, depth_cutoffs=grid)
    qt = terms[:N]
    a, b = js.serve_batch(qt), ts.serve_batch(qt)
    np.testing.assert_array_equal(b["ranked"], a["ranked"])
    np.testing.assert_array_equal(b["depths"], a["depths"])
    assert b["stage2_rows_scored"] == a["stage2_rows_scored"]
    plain = ts.engine.serve(qt, ts.params_of(ts.predict_classes(qt)))[0]
    np.testing.assert_array_equal(b["ranked"], plain)
    fix = cuts[3]
    for depth in (grid[0], grid[2]):
        np.testing.assert_array_equal(
            ts.serve_fixed(qt, fix, depth=depth)["ranked"],
            js.serve_fixed(qt, fix, depth=depth)["ranked"])


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_serve_fixed_matches_jax(carried, knob):
    js, ts, terms = _servers(carried, knob)
    qt = terms[:16]
    cuts = carried[2][knob][0]
    params = (0, cuts[2], 10_000) if knob == "rho" else (cuts[1], 3000)
    for param in params:
        a, b = js.serve_fixed(qt, param), ts.serve_fixed(qt, param)
        np.testing.assert_array_equal(b["ranked"], a["ranked"])
        assert b["mean_param"] == a["mean_param"]


def test_swap_predictor_and_margin(carried):
    js, ts, terms = _servers(carried, "rho")
    qt = terms[:20]
    np.testing.assert_allclose(ts.predict_margin(qt), js.predict_margin(qt),
                               rtol=1e-6, atol=1e-7)
    live = ts._live["rho"][0]
    flipped = [{**p, "leaf": p["leaf"].flip(-1)} for p in live]
    v = ts.swap_predictor(flipped, np.full(9, 0.6, np.float32))
    assert v == 1
    jlive = js._live["rho"][0]
    js.swap_predictor([{**p, "leaf": p["leaf"][..., ::-1]} for p in jlive],
                      np.full(9, 0.6, np.float32))
    np.testing.assert_array_equal(ts.predict_classes(qt),
                                  js.predict_classes(qt))
    with pytest.raises(ValueError, match="mismatch"):
        ts.swap_predictor([{**p, "thresh": p["thresh"][:, :3]}
                           for p in live])
    with pytest.raises(ValueError, match="thresholds shape"):
        ts.swap_predictor(live, np.zeros(3, np.float32))


def test_server_on_missing_device_raises(carried, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys_, tindex, per_knob = carried
    cuts, _, tcasc = per_knob["k"]
    cfg = t_pipeline.ServingConfig(knob="k", cutoffs=cuts, rerank_depth=30,
                                   stream_cap=sys_.cfg.stream_cap)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_pipeline.RetrievalServer(tindex, tcasc, cfg)
