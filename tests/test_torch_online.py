"""The port's online loop (``repro_torch.online``: telemetry, drift,
store, shadow, trainer, controller, replay; the warm-started refits of
``core``; the CLI's ``--online``) against the JAX package's, on the CPU.

Both packages serve the same carried index and JAX-trained boot
cascades (``tests/_torch_carry.py``).  Tolerances, with their reasons:
  * telemetry ring, drift decisions, shifted query bands: equal (numpy
    on both sides).
  * forest tables of cold and warm refits: identical, from the same seed
    and the same features (host numpy on both sides).
  * shadow MED tables: rtol 1e-5 with an atol of 1e-6, as
    ``tests/test_torch_core.py`` holds MED (float32 sums in another
    order); MED(A, A) is exactly 0.  Envelope labels from those tables:
    equal -- every test counts the labels that differ and requires 0.
  * shadow features: rtol 1e-6, as ``tests/test_torch_core.py`` holds
    features (masked means in float32).
  * the controller: the same labels, retrains, swaps, versions and
    published thresholds as the JAX controller on the same stream; the
    published forest tables are identical wherever the two windows'
    features are (tested: they are on ``tiny_system``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_carry import bare_servers, carry_index, carry_servers
from repro.core import cascade as j_cascade
from repro.core import forest as j_forest
from repro.core import labeling as j_labeling
from repro.online import (DriftConfig as JDriftConfig,
                          EnvelopeMonitor as JEnvelopeMonitor,
                          OnlineConfig as JOnlineConfig,
                          OnlineController as JOnlineController,
                          PredictorStore as JPredictorStore,
                          ShadowExecutor as JShadowExecutor,
                          TelemetryBuffer as JTelemetryBuffer,
                          TelemetryRecord as JTelemetryRecord,
                          TrainerConfig as JTrainerConfig,
                          serving_med_table as j_serving_med_table,
                          shifted_queries as j_shifted_queries)
from repro.online.shadow import ShadowBatch as JShadowBatch
from repro.online.trainer import CascadeTrainer as JCascadeTrainer
from repro.serving import service as j_service
from repro.serving.admission import AdmissionConfig as JAdmissionConfig
from repro_torch import convert
from repro_torch.core import cascade as t_cascade
from repro_torch.core import forest as t_forest
from repro_torch.core import labeling as t_labeling
from repro_torch.online import (DriftConfig, EnvelopeMonitor, OnlineConfig,
                                OnlineController, PredictorStore,
                                ShadowExecutor, TelemetryBuffer,
                                TelemetryRecord, TrainerConfig, replay,
                                serving_med_table, shifted_queries)
from repro_torch.online.shadow import ShadowBatch
from repro_torch.online.trainer import CascadeTrainer
from repro_torch.retrieval import corpus as t_corpus
from repro_torch.serving import service as t_service
from repro_torch.serving.admission import AdmissionConfig

MED_RTOL, MED_ATOL = 1e-5, 1e-6
FEAT_RTOL = 1e-6
TAU = 0.05
#: the carried boot cascades' shape (``carry_servers``); refits match it
FOREST_KW = dict(n_trees=5, max_depth=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables(casc):
    """Per-node forest tables as numpy, whichever package built them."""
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in casc.node_params]


def _assert_tables_equal(a, b):
    for pa, pb in zip(a, b):
        assert set(pa) == set(pb)
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


def _port_cascade(jcasc):
    return convert.cascade_from_numpy("forest", _tables(jcasc),
                                      jcasc.max_depth, jcasc.n_cutoffs,
                                      device="cpu")


def _random_labels_cascade(sys_, seed):
    """A JAX boot cascade from synthetic labels (the loop's mechanics do
    not care how good the boot predictor is)."""
    cuts = sys_.rho_cutoffs
    labels = np.random.default_rng(seed).integers(
        0, len(cuts) + 1, sys_.features.shape[0])
    return j_cascade.train_cascade(sys_.features, labels,
                                   n_cutoffs=len(cuts), seed=seed,
                                   forest_kwargs=FOREST_KW)


def _services(pair, capacity=128):
    """A JAX and a port batch-once service, each with a telemetry ring."""
    js, ts = pair
    jsvc = j_service.RetrievalService(
        j_service.EngineBackend(js), JAdmissionConfig(max_batch=16,
                                                      pad_multiple=8),
        telemetry=JTelemetryBuffer(capacity))
    tsvc = t_service.RetrievalService(
        t_service.EngineBackend(ts), AdmissionConfig(max_batch=16,
                                                     pad_multiple=8),
        telemetry=TelemetryBuffer(capacity))
    return jsvc, tsvc


@pytest.fixture(scope="module")
def served(tiny_system):
    """Carried servers (rho) that serve 32 queries through both
    packages' services; nothing here swaps them."""
    pair = carry_servers(tiny_system, knobs=("rho",))["rho"]
    jsvc, tsvc = _services(pair)
    qt = tiny_system.queries.terms[:32]
    jsvc.serve_all(list(qt))
    tsvc.serve_all(list(qt))
    return pair, jsvc.telemetry, tsvc.telemetry


# ------------------------------------------------------------ telemetry --

def _rec(mod, i):
    return mod(payload=np.full(3, i), pred_class=i % 4, width=float(i),
               ranked=np.arange(5), total_ms=1.0, predictor_version=0,
               t_wall=0.0)


def test_telemetry_ring_overwrites_as_the_jax_ring():
    bufs = []
    for buf_cls, rec_cls in ((TelemetryBuffer, TelemetryRecord),
                             (JTelemetryBuffer, JTelemetryRecord)):
        buf = buf_cls(capacity=4)
        for i in range(6):
            buf.append(_rec(rec_cls, i))
        rng = np.random.default_rng(0)
        bufs.append((len(buf), buf.n_seen, buf.n_dropped,
                     [r.seq for r in buf.snapshot()],
                     [r.seq for r in buf.sample(3, rng)],
                     [r.seq for r in buf.take_unread(2, min_seq=3)],
                     buf.sample(2, rng, min_seq=6)))
    assert bufs[0] == bufs[1]
    assert bufs[0][:4] == (4, 6, 2, [2, 3, 4, 5])
    with pytest.raises(ValueError, match="capacity"):
        TelemetryBuffer(capacity=0)


def test_telemetry_service_tap(served, tiny_system):
    """The batch-once service taps every resolved request, as the JAX
    service does: the same payloads, classes, widths and lists."""
    (_, ts), jbuf, tbuf = served
    assert tbuf.n_seen == jbuf.n_seen == 32
    qt = tiny_system.queries.terms[:32]
    for r, w, row in zip(tbuf.snapshot(), jbuf.snapshot(), qt):
        np.testing.assert_array_equal(np.asarray(r.payload), row)
        np.testing.assert_array_equal(r.ranked, w.ranked)
        assert (r.pred_class, r.width, r.trace_id, r.predictor_version) == (
            w.pred_class, w.width, w.trace_id, w.predictor_version)
        assert r.retire_reason is None and r.chunks_max == 0


# --------------------------------------------------------------- shadow --

def _n_label_diffs(tm, jm, tau=TAU):
    return int((t_labeling.envelope_labels(tm, tau).numpy()
                != np.asarray(j_labeling.envelope_labels(jm, tau))).sum())


def test_serving_med_table_matches_jax(served, tiny_system):
    (js, ts), _, _ = served
    qt = tiny_system.queries.terms[:48]
    tm = serving_med_table(ts, qt, batch=16)
    jm = j_serving_med_table(js, qt, batch=16)
    np.testing.assert_allclose(tm, jm, rtol=MED_RTOL, atol=MED_ATOL)
    ref = ts.cfg.cutoffs.index(max(ts.cfg.cutoffs))
    assert (tm[:, ref] == 0).all()
    assert _n_label_diffs(tm, jm) == 0


def test_shadow_batches_match_jax(served):
    """Two shadow cycles over the same logged traffic give the JAX
    executor's MED tables, labels, observed MED and features."""
    (js, ts), jbuf, tbuf = served
    tsh = ShadowExecutor(ts, tbuf, sample=16, seed=3)
    jsh = JShadowExecutor(js, jbuf, sample=16, seed=3)
    for _ in range(2):
        tb, jb = tsh.run_once(), jsh.run_once()
        np.testing.assert_allclose(tb.med, jb.med, rtol=MED_RTOL,
                                   atol=MED_ATOL)
        np.testing.assert_allclose(tb.observed_med, jb.observed_med,
                                   rtol=MED_RTOL, atol=MED_ATOL)
        np.testing.assert_allclose(tb.features, jb.features,
                                   rtol=FEAT_RTOL)
        assert _n_label_diffs(tb.med, jb.med) == 0
        np.testing.assert_array_equal(tb.served_class, jb.served_class)
        assert tb.max_seq == jb.max_seq
    assert tsh.run_once() is None and jsh.run_once() is None
    assert tsh.n_labeled == jsh.n_labeled == 32


def test_shadow_importance_sampling_matches_jax(served):
    (js, ts), jbuf, tbuf = served
    tsh = ShadowExecutor(ts, tbuf, sample=8, importance=True,
                         pool_factor=4)
    jsh = JShadowExecutor(js, jbuf, sample=8, importance=True,
                          pool_factor=4)
    tb, jb = tsh.run_once(), jsh.run_once()
    assert tb.max_seq == jb.max_seq
    np.testing.assert_array_equal(tb.served_class, jb.served_class)
    assert tsh._cursor == jsh._cursor


def test_shadow_scores_the_decision_not_the_fallback_width(tiny_system):
    """During breaker fallback the served width is the reference; the
    shadow scores the predictor's logged class instead."""
    _, ts = carry_servers(tiny_system, knobs=("rho",))["rho"]
    buf = TelemetryBuffer(capacity=32)
    svc = t_service.RetrievalService(
        t_service.EngineBackend(ts), AdmissionConfig(max_batch=8,
                                                     pad_multiple=8),
        telemetry=buf)
    ts.fallback = True
    svc.serve_all(list(tiny_system.queries.terms[:8]))
    ts.fallback = False
    assert all(r.width == max(ts.cfg.cutoffs) for r in buf.snapshot())
    batch = ShadowExecutor(ts, buf, sample=8).run_once()
    c = len(ts.cfg.cutoffs)
    want = batch.med[np.arange(8), np.minimum(batch.served_class, c - 1)]
    np.testing.assert_array_equal(batch.observed_med, want)


def test_shadow_handles_classless_records(served, tiny_system):
    (_, ts), _, _ = served
    buf = TelemetryBuffer(8)
    qt = tiny_system.queries.terms[:4]
    ref = ts.serve_fixed(qt, ts.cfg.stream_cap)["ranked"]
    for i in range(4):
        buf.record(qt[i], {"ranked": ref[i]}, 0, 0.0)
    batch = ShadowExecutor(ts, buf, sample=4).run_once()
    assert (batch.served_class == -1).all()
    np.testing.assert_array_equal(batch.observed_med, np.zeros(4))


# ---------------------------------------------------- store and swaps --

def test_store_versions_and_compatibility(tiny_system):
    """Versions, padding and refusals as the JAX store; the padded
    tables equal the JAX store's."""
    ja, jb = (_random_labels_cascade(tiny_system, s) for s in (0, 1))
    store = PredictorStore(_port_cascade(ja), [0.75] * ja.n_cutoffs,
                           device="cpu")
    jstore = JPredictorStore(ja, [0.75] * ja.n_cutoffs)
    assert store.current().version == 0
    v = store.publish(_port_cascade(jb), [0.8] * jb.n_cutoffs,
                      trained_on=32)
    jv = jstore.publish(jb, [0.8] * jb.n_cutoffs, trained_on=32)
    assert v.version == jv.version == 1 and store.n_published == 2
    _assert_tables_equal(_tables(v), _tables(jv))
    np.testing.assert_array_equal(v.thresholds.numpy(),
                                  np.asarray(jv.thresholds))
    cap = t_forest.node_capacity(ja.max_depth)
    assert all(p["feature"].shape[1] == cap for p in v.node_params)
    deeper = t_cascade.train_cascade(
        tiny_system.features, np.ones(tiny_system.features.shape[0],
                                      np.int64),
        n_cutoffs=ja.n_cutoffs, forest_kwargs=dict(n_trees=5, max_depth=6),
        device="cpu")
    with pytest.raises(ValueError, match="max_depth"):
        store.publish(deeper, [0.75] * ja.n_cutoffs)
    with pytest.raises(ValueError, match="thresholds"):
        store.publish(_port_cascade(jb), [0.8, 0.8])
    for _ in range(5):
        store.publish(_port_cascade(jb), [0.8] * jb.n_cutoffs)
    assert len(store._versions) == store.keep == 4


def _server_with(tiny_system, jcasc):
    """A port server on the carried index with this JAX cascade."""
    from repro_torch.serving import pipeline as t_pipeline
    cfg = t_pipeline.ServingConfig(
        knob="rho", cutoffs=tiny_system.rho_cutoffs, rerank_depth=30,
        stream_cap=tiny_system.cfg.stream_cap, kernel_block_p=64,
        kernel_block_d=512)
    return t_pipeline.RetrievalServer(carry_index(tiny_system),
                                      _port_cascade(jcasc), cfg,
                                      device="cpu")


def test_hot_swap_bit_identical_to_restart(tiny_system):
    ja, jb = (_random_labels_cascade(tiny_system, s) for s in (0, 1))
    server = _server_with(tiny_system, ja)
    qt1 = tiny_system.queries.terms[:16]
    qt2 = tiny_system.queries.terms[16:32]
    server.serve_batch(qt1)
    store = PredictorStore(_port_cascade(ja),
                           [server.cfg.threshold] * ja.n_cutoffs,
                           device="cpu")
    store.publish(_port_cascade(jb), [server.cfg.threshold] * jb.n_cutoffs)
    assert store.install(server) == 1 == server.predictor_version
    swapped = server.serve_batch(qt2)
    restarted = _server_with(tiny_system, jb).serve_batch(qt2)
    np.testing.assert_array_equal(swapped["classes"], restarted["classes"])
    np.testing.assert_array_equal(swapped["ranked"], restarted["ranked"])


def test_swap_rejections(tiny_system):
    ja = _random_labels_cascade(tiny_system, 0)
    server = _server_with(tiny_system, ja)
    fewer = t_cascade.train_cascade(
        tiny_system.features, np.ones(tiny_system.features.shape[0],
                                      np.int64),
        n_cutoffs=ja.n_cutoffs, forest_kwargs=dict(n_trees=3, max_depth=4),
        device="cpu")
    with pytest.raises(ValueError, match="mismatch|differ"):
        server.swap_predictor(fewer.node_params)
    with pytest.raises(ValueError, match="thresholds"):
        server.swap_predictor(server._live["rho"][0], thresholds=[0.5, 0.5])
    bare = bare_servers(tiny_system, carry_index(tiny_system), "rho")[1]
    with pytest.raises(RuntimeError, match="no cascade"):
        bare.swap_predictor([])
    svc = t_service.RetrievalService(t_service.EngineBackend(bare))
    with pytest.raises(ValueError, match="trained cascade"):
        OnlineController(svc, bare)


# --------------------------------------------------------- warm refits --

@pytest.mark.parametrize("warm_frac", [0.0, 0.4, 1.0])
def test_train_forest_warm_and_cold_equal_jax(tiny_system, warm_frac):
    x = tiny_system.features
    y = np.random.default_rng(5).integers(0, 2, x.shape[0])
    jw = j_forest.train_forest(x, y, n_classes=2, n_trees=5, max_depth=4,
                               seed=1)
    tw = t_forest.train_forest(x, y, n_classes=2, n_trees=5, max_depth=4,
                               seed=1)
    y2 = np.random.default_rng(6).integers(0, 2, x.shape[0])
    jf = j_forest.train_forest(x, y2, n_classes=2, n_trees=5, max_depth=4,
                               seed=2, warm=jw, warm_frac=warm_frac)
    tf = t_forest.train_forest(x, y2, n_classes=2, n_trees=5, max_depth=4,
                               seed=2, warm=tw, warm_frac=warm_frac)
    for k in ("feature", "thresh", "left", "right", "leaf"):
        np.testing.assert_array_equal(getattr(tf, k), getattr(jf, k))
    n_carry = round(warm_frac * 5)
    w = min(tw.feature.shape[1], tf.feature.shape[1])
    np.testing.assert_array_equal(tf.feature[:n_carry, :w],
                                  tw.feature[:n_carry, :w])
    with pytest.raises(ValueError, match="swap-compatible"):
        t_forest.train_forest(x, y2, n_classes=2, n_trees=5, max_depth=6,
                              warm=tw, warm_frac=0.5)


@pytest.mark.parametrize("warm_frac", [0.0, 0.6])
def test_train_cascade_warm_equals_jax(tiny_system, warm_frac):
    x = tiny_system.features
    cuts = tiny_system.rho_cutoffs
    la = np.random.default_rng(3).integers(0, len(cuts) + 1, x.shape[0])
    lb = np.random.default_rng(4).integers(0, len(cuts) + 1, x.shape[0])
    kw = dict(n_cutoffs=len(cuts), forest_kwargs=FOREST_KW)
    ja = j_cascade.train_cascade(x, la, seed=1, **kw)
    ta = t_cascade.train_cascade(x, la, seed=1, device="cpu", **kw)
    jb = j_cascade.train_cascade(x, lb, seed=7, warm=ja,
                                 warm_frac=warm_frac, **kw)
    tb = t_cascade.train_cascade(x, lb, seed=7, warm=ta,
                                 warm_frac=warm_frac, device="cpu", **kw)
    _assert_tables_equal(_tables(tb), _tables(jb))
    with pytest.raises(ValueError, match="warm-start"):
        t_cascade.train_cascade(x, lb, n_cutoffs=len(cuts) - 1, warm=ta,
                                warm_frac=0.5, forest_kwargs=FOREST_KW,
                                device="cpu")


def _shadow_batch(cls, sys_, lo, rng):
    n = 16
    med = np.sort(rng.uniform(0, 0.2, (n, len(sys_.rho_cutoffs))),
                  axis=1)[:, ::-1].copy()
    return cls(features=np.asarray(sys_.features[lo:lo + n]), med=med,
               observed_med=med[:, -1], served_class=np.zeros(n, np.int64),
               predictor_version=np.zeros(n, np.int64), t_wall=0.0,
               max_seq=lo + n)


def test_trainer_warm_frac_uses_previous_fit(tiny_system):
    """The trainer carries trees from its own previous refit, and each
    refit's tables and thresholds equal the JAX trainer's."""
    sys_ = tiny_system
    cfg = dict(window=64, min_labels=16, retrain_every=16,
               forest_kwargs=FOREST_KW, warm_frac=0.6)
    tr = CascadeTrainer(TrainerConfig(**cfg), sys_.rho_cutoffs,
                        device="cpu")
    jtr = JCascadeTrainer(JTrainerConfig(**cfg), sys_.rho_cutoffs)
    fits = []
    for trainer, batch_cls in ((tr, ShadowBatch), (jtr, JShadowBatch)):
        rng = np.random.default_rng(0)
        out = []
        for lo in (0, 16):
            trainer.add(_shadow_batch(batch_cls, sys_, lo, rng))
            assert trainer.should_retrain()
            out.append(trainer.retrain(tau=0.1))
        fits.append(out)
    for (tc, tt), (jc, jt) in zip(*fits):
        _assert_tables_equal(_tables(tc), _tables(jc))
        np.testing.assert_array_equal(tt, jt)
    (c1, _), (c2, _) = fits[0]
    n_carry = round(0.6 * FOREST_KW["n_trees"])
    w = min(c1.nodes[0].feature.shape[1], c2.nodes[0].feature.shape[1])
    np.testing.assert_array_equal(c2.nodes[0].feature[:n_carry, :w],
                                  c1.nodes[0].feature[:n_carry, :w])
    assert tr.n_retrains == 2 and tr.window_size == 32


# --------------------------------------------------------------- drift --

def test_envelope_monitor_fallback_and_recovery():
    """The port's monitor makes the JAX monitor's decisions on the same
    observations: trip, hold, recover, then widen tau."""
    kw = dict(target=0.05, ema=1.0, min_obs=1, fallback_factor=3.0,
              recover_batches=2)
    mon, jmon = EnvelopeMonitor(DriftConfig(**kw)), JEnvelopeMonitor(
        JDriftConfig(**kw))
    obs = [0.5, 0.01, 0.01] + [0.001] * 8
    trail = []
    for m in (mon, jmon):
        trail.append([(d.tau, d.fallback) for d in
                      (m.observe(np.full(8, v)) for v in obs)])
    assert trail[0] == trail[1]
    fallbacks = [f for _, f in trail[0]]
    assert fallbacks[:3] == [True, True, False] and not any(fallbacks[3:])
    assert trail[0][-1][0] == pytest.approx(0.05 * 1.5)
    assert mon.n_fallbacks == 1
    with pytest.raises(ValueError):
        EnvelopeMonitor(DriftConfig(target=0.05, step=1.0))


# ---------------------------------------------------------- controller --

def test_controller_closes_the_loop_as_the_jax_controller(tiny_system):
    """serve -> telemetry -> shadow labels -> retrain -> hot swap, on the
    same stream through both packages: the same labels, retrains,
    swaps, published thresholds and tables, and the swapped server
    serves what the JAX server serves."""
    pair = carry_servers(tiny_system, knobs=("rho",))["rho"]
    jsvc, tsvc = _services(pair)
    ocfg = dict(tau=TAU, shadow_sample=16)
    tcfg = dict(min_labels=16, retrain_every=16, window=64,
                forest_kwargs=FOREST_KW, warm_frac=0.4)
    tctl = OnlineController(tsvc, pair[1], OnlineConfig(
        trainer=TrainerConfig(**tcfg), **ocfg))
    jctl = JOnlineController(jsvc, pair[0], JOnlineConfig(
        trainer=JTrainerConfig(**tcfg), **ocfg))
    assert pair[1].predictor_version == 0
    qt = tiny_system.queries.terms
    for lo in (0, 16, 32):
        for svc, ctl in ((tsvc, tctl), (jsvc, jctl)):
            svc.serve_all(list(qt[lo:lo + 16]))
            ctl.step()
        tx, tm = tctl.trainer.window()
        jx, jm = jctl.trainer.window()
        np.testing.assert_allclose(tm, jm, rtol=MED_RTOL, atol=MED_ATOL)
        assert _n_label_diffs(tm, jm, tctl.monitor.tau) == 0
        np.testing.assert_array_equal(tx, jx)   # see the docstring
    st, jst = tctl.stats(), jctl.stats()
    for k in ("n_labels", "n_retrains", "n_swaps", "predictor_version",
              "fallback", "n_fallbacks", "telemetry_seen"):
        assert st[k] == jst[k], k
    assert st["n_labels"] == 48 and st["n_retrains"] >= 2
    assert st["tau_effective"] == pytest.approx(jst["tau_effective"])
    assert pair[1].predictor_version == st["n_swaps"]
    tv, jv = tctl.store.current(), jctl.store.current()
    np.testing.assert_array_equal(tv.thresholds.numpy(),
                                  np.asarray(jv.thresholds))
    _assert_tables_equal(_tables(tv), _tables(jv))
    out = tsvc.serve_all(list(qt[48:64]))
    want = jsvc.serve_all(list(qt[48:64]))
    for r, w in zip(out, want):
        np.testing.assert_array_equal(r["ranked"], w["ranked"])
        assert r["class"] == w["class"]
        assert r["predictor_version"] == w["predictor_version"] > 0


def test_controller_thread_and_replay(tiny_system):
    """``replay`` interleaves inline steps; the idle-gated thread runs
    the same cycle in the background and stops cleanly."""
    pair = carry_servers(tiny_system, knobs=("rho",))["rho"]
    _, tsvc = _services(pair)
    ctl = OnlineController(tsvc, pair[1], OnlineConfig(
        tau=TAU, shadow_sample=16, shadow_period_s=0.0,
        trainer=TrainerConfig(min_labels=16, retrain_every=16, window=64,
                              forest_kwargs=FOREST_KW)))
    out = replay(tsvc, tiny_system.queries.terms[:32], chunk=16,
                 controller=ctl)
    assert len(out) == 32 and ctl.stats()["n_labels"] == 32
    tsvc.serve_all(list(tiny_system.queries.terms[32:48]))
    with ctl:
        for _ in range(2000):
            if ctl.stats()["n_labels"] == 48:
                break
            ctl._stop.wait(0.01)
    st = ctl.stats()
    assert st["n_labels"] == 48 and st["last_error"] is None
    assert ctl._thread is None and st["n_swaps"] >= 2


# -------------------------------------------------------------- replay --

@pytest.mark.parametrize("band", ["head", "tail", "long"])
def test_shifted_queries_bands_equal_jax(tiny_system, band):
    corpus = tiny_system.index.corpus
    tc = t_corpus.Corpus(corpus.config, corpus.doc_ids, corpus.term_ids,
                         corpus.counts, corpus.doc_len)
    got = shifted_queries(tc, 16, band=band, max_len=5)
    want = j_shifted_queries(corpus, 16, band=band, max_len=5)
    np.testing.assert_array_equal(got.terms, want.terms)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.seed == want.seed
    with pytest.raises(ValueError, match="band"):
        shifted_queries(tc, 4, band="nope")


# ----------------------------------------------------------------- CLI --

def test_serve_cli_online_prints_its_online_line():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--knob", "rho", "--batch", "30", "--batches", "3",
           "--n-docs", "2000", "--n-queries", "256", "--census", "",
           "--online", "--retrain-every", "32"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    line = [ln for ln in out.splitlines() if ln.startswith("online:")]
    assert len(line) == 1, out
    assert "labels=90 " in line[0] and "swaps=" in line[0]
    assert "last_error" not in line[0]
