"""The server's predict programs (``RetrievalServer.predict_programs``)
against the JAX server's jitted predicts, on the CPU.

On the CPU a program is the stage function itself (the card's CUDA
graphs are held in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s
phase 19), so these tests hold the cache's keys and counts: on the same
calls the port builds as many predict and margin programs a knob as the
JAX server's ``_predict_fns[knob]._cache_size()`` and
``_margin_fns[knob]._cache_size()``, through the server's, the
service's and the scheduler's warmups, and none on a swap; the engine's
own count stays the JAX engine's.  Both packages boot the same
JAX-trained cascades (forest and MLP nodes, the depth knob's forest)
over the carried index (``tests/_torch_carry.py``).

Tolerances: counts equal; classes equal (forest probabilities are bit
for bit the reference's, ``tests/test_torch_serving.py``; MLP nodes'
float32 products round differently in the two frameworks, and the fixed
seeds keep every probability off its threshold, as in
``tests/test_torch_mlp_server.py``); margins within 1e-6 (forest) and
1e-5 (MLP), those files' tolerances; a swapped server and a server
booted on the swapped cascade bit-equal.
"""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

from _torch_carry import carry_index
from repro.analysis import sanitizers as j_sanitizers
from repro.core import cascade as j_cascade
from repro.core import knobs as j_knobs
from repro.online import store as j_store
from repro.serving import admission as j_admission
from repro.serving import pipeline as j_pipeline
from repro.serving import service as j_service
from repro_torch import convert
from repro_torch.analysis import sanitizers as S
from repro_torch.online.store import PredictorStore
from repro_torch.serving import admission as t_admission
from repro_torch.serving import pipeline as t_pipeline
from repro_torch.serving import programs as t_programs
from repro_torch.serving import service as t_service

FOREST_KW = dict(n_trees=4, max_depth=4)
MLP_KW = dict(hidden=(16,), epochs=3, batch=32)
MIXED = (3, 8, 11, 16)


def _train(sys_, n_cutoffs, kind, seed):
    """A JAX cascade on synthetic labels (the mechanics under test do
    not care how good it is; random labels still spread the classes)."""
    labels = np.random.default_rng(seed).integers(
        0, n_cutoffs + 1, sys_.features.shape[0])
    return j_cascade.train_cascade(
        sys_.features, labels, n_cutoffs=n_cutoffs, kind=kind, seed=seed,
        forest_kwargs=FOREST_KW, mlp_kwargs=MLP_KW)


def _nodes(casc):
    return [jax.tree.map(np.array, p) for p in casc.node_params]


def _port(casc):
    return convert.cascade_from_numpy(casc.kind, _nodes(casc),
                                      casc.max_depth, casc.n_cutoffs,
                                      device="cpu")


@pytest.fixture(scope="module")
def carried(tiny_system):
    return tiny_system, carry_index(tiny_system)


def _servers(carried, casc, knob, *, depth_cascade=None, **kw):
    """(JAX server, port server) booted on the same cascade(s)."""
    sys_, tindex = carried
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    cfg = dict(knob=knob, cutoffs=cuts, rerank_depth=30,
               stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
               kernel_block_d=512)
    if depth_cascade is not None:
        cfg["depth_cutoffs"] = j_knobs.depth_cutoffs(int(max(cuts)))
    js = j_pipeline.RetrievalServer(
        sys_.index, casc, j_pipeline.ServingConfig(use_kernel=False, **cfg),
        depth_cascade=depth_cascade, **kw)
    ts = t_pipeline.RetrievalServer(
        tindex, _port(casc), t_pipeline.ServingConfig(**cfg),
        depth_cascade=(None if depth_cascade is None
                       else _port(depth_cascade)), device="cpu", **kw)
    return js, ts


def _counts(js, ts, knob):
    """{(function, package): programs} of one knob."""
    return {("predict", "jax"): js._predict_fns[knob]._cache_size(),
            ("predict", "port"): ts.predict_programs.built(f"predict:{knob}"),
            ("margin", "jax"): js._margin_fns[knob]._cache_size(),
            ("margin", "port"): ts.predict_programs.built(f"margin:{knob}")}


def _assert_counts(js, ts, knob, predict, margin):
    got = _counts(js, ts, knob)
    assert got == {("predict", "jax"): predict, ("predict", "port"): predict,
                   ("margin", "jax"): margin, ("margin", "port"): margin}


@pytest.mark.parametrize("knob", ["rho", "k"])
@pytest.mark.parametrize("kind", ["forest", "mlp"])
def test_server_warmup_builds_the_jax_servers_predicts(carried, kind, knob):
    """``warmup_batch_sizes=(8, 16)`` builds a predict a knob and padded
    shape, as the JAX server compiles; mixed batches of 3, 8, 11 and 16
    rows then build nothing and predict the JAX classes; the margins
    build a program a shape of their own."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    n_cut = len(sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs)
    casc = _train(sys_, n_cut, kind, seed=1)
    js, ts = _servers(carried, casc, knob, warmup_batch_sizes=(8, 16),
                      warmup_query_len=terms.shape[1])
    _assert_counts(js, ts, knob, predict=2, margin=0)
    assert ts.engine.n_compiles == js.engine.n_compiles > 0
    base = ts.engine.n_compiles
    seen = set()
    with S.compile_sentinel(ts.predict_programs) as rec, \
            j_sanitizers.compile_sentinel(js._predict_fns[knob]):
        for i, n in enumerate(MIXED):
            qt = terms[5 * i:5 * i + n]
            got = ts.predict_classes(qt)
            np.testing.assert_array_equal(got, js.predict_classes(qt))
            seen |= set(got.tolist())
    assert rec.new_compiles == 0 and len(seen) > 1
    for n in (3, 16, 5):
        qt = terms[:n]
        np.testing.assert_allclose(
            ts.predict_margin(qt), js.predict_margin(qt), rtol=0,
            atol=1e-6 if kind == "forest" else 1e-5)
    _assert_counts(js, ts, knob, predict=2, margin=2)
    assert ts.predict_programs.n_compiles == 4
    assert ts.engine.n_compiles == js.engine.n_compiles == base
    assert ts.predict_programs.stats() == {
        "programs": 4, "graphs": 0, "replays": 0, "static_bytes": 0}


def test_service_and_scheduler_warmups_and_swaps_build_as_jax(carried):
    """The service's ``warmup_now([8, 16])`` and the scheduler's warmup
    build the JAX predicts (the scheduler's at every candidate-window
    width), and swaps interleaved with mixed batches build no predict
    program, with the JAX classes and versions (the JAX online test of
    swaps and compile counts, on the port)."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    qlen = terms.shape[1]
    n_cut = len(sys_.k_cutoffs)
    boot = _train(sys_, n_cut, "forest", seed=2)
    pair = _servers(carried, boot, "k")
    services = []
    for mod, adm, server in ((j_service, j_admission, pair[0]),
                             (t_service, t_admission, pair[1])):
        svc = mod.RetrievalService(
            mod.EngineBackend(server, query_len=qlen),
            adm.AdmissionConfig(max_batch=16, pad_multiple=8))
        svc.warmup_now([8, 16])
        services.append(svc)
    js, ts = pair
    _assert_counts(js, ts, "k", predict=2, margin=0)
    engine_base = ts.engine.n_compiles
    assert engine_base == js.engine.n_compiles > 0
    thr = [ts.cfg.threshold] * n_cut
    stores = (j_store.PredictorStore(boot, thr),
              PredictorStore(_port(boot), thr, device="cpu"))
    with S.compile_sentinel(ts.predict_programs, ts.engine) as rec:
        for i, n in enumerate((3, 8, 11, 16)):
            new = _train(sys_, n_cut, "forest", seed=10 + i)
            outs = []
            for svc, store, casc in zip(services, stores, (new, _port(new))):
                store.publish(casc, thr)       # pads to the template
                cur = store.current()
                svc.swap_predictor(cur.node_params, cur.thresholds,
                                   version=cur.version)
                outs.append(svc.serve_all(list(terms[:n])))
            for a, b in zip(*outs):
                assert a["class"] == b["class"]
                assert a["predictor_version"] == b["predictor_version"] \
                    == i + 1
                np.testing.assert_array_equal(a["ranked"], b["ranked"])
    assert rec.new_compiles == 0
    _assert_counts(js, ts, "k", predict=2, margin=0)
    # the continuous scheduler's warmup: a predict at every padded
    # candidate-window width (8, 16, 24), as the JAX scheduler's
    js, ts = _servers(carried, boot, "k")
    built = []
    for mod, server in ((j_service, js), (t_service, ts)):
        backend = mod.ContinuousBackend(server, query_len=qlen, slots=8,
                                        grain=4, window=24)
        mod.RetrievalService(backend)
        built.append(backend.scheduler.warmup())
    assert built[0] == built[1] > 0
    _assert_counts(js, ts, "k", predict=3, margin=0)


def test_depth_knob_predicts_are_warmed_as_jax(carried):
    """With a depth cascade the server warms both knobs' predicts, the
    service's warmup of a new shape builds both, and the depth classes
    are the JAX server's."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    qlen = terms.shape[1]
    n_cut = len(sys_.k_cutoffs)
    grid = j_knobs.depth_cutoffs(int(max(sys_.k_cutoffs)))
    casc = _train(sys_, n_cut, "forest", seed=3)
    dcasc = _train(sys_, len(grid), "forest", seed=53)
    js, ts = _servers(carried, casc, "k", depth_cascade=dcasc,
                      warmup_batch_sizes=(8,), warmup_query_len=qlen)
    for knob in ("k", "depth"):
        _assert_counts(js, ts, knob, predict=1, margin=0)
    assert ts.engine.n_compiles == js.engine.n_compiles
    built = [mod.EngineBackend(s, query_len=qlen).warmup_shape(24)
             for mod, s in ((j_service, js), (t_service, ts))]
    assert built[0] == built[1] > 0
    for knob in ("k", "depth"):
        _assert_counts(js, ts, knob, predict=2, margin=0)
    qt = terms[:24]
    want, got = js.predict_depths(qt), ts.predict_depths(qt)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(ts.serve_batch(qt)["ranked"],
                                  js.serve_batch(qt)["ranked"])
    for knob in ("k", "depth"):
        _assert_counts(js, ts, knob, predict=2, margin=0)


@pytest.mark.parametrize("kind", ["forest", "mlp"])
def test_a_swapped_server_predicts_as_one_booted_on_the_new_cascade(
        carried, kind):
    """``PredictorStore.install`` swaps the new tables in: nothing is
    built, ``_live`` keeps its per-node form, and classes, margins and
    ranked lists equal a fresh server booted on the new cascade, bit for
    bit."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    n_cut = len(sys_.rho_cutoffs)
    a, b = (_port(_train(sys_, n_cut, kind, seed=s)) for s in (4, 5))
    tindex = carried[1]
    cfg = t_pipeline.ServingConfig(
        knob="rho", cutoffs=sys_.rho_cutoffs, rerank_depth=30,
        stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
        kernel_block_d=512)
    server = t_pipeline.RetrievalServer(tindex, a, cfg, device="cpu")
    qt = terms[:16]
    server.predict_classes(qt)
    server.predict_margin(qt)
    n0 = server.predict_programs.n_compiles
    store = PredictorStore(a, [cfg.threshold] * n_cut, device="cpu")
    store.publish(b, [cfg.threshold] * n_cut)
    with S.compile_sentinel(server.predict_programs):
        assert store.install(server) == 1 == server.predictor_version
        swapped = (server.predict_classes(qt), server.predict_margin(qt),
                   server.serve_batch(qt)["ranked"])
    fresh = t_pipeline.RetrievalServer(tindex, b, cfg, device="cpu")
    booted = (fresh.predict_classes(qt), fresh.predict_margin(qt),
              fresh.serve_batch(qt)["ranked"])
    for x, y in zip(swapped, booted):
        np.testing.assert_array_equal(x, y)
    assert server.predict_programs.n_compiles == n0 == 2
    params, thr = server._live["rho"]
    assert len(params) == n_cut and thr.shape == (n_cut,)


def test_threads_predicting_one_new_shape_build_it_once(carried,
                                                         monkeypatch):
    """The pending marker: threads that miss the shape another thread is
    building wait for that build; each gets the same classes."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    casc = _port(_train(sys_, len(sys_.rho_cutoffs), "forest", seed=6))
    cfg = t_pipeline.ServingConfig(
        knob="rho", cutoffs=sys_.rho_cutoffs, rerank_depth=30,
        stream_cap=sys_.cfg.stream_cap)
    server = t_pipeline.RetrievalServer(carried[1], casc, cfg, device="cpu")
    builds = []
    real = t_programs.build_program

    def slow_build(name, *a, **kw):
        builds.append(name)
        time.sleep(0.05)                 # hold the key while others miss
        return real(name, *a, **kw)

    monkeypatch.setattr(t_programs, "build_program", slow_build)
    n_threads = 2 * (os.cpu_count() or 4)
    go = threading.Barrier(n_threads)
    out, errors = [None] * n_threads, []

    def predict(i):
        go.wait()
        try:
            out[i] = server.predict_classes(terms[:20])
        except Exception as e:           # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=predict, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert builds == ["predict:rho"]
    assert server.predict_programs.n_compiles == 1
    assert server.engine.n_compiles == 0
    for got in out[1:]:
        np.testing.assert_array_equal(got, out[0])


def test_the_version_is_read_with_the_weights(carried):
    """``predict_versioned`` reports the version whose tables the
    predict read: a swap landing during a predict runs it again on the
    new tables; a stand-in ``predict_classes`` is reached and reports
    the live version."""
    sys_ = carried[0]
    terms = sys_.queries.terms
    n_cut = len(sys_.rho_cutoffs)
    a = _port(_train(sys_, n_cut, "forest", seed=7))
    cfg = t_pipeline.ServingConfig(
        knob="rho", cutoffs=sys_.rho_cutoffs, rerank_depth=30,
        stream_cap=sys_.cfg.stream_cap)
    server = t_pipeline.RetrievalServer(carried[1], a, cfg, device="cpu")
    classes, v = server.predict_versioned(terms[:8])
    assert v == 0
    np.testing.assert_array_equal(classes, server.predict_classes(terms[:8]))
    real, calls = server.predict_classes, []

    def racing(qt, knob=None):
        calls.append(knob)
        if len(calls) == 1:       # a swap lands during the first predict
            server.swap_predictor(server._live["rho"][0], version=7)
        return real(qt, knob)

    server.predict_classes = racing
    assert server.predict_versioned(terms[:8])[1] == 7
    assert len(calls) == 2
    server.predict_classes = lambda qt, knob=None: np.zeros(len(qt))
    server.predictor_version = 9
    assert server.predict_versioned(terms[:8])[1] == 9
