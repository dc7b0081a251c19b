"""The port's service layer (admission, ``RetrievalService`` over the
engine and the funnel, ``WarmupPolicy``, ``ServerStats``) against the JAX
package's, on the CPU.

The JAX-built index and cascades are carried across by
``repro_torch.convert``, so both services serve the same postings and
forests.  Threaded runs enqueue every request before the workers start,
so batch composition is the FIFO chunking whatever the threads' timing
(stage-2 noise qids are batch positions: a ranked list depends on the
batch it rode in).  Tolerances, with their reasons:
  * admission: the same formed batches (payloads, triggers, padded sizes)
    under an injected clock -- pure batching logic.
  * engine backend: ranked lists, classes and widths equal, as
    ``tests/test_torch_serving.py`` demands of ``serve_batch``.
  * funnel backend: classes and k equal; ranked lists equal except where
    two items' stage-2 scores lie within 1e-5 (float32 products in
    another order than XLA's), as ``tests/test_torch_recsys.py`` allows.
"""

import gc
import math
import sys
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_carry import carry_servers
from repro.core import cascade as j_cascade
from repro.models.recsys import bst as j_bst
from repro.models.recsys import retrieval_tower as j_rt
from repro.serving import admission as j_admission
from repro.serving import funnel as j_funnel
from repro.serving import server as j_server
from repro.serving import service as j_service
from repro_torch import convert
from repro_torch.models.recsys import bst as t_bst
from repro_torch.models.recsys import retrieval_tower as t_rt
from repro_torch.obs import NULL_TRACE, MetricsRegistry, Observability
from repro_torch.serving import admission as t_admission
from repro_torch.serving import funnel as t_funnel
from repro_torch.serving import server as t_server
from repro_torch.serving import service as t_service

N = 37                      # batches 16 / 16 / 5 through max_batch 16
CHUNKS = ((0, 16), (16, 32), (32, 37))
ADMISSION = {"jax": j_admission, "torch": t_admission}
#: stage-2 scores of the two packages' funnels agree to ~1e-6
STAGE2_ATOL = 1e-5


# ------------------------------------------------- admission queue (pure) --

def _deadline_order(adm):
    q = adm.AdmissionQueue(adm.AdmissionConfig(
        max_batch=4, pad_multiple=4, max_wait_ms=1e6,
        service_estimate_ms=2.0))
    for i, d in enumerate([50.0, 10.0, 90.0, 30.0, 70.0, 20.0]):
        q.submit(("req", i, d), deadline_ms=d, now=0.0)
    b1 = q.poll(now=0.0)
    empty = q.poll(now=0.0)               # remainder not urgent yet
    b2 = q.poll(now=0.0685)               # 70 ms deadline enters the slack
    assert empty is None and len(q) == 0
    return [b1, b2]


def _full_and_wait(adm):
    q = adm.AdmissionQueue(adm.AdmissionConfig(
        max_batch=2, pad_multiple=2, max_wait_ms=5.0,
        service_estimate_ms=0.0))
    q.submit("a", deadline_ms=1e6, now=0.0)
    assert q.poll(now=0.0) is None
    q.submit("b", deadline_ms=1e6, now=0.001)
    b1 = q.poll(now=0.001)                # full batch fires at once
    q.submit("c", deadline_ms=1e6, now=0.002)
    assert q.poll(now=0.003) is None
    b2 = q.poll(now=0.0075)               # oldest waited max_wait_ms
    assert dict(q.shape_counts) == {2: 2}
    return [b1, b2]


def _urgent_and_requeue(adm):
    q = adm.AdmissionQueue(adm.AdmissionConfig(max_batch=8, pad_multiple=8))
    for i, d in enumerate([40.0, 10.0, 30.0, 20.0]):
        q.submit(i, deadline_ms=d, now=0.0)
    took = q.take_urgent(3)
    assert [r.payload for r in took] == [1, 3, 2]
    assert dict(q.shape_counts) == {}     # the slot path forms no batch
    q.requeue(took[1:])
    return q.flush(now=0.0)


def _shape(batches):
    return [(b.payloads, b.trigger, b.padded_size, len(b)) for b in batches]


@pytest.mark.parametrize("script,want", [
    (_deadline_order, [([("req", 1, 10.0), ("req", 5, 20.0),
                         ("req", 3, 30.0), ("req", 0, 50.0)], "full", 4, 4),
                       ([("req", 4, 70.0), ("req", 2, 90.0)],
                        "deadline", 4, 2)]),
    (_full_and_wait, [(["a", "b"], "full", 2, 2), (["c"], "wait", 2, 1)]),
    (_urgent_and_requeue, [([3, 2, 0], "flush", 8, 3)]),
])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_admission_forms_the_same_batches(pkg, script, want):
    assert _shape(script(ADMISSION[pkg])) == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_next_event_schedules_wakeups(pkg):
    adm = ADMISSION[pkg]
    q = adm.AdmissionQueue(adm.AdmissionConfig(
        max_batch=8, pad_multiple=8, max_wait_ms=5.0,
        service_estimate_ms=1.0))
    assert q.next_event(0.0) is None
    q.submit("a", deadline_ms=3.0, now=0.0)
    # min(wait bound 5 ms, deadline 3 ms - estimate 1 ms) = 2 ms
    assert q.next_event(0.0) == pytest.approx(0.002)
    assert q.next_event(0.0015) == pytest.approx(0.0005)
    assert q.next_event(0.01) == 0.0


# ------------------------------------------------------ engine backend --

@pytest.fixture(scope="module")
def servers(tiny_system):
    """One JAX and one port server per knob on the same carried index
    and JAX-trained cascade."""
    return carry_servers(tiny_system), tiny_system.queries.terms


def _serve(service_mod, server, qt, mode):
    service = service_mod.RetrievalService(
        service_mod.EngineBackend(server, query_len=qt.shape[1]),
        service_mod.AdmissionConfig(max_batch=16, pad_multiple=8))
    if mode == "inline":
        return service, service.serve_all(list(qt))
    # FIFO before start: the batches are 16 / 16 / 5 whatever the timing
    futs = service.submit_many(list(qt), deadline_ms=1e6)
    with service:
        return service, [f.result(timeout=120.0) for f in futs]


@pytest.mark.parametrize("mode", ["inline", "threaded"])
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_engine_service_matches_serve_batch_and_jax(servers, knob, mode):
    (js, ts), terms = servers[0][knob], servers[1]
    qt = terms[:N]
    service, got = _serve(t_service, ts, qt, mode)
    jservice, want = _serve(j_service, js, qt, mode)
    assert len(got) == len(want) == N
    assert dict(service.queue.shape_counts) == {16: 2, 8: 1}
    for lo, hi in CHUNKS:
        direct = ts.serve_batch(qt[lo:hi])
        for i in range(lo, hi):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g["ranked"],
                                          direct["ranked"][i - lo])
            np.testing.assert_array_equal(g["ranked"], w["ranked"])
            assert g["class"] == w["class"] == direct["classes"][i - lo]
            assert g["width"] == w["width"] == direct["widths"][i - lo]
            assert g["trace_id"] == w["trace_id"] == i
            assert g["total_ms"] >= g["service_ms"] > 0.0
    assert len(np.unique([r["class"] for r in got])) > 1
    stats = service.stats()
    assert stats.n_queries == N and stats.class_histogram.sum() == N
    assert len(stats.queue_ms) == N and len(stats.service_ms) == 3
    # the same calls on both servers so far: the same programs built
    assert stats.n_compiles == jservice.stats().n_compiles > 0


def test_reset_stats_and_handoff_depth_as_the_jax_service(servers):
    """``reset_stats`` drops the batch records (the deadline counters
    stay, as in the JAX package); after the same calls both services
    report the same stats.  The hand-off holds the JAX service's default
    depth."""
    (js, ts), terms = servers[0]["k"], servers[1]
    got, want = [], []
    for mod, server, out in ((t_service, ts, got), (j_service, js, want)):
        svc = mod.RetrievalService(
            mod.EngineBackend(server, query_len=terms.shape[1]),
            mod.AdmissionConfig(max_batch=16, pad_multiple=8))
        assert svc._handoff.maxsize == 2
        svc.serve_all(list(terms[:N]))
        svc.reset_stats()
        out.append(svc.stats())
        svc.serve_all(list(terms[N:N + 20]))
        out.append(svc.stats())
    for g, w in zip(got, want):
        # which deadlines are met depends on each run's speed; both
        # servers took the same calls, so built the same programs
        for name in ("n_queries", "mean_param", "n_cancelled",
                     "n_compiles"):
            gv, wv = getattr(g, name), getattr(w, name)
            assert gv == wv or (math.isnan(gv) and math.isnan(wv)), name
        np.testing.assert_array_equal(g.class_histogram, w.class_histogram)
        assert (len(g.latencies_ms), len(g.queue_ms), len(g.service_ms)) == (
            len(w.latencies_ms), len(w.queue_ms), len(w.service_ms))
    empty, after = got
    assert empty.n_queries == 0 and empty.latencies_ms == []
    assert empty.service_ms == [] and empty.stage_ms is None
    assert all(s.n_deadline_met + s.n_deadline_missed == n
               for s, n in zip(got + want, (N, N + 20) * 2))
    assert after.n_queries == 20 and len(after.service_ms) == 2


def test_partial_and_oversized_streams_round_trip_pad_grid(servers):
    """Streams of every size from 1 to 40 through max_batch 16: each
    future holds the row a direct serve_batch of its micro-batch gives,
    and every formed batch lies on the pad grid."""
    (_, ts), terms = servers[0]["rho"], servers[1]
    service = t_service.RetrievalService(
        t_service.EngineBackend(ts),
        t_admission.AdmissionConfig(max_batch=16, pad_multiple=8))
    for n in (1, 7, 8, 9, 16, 17, 40):
        qt = terms[:n]
        got = service.serve_all(list(qt))
        for lo in range(0, n, 16):
            direct = ts.serve_batch(qt[lo:lo + 16])
            np.testing.assert_array_equal(
                np.stack([r["ranked"] for r in got[lo:lo + 16]]),
                direct["ranked"])
    assert set(service.queue.shape_counts) == {8, 16}
    assert service.stats().n_queries == 1 + 7 + 8 + 9 + 16 + 17 + 40


@pytest.mark.parametrize("where", ["predict", "execute"])
@pytest.mark.parametrize("mode", ["inline", "threaded"])
def test_backend_errors_reach_the_futures(servers, where, mode):
    (_, ts), terms = servers[0]["k"], servers[1]
    backend = t_service.EngineBackend(ts)

    def boom(*_):
        raise RuntimeError("boom")

    setattr(backend, where, boom)
    service = t_service.RetrievalService(
        backend, t_admission.AdmissionConfig(max_batch=4, pad_multiple=4))
    futs = service.submit_many(list(terms[:6]))
    if mode == "inline":
        service.flush()
        while service.step():
            pass
    else:
        with service:
            for f in futs:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=30.0)
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=30.0)
    assert service.outstanding == 0


@pytest.mark.parametrize("faulty", [False, True])
def test_telemetry_tap_sees_each_resolved_request(servers, faulty):
    """The duck-typed ``telemetry=`` tap gets one record per request
    after its future resolved; a recorder that raises loses its records
    and nothing else."""
    (_, ts), terms = servers[0]["rho"], servers[1]

    class Tap:
        def __init__(self):
            self.rows = []

        def record(self, payload, result, version, t_wall):
            if faulty:
                raise ValueError("tap failed")
            self.rows.append((tuple(payload), result["trace_id"], version))

    tap = Tap()
    service = t_service.RetrievalService(
        t_service.EngineBackend(ts),
        t_admission.AdmissionConfig(max_batch=8, pad_multiple=8),
        telemetry=tap)
    got = service.serve_all(list(terms[:11]))
    assert [r["trace_id"] for r in got] == list(range(11))
    want = [] if faulty else [(tuple(terms[i]), i, 0) for i in range(11)]
    assert tap.rows == want


def test_warmup_census_save_and_load(servers, tmp_path):
    path = str(tmp_path / "census" / "warmup_census.json")
    policy = t_service.WarmupPolicy(census_path=path, max_shapes=4)
    for s in (16, 16, 8, 24, 16, 8):
        policy.observe(s)
    assert policy.save_census() == path
    reloaded = t_service.WarmupPolicy(census_path=path, max_shapes=4)
    # history fills at most half the slots, most common first
    assert reloaded.load_census() == [16, 8]
    assert reloaded.counts == {16: 3, 8: 2, 24: 1}
    assert reloaded.top_shapes(2) == [16, 8]
    (tmp_path / "census" / "warmup_census.json").write_text("{not json")
    assert t_service.WarmupPolicy(census_path=path).load_census() == []
    assert t_service.WarmupPolicy(census_path=None).save_census() is None
    # a service saves its census on stop() and the next one reloads it
    (_, ts), terms = servers[0]["k"], servers[1]
    svc = t_service.RetrievalService(
        t_service.EngineBackend(ts),
        t_admission.AdmissionConfig(max_batch=16, pad_multiple=8),
        warmup=t_service.WarmupPolicy(census_path=path))
    svc.serve_all(list(terms[:5]))
    svc.stop()
    nxt = t_service.WarmupPolicy(census_path=path)
    assert nxt.load_census() == [8]


def test_compile_count_stays_zero_within_the_warmed_grid(servers):
    """After the grid is warm, traffic within it builds nothing, and the
    port's engine holds as many programs as the JAX engine after the
    same calls."""
    (js, ts), terms = servers[0]["k"], servers[1]
    counts = []
    for mod, adm, server in ((t_service, t_admission, ts),
                             (j_service, j_admission, js)):
        backend = mod.EngineBackend(server)
        service = mod.RetrievalService(
            backend, adm.AdmissionConfig(max_batch=16, pad_multiple=8))
        assert service.warmup_now([8, 16]) == 0      # query length unknown
        backend.collate([terms[0]])
        assert service.warmup_now([8, 16]) == 2
        assert service.warmup.compiled == {8, 16}
        warm = server.engine.n_compiles
        for n in (3, 5, 8, 11, 16, 13, 4):
            service.serve_all(list(terms[:n]))
        assert set(service.queue.shape_counts) <= {8, 16}
        assert server.engine.n_compiles == warm
        assert service.stats().n_compiles == warm
        # the background policy finds every observed shape already warm
        assert service.warmup.run(backend) == 0
        counts.append(warm)
    assert counts[0] == counts[1] > 0


# ------------------------------------------- the collector's freeze --

def _rho_service(servers, obs=None):
    (_, ts), terms = servers[0]["rho"], servers[1]
    return t_service.RetrievalService(
        t_service.EngineBackend(ts, query_len=terms.shape[1]),
        t_admission.AdmissionConfig(max_batch=16, pad_multiple=8),
        obs=obs), terms


def _base_freeze() -> int:
    """The frozen count with no service running: the interpreter keeps
    its immortal objects in the frozen generation, and a full collection
    puts back those that an unfreeze let out."""
    gc.collect()
    return gc.get_freeze_count()


@pytest.mark.parametrize("drain", [True, False])
def test_started_service_freezes_the_heap_until_stop(servers, drain):
    """A started service serves with the set-up heap frozen out of the
    collector; ``stop()`` gives it back on the drain and the abort path."""
    service, terms = _rho_service(servers)
    before = _base_freeze()
    service.start()
    try:
        assert gc.get_freeze_count() > before
        futs = service.submit_many(list(terms[:5]), deadline_ms=1e6)
        service.flush()
        assert all(f.result(timeout=60.0)["ranked"].size for f in futs)
    finally:
        service.stop(drain=drain)
    assert _base_freeze() == before
    service.stop()                       # a second stop holds nothing
    assert _base_freeze() == before


def test_the_freeze_is_held_until_the_last_service_stops(servers):
    a, _ = _rho_service(servers)
    b, _ = _rho_service(servers)
    before = _base_freeze()
    try:
        a.start()
        assert gc.get_freeze_count() > before
        b.start()
        a.stop()
        assert _base_freeze() > before
    finally:
        a.stop()
        b.stop()
    assert _base_freeze() == before


def test_a_restarted_service_freezes_again(servers):
    service, _ = _rho_service(servers)
    before = _base_freeze()
    for _ in range(2):
        service.start()
        try:
            assert gc.get_freeze_count() > before
        finally:
            service.stop()
        assert _base_freeze() == before


def test_inline_serving_does_not_freeze(servers):
    service, terms = _rho_service(servers)
    before = _base_freeze()
    assert len(service.serve_all(list(terms[:5]))) == 5
    service.stop()
    assert gc.get_freeze_count() == before


class _Cycle:
    pass


def test_start_collects_set_up_garbage_before_it_freezes(servers):
    """A cycle dropped before ``start()`` is freed by its collection, not
    kept for good in the frozen heap."""
    service, _ = _rho_service(servers)
    node = _Cycle()
    node.self = node
    ref = weakref.ref(node)
    gc.collect()                 # the cycle now waits in the eldest gen
    del node
    assert ref() is not None
    service.start()
    try:
        assert ref() is None
    finally:
        service.stop()


def test_gc_frozen_gauge_reads_what_the_service_froze(servers):
    obs = [Observability(trace=NULL_TRACE, metrics=MetricsRegistry())
           for _ in range(2)]
    a, _ = _rho_service(servers, obs[0])
    b, _ = _rho_service(servers, obs[1])
    before = _base_freeze()
    try:
        a.start()
        # frozen objects only leave (freed) until the unfreeze
        frozen = gc.get_freeze_count()
        b.start()
        got = [o.metrics.snapshot()["gauges"]["service.gc_frozen"]
               for o in obs]
    finally:
        a.stop()
        b.stop()
    assert got[0] >= frozen > before and got[1] == 0


def test_freeze_holds_from_many_threads_balance():
    """Holds taken and dropped from more threads than cores, switching
    often: the heap is frozen while a hold is held, and no hold is left
    behind."""
    before = _base_freeze()
    n_threads, rounds = 16, 8
    gate = threading.Barrier(n_threads)
    unfrozen_while_held = []

    def churn():
        gate.wait(timeout=60.0)
        for _ in range(rounds):
            t_service._hold_freeze()
            if gc.get_freeze_count() <= before:
                unfrozen_while_held.append(threading.get_ident())
            t_service._release_freeze()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not unfrozen_while_held
    assert t_service._freeze_holders == 0
    assert _base_freeze() == before


# ------------------------------------------------------ funnel backend --

@pytest.fixture(scope="module")
def funnels():
    """The tiny funnel of tests/test_service.py in both packages, on the
    same parameters and the JAX-trained cascade."""
    tower_kw = dict(d_user_in=8, embed_dim=8, hidden=(16,), n_candidates=500)
    bst_kw = dict(embed_dim=8, seq_len=6, n_heads=2, item_vocab=500,
                  n_profile=4, mlp=(16, 8))
    fkw = dict(cutoffs=(10, 20, 50), pool_depth=100, eval_depth=20, tau=0.05)
    jcfg = j_funnel.FunnelConfig(tower=j_rt.TowerConfig(**tower_kw),
                                 bst=j_bst.BSTConfig(**bst_kw), **fkw)
    tcfg = t_funnel.FunnelConfig(tower=t_rt.TowerConfig(**tower_kw),
                                 bst=t_bst.BSTConfig(**bst_kw), **fkw)
    tower = j_rt.init_tower(jcfg.tower, seed=0)
    bst = j_bst.init_bst(jcfg.bst, seed=1)
    rng = np.random.default_rng(0)
    uf = rng.normal(size=(32, 8)).astype(np.float32)
    hist = rng.integers(-1, 500, (32, 6)).astype(np.int32)
    gold, runs = j_funnel.funnel_gold_runs(jcfg, tower, bst,
                                           jnp.asarray(uf), jnp.asarray(hist))
    labels, _ = j_funnel.label_requests(jcfg, gold, runs)
    feats = np.asarray(j_funnel.request_features(jnp.asarray(uf),
                                                 jnp.asarray(hist)))
    casc = j_cascade.train_cascade(feats, labels, n_cutoffs=len(jcfg.cutoffs),
                                   forest_kwargs=dict(n_trees=4, max_depth=4))
    tcasc = convert.cascade_from_numpy(
        "forest", [{k: np.asarray(v) for k, v in p.items()}
                   for p in casc.node_params],
        casc.max_depth, casc.n_cutoffs, device="cpu")
    jf = j_funnel.Funnel(jcfg, tower, bst, casc)
    tf = t_funnel.Funnel(tcfg, convert.tower_from_numpy(tower, device="cpu"),
                         convert.bst_from_numpy(bst, device="cpu"), tcasc,
                         device="cpu")
    return jf, tf, uf, hist


def _funnel_scores(tf, uf, hist, ks):
    """Per request {item: stage-2 score} as the port's execute scores
    them (the pool of max(k), each request over its own k)."""
    import torch
    ids, vals = t_rt.retrieve_topk(tf.tower_params, tf.cfg.tower,
                                   torch.from_numpy(uf), int(ks.max()))
    s2 = t_funnel._bst_scores(tf.bst_params, tf.cfg.bst,
                              torch.from_numpy(hist), ids, vals,
                              norm_width=torch.from_numpy(ks))
    return [dict(zip(i.tolist(), s.tolist())) for i, s in zip(ids, s2)]


@pytest.mark.parametrize("mode", ["inline", "threaded"])
@pytest.mark.parametrize("n", [16, 5])
def test_funnel_backend_matches_jax(funnels, n, mode):
    jf, tf, uf, hist = funnels
    payloads = [(uf[i], hist[i]) for i in range(n)]

    def serve(mod, funnel):
        service = mod.RetrievalService(
            mod.FunnelBackend(funnel, pad_multiple=8),
            mod.AdmissionConfig(max_batch=16, pad_multiple=8))
        if mode == "inline":
            return service, service.serve_all(payloads)
        futs = service.submit_many(payloads, deadline_ms=1e6)
        with service:
            return service, [f.result(timeout=120.0) for f in futs]

    service, got = serve(t_service, tf)
    _, want = serve(j_service, jf)
    assert dict(service.queue.shape_counts) == {16 if n == 16 else 8: 1}
    ks = np.array([r["width"] for r in got], np.int64)
    assert [r["class"] for r in got] == [r["class"] for r in want]
    assert ks.tolist() == [r["width"] for r in want]
    g = np.stack([r["ranked"] for r in got])
    w = np.stack([r["ranked"] for r in want])
    assert g.shape == (n, tf.cfg.eval_depth)
    scores = _funnel_scores(tf, uf[:n], hist[:n], ks)
    for q, i in zip(*np.nonzero(g != w)):
        a, b = int(g[q, i]), int(w[q, i])
        assert a >= 0 and b >= 0
        assert abs(scores[q][a] - scores[q][b]) <= STAGE2_ATOL
    if n == 16:                 # grid-aligned: the port's own serve, bit
        direct = tf.serve(uf[:16], hist[:16])   # for bit
        np.testing.assert_array_equal(g, direct["ranked"])
        np.testing.assert_array_equal(ks, direct["k"])
    stats = service.stats()
    assert stats.n_queries == n and math.isfinite(stats.mean_param)
    assert stats.n_compiles is None
    assert set(stats.stage_ms) == {"funnel_ms"}


def test_funnel_backend_warmup_shape(funnels):
    _, tf, _, _ = funnels
    backend = t_service.FunnelBackend(tf, pad_multiple=8)
    assert backend.warmup_shape(8) == len(tf.cfg.cutoffs)
    assert backend.warmup_shape(8) == 0


# ---------------------------------------------------------- ServerStats --

@pytest.mark.parametrize("kw", [
    dict(),
    dict(stage_ms={"gather_ms": {"mean": 1.25, "p99": 3.5, "n": 4},
                   "stage1_ms": {"mean": 0.75, "p99": 0.75, "n": 1}},
         n_compiles=0, queue_ms=[0.1, 0.4, 0.2], service_ms=[2.0, 3.0],
         n_deadline_met=2, n_deadline_missed=1, n_cancelled=3,
         pct_in_envelope=0.875),
])
def test_server_stats_render_as_the_jax_package(kw):
    args = dict(n_queries=3, latencies_ms=[1.0, 2.0, 7.5], mean_param=42.0,
                class_histogram=np.array([1, 2]), pct_in_envelope=None)
    args.update(kw)
    got, want = t_server.ServerStats(**args), j_server.ServerStats(**args)
    assert got.summary() == want.summary()
    assert got.p99_ms == want.p99_ms
    assert (math.isnan(got.deadline_met) and math.isnan(want.deadline_met)
            or got.deadline_met == want.deadline_met)


def test_percentiles_of_nothing_are_nan():
    stats = t_server.ServerStats(n_queries=0, latencies_ms=[],
                                 mean_param=float("nan"),
                                 class_histogram=np.zeros(2),
                                 pct_in_envelope=None)
    assert math.isnan(stats.p50_ms) and math.isnan(stats.p99_ms)
    assert math.isnan(t_server._pct([], 50))
    assert math.isnan(stats.deadline_met)
