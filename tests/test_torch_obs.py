"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and the spans the port's service and engine
record.

Tolerance: equality.  The recorders and registries are pure host code
on an injected clock, so the same scripted operations give the same
counts, spans, Chrome traces and Prometheus text in both packages; a
service run gives the same span names and counter values (times differ
and are not compared).
"""

import collections
import threading
import types

import numpy as np
import pytest

from _torch_carry import carry_servers
from repro import obs as j_obs
from repro.obs import export as j_export
from repro.serving import service as j_service
from repro_torch import obs as t_obs
from repro_torch.obs import export as t_export
from repro_torch.serving import service as t_service

OBS = {"jax": (j_obs, j_export), "torch": (t_obs, t_export)}


def _script(obs_pkg):
    """One fixed sequence of span and metric operations on a ticking
    clock; returns (recorder, registry)."""
    t = [0.0]

    def clock():
        t[0] += 0.00125
        return t[0]

    trace = obs_pkg.TraceRecorder(capacity=8, clock=clock)
    metrics = obs_pkg.MetricsRegistry()
    with trace.span("engine.gather", qid=1, n=4):
        pass
    with pytest.raises(ValueError):
        with trace.span("engine.stage1"):
            raise ValueError("stage failed")
    h = trace.begin("request", qid=2)
    trace.end(h, deadline_met=True)
    trace.end(h)                            # idempotent
    trace.end(None)
    with trace.ctx(batch=3):
        with trace.ctx(tick=5):
            trace.record("queue", 0.5, 0.75, qid=4, trigger="flush")
        trace.event("swap", version=2)

    def worker():
        with trace.span("execute", n=2):
            pass

    th = threading.Thread(target=worker, name="svc-exec")
    th.start()
    th.join()
    for i in range(6):                      # overflow the ring of 8
        trace.record("slot", i, i + 0.5, slot=i)
    metrics.counter("service.batches").inc(3)
    metrics.counter("engine.dispatches").inc()
    metrics.gauge("queue.depth").set(7)
    hist = metrics.histogram("service.total_ms")
    for x in (0.001, 0.02, 0.5, 3.0, 3.0, 1e9):
        hist.observe(x)
    return trace, metrics


def _spans(trace):
    return [(h.name, h.qid, h.slot, h.tick, h.t0, h.t1, h.tid, h.attrs)
            for h in trace.spans()]


def test_scripted_spans_and_metrics_match_jax():
    (jt, jm), (tt, tm) = _script(j_obs), _script(t_obs)
    assert tt.counts() == jt.counts()
    assert tt.counts()["n_dropped"] == 4 and tt.counts()["n_open"] == 0
    assert _spans(tt) == _spans(jt)
    assert tt.thread_names() == jt.thread_names()
    assert tm.counters() == jm.counters()
    assert tm.snapshot() == jm.snapshot()
    hist = "service.total_ms"
    for q in (0.0, 0.5, 0.99, 1.0):
        assert (tm.histogram(hist).quantile(q)
                == jm.histogram(hist).quantile(q))
    assert t_export.prometheus_text(tm) == j_export.prometheus_text(jm)
    payload = t_export.chrome_trace(tt)
    assert payload == j_export.chrome_trace(jt)
    for _, export in OBS.values():          # each validator takes both
        assert export.validate_chrome_trace(payload) == []
        assert export.validate_chrome_trace(
            j_export.chrome_trace(jt)) == []
    assert t_export.validate_chrome_trace({"traceEvents": [{"ph": "B"}]})


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_handles_stamp_times_and_record_nothing(pkg):
    obs_pkg, _ = OBS[pkg]
    with obs_pkg.NULL_TRACE.span("engine.stage2") as sp:
        pass
    assert sp.ended and sp.dur_ms >= 0.0
    assert obs_pkg.NULL_TRACE.counts()["n_begun"] == 0
    assert obs_pkg.NULL_REGISTRY.counter("x") is obs_pkg.NULL_METRIC
    assert not obs_pkg.NULL_OBS.enabled
    assert obs_pkg.Observability.create().enabled
    with pytest.raises(TypeError, match="already registered"):
        reg = obs_pkg.MetricsRegistry()
        reg.counter("a")
        reg.gauge("a")


def test_export_writers(tmp_path):
    trace, metrics = _script(t_obs)
    path = str(tmp_path / "trace.json")
    payload = t_export.write_chrome_trace(path, trace)
    assert t_export.main([path]) == 0
    assert not (tmp_path / "trace.json.tmp").exists()
    assert len([e for e in payload["traceEvents"] if e["ph"] == "X"]) == 8
    snap_path = str(tmp_path / "metrics.jsonl")
    for i in range(2):
        snap = t_export.write_metrics_snapshot(snap_path, metrics,
                                               extra={"run": i},
                                               t_wall=1.5)
    assert snap["counters"] == {"engine.dispatches": 1, "service.batches": 3}
    lines = open(snap_path).read().splitlines()
    assert len(lines) == 2 and '"run": 1' in lines[1]


# ---------------------------------------------------------- service --

@pytest.fixture(scope="module")
def servers(tiny_system):
    return carry_servers(tiny_system, knobs=("k",))["k"], \
        tiny_system.queries.terms


def _run(mod, server, qt, obs):
    service = mod.RetrievalService(
        mod.EngineBackend(server, query_len=qt.shape[1]),
        mod.AdmissionConfig(max_batch=16, pad_multiple=8), obs=obs)
    return service, service.serve_all(list(qt), deadline_ms=1e6)


def _balanced(trace):
    c = trace.counts()
    assert c["n_open"] == 0 and c["n_begun"] == c["n_ended"], c
    return c


def test_service_spans_and_counters_match_jax(servers):
    (js, ts), terms = servers
    qt = terms[:37]
    for server in (js, ts):                 # build before the count
        server.engine.warmup([8, 16], qt.shape[1])
    jobs, tobs = j_obs.Observability.create(), t_obs.Observability.create()
    _, want = _run(j_service, js, qt, jobs)
    _, got = _run(t_service, ts, qt, tobs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ranked"], w["ranked"])
    names = collections.Counter(h.name for h in tobs.trace.spans())
    assert names == collections.Counter(h.name for h in jobs.trace.spans())
    assert names["engine.stage1:" + str(ts.engine.max_k)] == 3
    assert tobs.metrics.counters() == jobs.metrics.counters()
    assert tobs.metrics.counters()["engine.dispatches"] == 4 * 3
    assert tobs.metrics.counters()["engine.compiles"] == \
        jobs.metrics.counters()["engine.compiles"] == 0
    assert _balanced(tobs.trace) == _balanced(jobs.trace)
    for qid in (0, 20, 36):                 # one query of each batch
        a = t_export.latency_attribution(tobs.trace, qid)
        b = j_export.latency_attribution(jobs.trace, qid)
        assert set(a["stages"]) == set(b["stages"])
        assert set(a["shared"]) == set(b["shared"]) == {
            "predict", "execute", "engine.gather",
            "engine.stage1:" + str(ts.engine.max_k), "engine.stage2",
            "engine.rerank"}
    assert t_export.prometheus_text(tobs.metrics).count("counter") == len(
        tobs.metrics.counters())
    # attribution rows: the same label columns in both packages
    recs = [types.SimpleNamespace(trace_id=r["trace_id"],
                                  pred_class=r["class"], width=r["width"],
                                  total_ms=r["total_ms"], retire_reason="")
            for r in got] + [types.SimpleNamespace(trace_id=-1)]
    rows = t_export.attribution_table(tobs.trace, recs)
    want_rows = j_export.attribution_table(jobs.trace, recs)
    assert len(rows) == len(want_rows) == 37
    assert [sorted(r) for r in rows] == [sorted(r) for r in want_rows]


def test_obs_on_and_off_serve_the_same_lists(servers):
    (_, ts), terms = servers
    qt = terms[:21]
    _, off = _run(t_service, ts, qt, None)
    obs = t_obs.Observability.create()
    service, on = _run(t_service, ts, qt, obs)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["ranked"], b["ranked"])
        assert a["class"] == b["class"]
    _balanced(obs.trace)
    assert service.stats().n_queries == 21


@pytest.mark.parametrize("where,mode", [("execute", "inline"),
                                        ("execute", "threaded"),
                                        ("predict", "threaded")])
def test_spans_balance_when_the_backend_raises(servers, where, mode):
    (_, ts), terms = servers
    backend = t_service.EngineBackend(ts)

    def boom(*_):
        raise RuntimeError("boom")

    setattr(backend, where, boom)
    obs = t_obs.Observability.create()
    service = t_service.RetrievalService(
        backend, t_service.AdmissionConfig(max_batch=4, pad_multiple=4),
        obs=obs)
    futs = service.submit_many(list(terms[:6]))
    if mode == "inline":
        service.drain(timeout=30.0)
    else:
        with service:
            service.drain(timeout=30.0)
    assert all(isinstance(f.exception(), RuntimeError) for f in futs)
    _balanced(obs.trace)
    requests = [h for h in obs.trace.spans() if h.name == "request"]
    assert len(requests) == 6
    assert all(h.attrs["error"] == "RuntimeError" for h in requests)


def test_stop_without_drain_cancels_and_balances(servers):
    (_, ts), terms = servers
    obs = t_obs.Observability.create()
    service = t_service.RetrievalService(
        t_service.EngineBackend(ts),
        t_service.AdmissionConfig(max_batch=8, pad_multiple=8), obs=obs)
    futs = service.submit_many(list(terms[:5]))
    service.stop(drain=False)
    assert all(f.cancelled() for f in futs)
    _balanced(obs.trace)
    assert obs.metrics.counters()["service.cancelled"] == 5
    stats = service.stats()
    assert stats.n_cancelled == 5 and np.isnan(stats.deadline_met)
