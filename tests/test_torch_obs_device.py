"""What the port's recorder adds to the reference's: device intervals on
the recorder's clock (``obs/device.py``), the threads' CPU time in every
``span()``, the collector's pauses as ``gc`` spans while a service runs,
the Chrome trace's device lanes, and nothing of these with tracing off.

The CUDA timer runs here on stand-in events and streams: an event
records the stand-in device's clock when recorded and has completed
once the device has run past it.  Tolerance: equality for the
stand-ins' arithmetic (exact binary fractions); a host clock only in
inequalities.
"""

import gc
import threading
import time
import types

import numpy as np
import pytest
import torch

from _torch_carry import carry_servers
from repro_torch import obs as t_obs
from repro_torch.obs import device as obs_device
from repro_torch.obs import export as t_export
from repro_torch.serving import service as t_service


class FakeDevice:
    """A card whose clock runs ``offset`` seconds ahead of the host's and
    which has completed all work queued up to ``done`` (its clock)."""

    def __init__(self, offset):
        self.now = 0.0
        self.offset = offset
        self.done = float("-inf")


class FakeEvent:
    def __init__(self, dev):
        self.dev = dev
        self.t = None
        self.records = 0

    def record(self, stream):
        self.t = self.dev.now + self.dev.offset
        self.records += 1

    def query(self):
        return self.t is not None and self.t <= self.dev.done

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return (other.t - self.t) * 1e3


class FakeStream:
    stream_id = 7


def _timer(capacity=1024):
    dev = FakeDevice(offset=100.0)
    trace = t_obs.TraceRecorder(clock=lambda: dev.now)
    metrics = t_obs.MetricsRegistry()
    made = []

    def event():
        made.append(FakeEvent(dev))
        return made[-1]

    timer = obs_device.DeviceTimer(trace, "cuda:0", metrics,
                                   capacity=capacity, event=event,
                                   stream=FakeStream)
    trace.devices["cuda:0"] = timer    # as obs_device.timer keeps it
    return dev, trace, metrics, timer, made


def _interval(trace, timer, dev, name, t0, t1):
    """A span whose program's device work runs from ``t0`` to ``t1``
    (host seconds; the host's clock stands at ``t0`` at the call)."""
    dev.now = t0
    with trace.span(name) as sp:
        tok = timer.start(sp)
        dev.now = t1
        timer.stop(tok)
    return sp


def test_pairs_resolve_onto_the_recorder_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", None)   # never called
    dev, trace, _, timer, made = _timer()
    trace.watch()
    try:
        sp = _interval(trace, timer, dev, "engine.stage1", 1.5, 1.75)
        assert "dev_t0" not in (sp.attrs or {})       # no anchor yet
        dev.now = 2.0
        timer.anchor()                 # the stream idle: the card is at 102
        assert "dev_t0" not in (sp.attrs or {})       # anchor not reached
        dev.done = 101.75                              # the pair has run
        trace.spans()                                  # ... the anchor not
        assert "dev_t0" not in (sp.attrs or {})
        dev.done = 102.0
        trace.spans()                  # resolved at the latest in spans()
        assert sp.attrs["dev_t0"] == 1.5 and sp.attrs["dev_t1"] == 1.75
        assert sp.attrs["dev_ms"] == 250.0
        assert sp.attrs["dev_stream"] == "cuda:0 stream 7"
        # a pair still running stays queued: no wait for the card
        late = _interval(trace, timer, dev, "predict.program", 2.25, 2.5)
        trace.spans()
        assert "dev_t0" not in (late.attrs or {})
        dev.done = 103.0
        trace.spans()
        assert (late.attrs["dev_t0"], late.attrs["dev_t1"]) == (2.25, 2.5)
    finally:
        trace.unwatch()
    # resolved events go back to the pool: the second pair reuses the
    # first pair's, so one pair and one anchor were made
    assert len(made) == 3


def test_anchor_refreshes_and_the_newest_completed_maps(monkeypatch):
    dev, trace, _, timer, made = _timer()          # refresh_s 0.5
    trace.watch()
    dev.now = 1.0
    timer.anchor()
    dev.now = 1.25
    timer.anchor()                     # inside refresh_s: no new anchor
    assert len(made) == 1
    # the card's clock drifts by 1/1024 s against the host's
    dev.offset += 2.0 ** -10
    dev.now = 1.5
    timer.anchor()
    assert len(made) == 2
    sp = _interval(trace, timer, dev, "engine.gather", 1.75, 2.0)
    dev.now = 3.0
    timer.anchor()                     # newest, not yet reached by the card
    dev.done = 103.0
    trace.spans()
    # mapped by the second anchor (drift included), not the first
    assert (sp.attrs["dev_t0"], sp.attrs["dev_t1"]) == (1.75, 2.0)
    trace.unwatch()
    # an anchor whose record took long is not taken while one serves
    ticks = iter([5.0, 5.0, 5.001, 5.5, 5.5, 5.5, 6.0, 6.0, 6.5])
    clocked = types.SimpleNamespace(watching=True,
                                    clock=lambda: next(ticks))
    late = obs_device.DeviceTimer(
        clocked, "cuda:0", t_obs.MetricsRegistry(),
        event=lambda: FakeEvent(dev), stream=FakeStream)
    late.anchor()                      # no anchor yet: a late one serves
    assert len(late._anchors) == 1 and late._t_anchor < 0
    late.anchor()                      # a good one
    assert len(late._anchors) == 2 and late._t_anchor == 5.5
    late.anchor()                      # late, and the good one serves
    assert len(late._anchors) == 2


def test_pool_is_bounded_and_counts_what_it_drops():
    dev, trace, metrics, timer, made = _timer(capacity=4)
    trace.watch()
    a = _interval(trace, timer, dev, "engine.stage1", 1.0, 1.25)
    b = _interval(trace, timer, dev, "engine.stage2", 1.25, 1.5)
    c = _interval(trace, timer, dev, "engine.rerank", 1.5, 1.75)
    assert len(made) == 4 and timer.n_dropped == 1
    assert metrics.counters()["trace.dev_dropped"] == 1
    dev.now = 2.0
    timer.anchor()
    dev.done = 102.0
    trace.spans()
    assert "dev_t0" in a.attrs and "dev_t0" in b.attrs
    assert c.attrs is None
    # the resolved pairs' events are used again: nothing more is made
    d = _interval(trace, timer, dev, "engine.gather", 2.25, 2.5)
    assert len(made) == 5 and timer.n_dropped == 1
    dev.done = 103.0
    trace.spans()
    assert d.attrs["dev_ms"] == 250.0
    trace.unwatch()


def test_timers_record_only_while_watched_and_not_with_tracing_off():
    dev, trace, _, timer, made = _timer()
    sp = _interval(trace, timer, dev, "engine.stage1", 1.0, 1.25)
    timer.anchor()
    assert made == [] and sp.attrs is None
    assert obs_device.timer(t_obs.NULL_OBS, torch.device("cpu")) is None
    obs = t_obs.Observability.create()
    host = obs_device.timer(obs, torch.device("cpu"))
    assert obs_device.timer(obs, "cpu") is host       # one a device
    obs.trace.watch()
    with obs.trace.span("predict.program") as h:
        assert host.call(h, lambda x: x + 1, 1) == 2
    obs.trace.unwatch()
    assert h.t0 <= h.attrs["dev_t0"] <= h.attrs["dev_t1"] <= h.t1
    assert h.attrs["dev_stream"] == "cpu"


def test_span_reads_thread_cpu_time_and_wait(monkeypatch):
    trace = t_obs.TraceRecorder()
    with trace.span("execute") as sp:
        t = time.thread_time()
        while time.thread_time() - t < 0.01:
            pass
        time.sleep(0.03)
    assert sp.attrs["cpu_ms"] >= 10.0 and sp.attrs["wait_ms"] >= 25.0
    assert sp.attrs["cpu_ms"] + sp.attrs["wait_ms"] == pytest.approx(
        sp.dur_ms, rel=1e-9)
    with trace.span("predict", n=3) as sp:
        pass
    assert sp.attrs["n"] == 3 and sp.attrs["wait_ms"] >= 0.0
    # on an injected clock the two are not comparable: neither is kept
    ticks = iter(range(10))
    fake = t_obs.TraceRecorder(clock=lambda: float(next(ticks)))
    with fake.span("execute") as sp:
        pass
    assert sp.attrs is None

    def fail():
        raise AssertionError("thread_time read with tracing off")
    monkeypatch.setattr(time, "thread_time", fail)
    with t_obs.NULL_TRACE.span("execute") as sp:
        pass
    assert sp.attrs is None


def test_gc_spans_only_while_watched():
    trace = t_obs.TraceRecorder()
    hooks = list(gc.callbacks)
    gc.collect()
    assert not [h for h in trace.spans() if h.name == "gc"]
    trace.watch()
    trace.watch()                      # nested: one hook
    assert len(gc.callbacks) == len(hooks) + 1
    gc.collect()
    trace.unwatch()
    gc.collect()
    assert len(gc.callbacks) == len(hooks) + 1
    trace.unwatch()
    assert gc.callbacks == hooks
    trace.unwatch()                    # unbalanced: ignored
    gc.collect()
    spans = [h for h in trace.spans() if h.name == "gc"]
    assert len(spans) == 2
    assert all(h.attrs["gen"] == 2 and h.attrs["collected"] >= 0
               and h.t1 >= h.t0 for h in spans)
    assert trace.thread_names()[spans[0].tid] == \
        threading.current_thread().name
    c = trace.counts()
    assert c["n_begun"] == c["n_ended"] == 2 and c["n_open"] == 0
    t_obs.NULL_TRACE.watch()
    assert gc.callbacks == hooks


# ---------------------------------------------------------- service --

@pytest.fixture(scope="module")
def server(tiny_system):
    return carry_servers(tiny_system, knobs=("k",))["k"][1], \
        tiny_system.queries.terms


def _service(srv, qt, obs):
    return t_service.RetrievalService(
        t_service.EngineBackend(srv, query_len=qt.shape[1]),
        t_service.AdmissionConfig(max_batch=16, pad_multiple=8),
        t_service.WarmupPolicy(census_path=None), obs=obs)


def test_running_service_records_intervals_collections_and_lanes(server):
    srv, terms = server
    qt = terms[:37]
    srv.engine.warmup([8, 16], qt.shape[1])
    obs = t_obs.Observability.create()
    svc = _service(srv, qt, obs)
    hooks = list(gc.callbacks)
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc:
        assert len(gc.callbacks) == len(hooks) + 1
        got = [f.result(timeout=120.0) for f in futs]
        gc.collect()
    assert gc.callbacks == hooks
    assert len(got) == 37
    spans = obs.trace.spans()
    predicts = {h.attrs["batch"]: h for h in spans if h.name == "predict"}
    assert len(predicts) == 3
    for b, p in predicts.items():
        mine = [h for h in spans if (h.attrs or {}).get("batch") == b]
        prog = [h for h in mine if h.name == "predict.program"]
        stages = [h for h in mine if h.name.startswith("engine.")]
        assert len(prog) == 1 and len(stages) == 4
        assert p.t0 <= prog[0].t0 and prog[0].t1 <= p.t1
        for h in prog + stages:        # the CPU: the call's own interval
            a = h.attrs
            assert h.t0 <= a["dev_t0"] <= a["dev_t1"] <= h.t1
            assert a["dev_ms"] >= 0.0 and a["dev_stream"] == "cpu"
        for h in [p] + prog + stages + [x for x in mine
                                        if x.name == "execute"]:
            assert h.attrs["cpu_ms"] >= 0.0
            assert h.attrs["cpu_ms"] + h.attrs["wait_ms"] == pytest.approx(
                h.dur_ms, rel=1e-9, abs=1e-9)
    collections = [h for h in spans if h.name == "gc"]
    assert any(h.attrs["gen"] == 2 for h in collections)
    c = obs.trace.counts()
    assert c["n_open"] == 0 and c["n_begun"] == c["n_ended"]
    payload = t_export.chrome_trace(obs.trace)
    assert t_export.validate_chrome_trace(payload) == []
    lanes = [e for e in payload["traceEvents"]
             if e["ph"] == "M" and e["pid"] == 2
             and e["name"] == "thread_name"]
    assert [e["args"]["name"] for e in lanes] == ["cpu"]
    device = [e for e in payload["traceEvents"]
              if e["ph"] == "X" and e["pid"] == 2]
    assert len(device) == sum(1 for h in spans if "dev_t0" in (h.attrs or {}))
    assert {e["name"] for e in device} >= {"predict.program",
                                           "engine.stage1:" + str(
                                               srv.engine.max_k)}
    assert any(e["name"] == "gc" and e["pid"] == 1
               for e in payload["traceEvents"])


def test_tracing_off_adds_nothing(server, monkeypatch):
    srv, terms = server
    qt = terms[:21]
    calls = {"thread_time": 0}
    real = time.thread_time

    def counted():
        calls["thread_time"] += 1
        return real()

    def no_event(*a, **k):
        raise AssertionError("an event made with tracing off")

    monkeypatch.setattr(time, "thread_time", counted)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    svc = _service(srv, qt, None)
    assert srv._dev is None and srv.engine._dev is None
    hooks = list(gc.callbacks)
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc.queue._lock:
        pending = [r for _, r in svc.queue._heap]
    assert len(pending) == 21 and all(r.span is None for r in pending)
    with svc:
        assert gc.callbacks == hooks
        off = [f.result(timeout=120.0) for f in futs]
    assert calls["thread_time"] == 0
    # the same lists as with tracing on
    obs = t_obs.Observability.create()
    on = _service(srv, qt, obs).serve_all(list(qt), deadline_ms=1e6)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["ranked"], b["ranked"])
    # the server bound to a traced service keeps its timer; unbind it
    srv.bind_obs(t_obs.NULL_OBS)
