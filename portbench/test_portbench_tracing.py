"""The per-layer metrics that read what the port's recorder adds (device
intervals, thread wait, the collector's pauses): a tiny traced run of
each cell reports them, and on the spans of a program whose recorder
lacks those parts each reader returns None and does not raise."""

import time

import numpy as np
import pytest
import torch

from portbench import bench, tiny
from repro_torch.obs import SpanHandle

CPU = torch.device("cpu")
SEED = 2147480029
NEW = ("predict_dev_ms", "execute_dev_ms", "predict_wait_ms",
       "execute_wait_ms", "gc_ms_per_s")
CELLS = {"rho-open": "open", "rho-flood": "flood"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_traced_run_reports_the_new_metrics(cell):
    spec = tiny.spec(cell)
    out, _ = bench.run(spec, SEED, 0.6, True, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    names = {f"{n}.{CELLS[cell]}" for n in NEW}
    assert names <= {m["name"] for m in spec["per_layer"]}
    got = out["metrics"]
    assert names <= set(got), sorted(names - set(got))
    for name in names:
        assert got[name]["value"] >= 0.0, (name, got[name])
    assert got[f"predict_dev_ms.{CELLS[cell]}"]["value"] <= \
        got[f"predict_ms.{CELLS[cell]}"]["value"]


def _span(name, t0, t1, **attrs):
    h = SpanHandle(name, -1, -1, -1, t0, 0, attrs or None)
    h.t1 = t1
    return h


def _run(spans, seconds=2.0):
    spec = tiny.spec("rho-open")
    return bench.RunData(config=spec["config"], traffic=spec["traffic"],
                         seconds=seconds, t0=0.0, t1=seconds,
                         due=np.zeros(0), done=np.zeros(0),
                         failed=np.zeros(0, bool), t_close=seconds,
                         batch_of=None, batches={}, spans=spans, trace=None,
                         setup_s=1.0, mem_reserved=0)


def _read(name, run):
    return bench.reader(bench.ROOT, name)(run)


def test_readers_leave_out_what_an_older_recorder_lacks():
    spans = [_span("predict", 0.1, 0.2, n=4, batch=0),
             _span("execute", 0.2, 0.3, n=4, batch=0),
             _span("engine.stage1", 0.21, 0.22, batch=0)]
    for suffix in CELLS.values():
        for n in NEW:
            assert _read(f"{n}.{suffix}", _run(spans)) is None, n
        assert _read(f"predict_ms.{suffix}", _run(spans)) == \
            pytest.approx(100.0)


def test_readers_join_batches_and_sum_the_collectors_pauses():
    cpu = dict(cpu_ms=1.0)
    spans = [
        _span("predict", 0.1, 0.2, batch=0, wait_ms=4.0, **cpu),
        _span("predict.program", 0.11, 0.19, batch=0, dev_ms=3.0, **cpu),
        _span("predict.program", 0.5, 0.6, dev_ms=50.0, **cpu),  # warmup
        _span("execute", 0.2, 0.3, batch=0, wait_ms=2.0, **cpu),
        _span("execute", 0.4, 0.5, batch=1, wait_ms=6.0, **cpu),
        # paused by the full collection below: left out of the wait
        _span("execute", 0.75, 0.85, batch=2, wait_ms=100.0, **cpu),
        _span("engine.gather", 0.2, 0.21, batch=0, dev_ms=1.0, **cpu),
        _span("engine.stage1", 0.21, 0.22, batch=0, dev_ms=2.0, **cpu),
        _span("engine.gather", 0.4, 0.41, batch=1, dev_ms=1.0, **cpu),
        _span("engine.stage1", 0.41, 0.42, batch=1, **cpu),  # dropped
        _span("gc", 0.7, 0.8, gen=2, collected=5),
        _span("gc", 0.9, 0.95, gen=0, collected=0),
    ]
    run = _run(spans, seconds=2.0)
    for suffix in CELLS.values():
        assert _read(f"predict_dev_ms.{suffix}", run) == 3.0
        assert _read(f"execute_dev_ms.{suffix}", run) == 3.0
        assert _read(f"predict_wait_ms.{suffix}", run) == 4.0
        assert _read(f"execute_wait_ms.{suffix}", run) == 4.0
        assert _read(f"gc_ms_per_s.{suffix}", run) == pytest.approx(75.0)
    # a window with no collection reads 0 from a recorder that records them
    quiet = _run([h for h in spans if h.name != "gc"])
    assert _read("gc_ms_per_s.open", quiet) == 0.0
