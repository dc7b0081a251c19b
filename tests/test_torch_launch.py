"""The port's serving CLI, ``python -m repro_torch.launch.serve``, at a
tiny size on the CPU (``--device cpu``), with its exports and census in
a temporary directory.  Without ``--device`` it asks for the card and
raises without one (``tests/test_torch_isolation.py``)."""

import json

from repro_torch.launch import serve
from repro_torch.obs import export


def test_serve_cli_on_the_cpu_writes_valid_exports(tmp_path, capsys):
    trace, snap = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    census = tmp_path / "build" / "warmup_census.json"
    serve.main(["--device", "cpu", "--knob", "rho", "--batch", "30",
                "--batches", "3", "--n-docs", "600", "--n-queries", "96",
                "--census", str(census), "--trace-out", str(trace),
                "--metrics-snapshot", str(snap)])
    out = capsys.readouterr().out.splitlines()
    rows = [line.split() for line in out[1:4]]
    assert out[0].split() == ["batch", "p50_ms", "q/s", "mean_rho",
                              "in_envelope", "queue_p50"]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    assert out[4].startswith("q=90 ") and "compiles=0" in out[4]
    assert "warmed shapes: [32] | shape census: {32: 3}" in out[5]
    payload = json.loads(trace.read_text())
    assert export.validate_chrome_trace(payload) == []
    assert export.main([str(trace)]) == 0
    names = {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"}
    assert {"request", "queue", "predict", "handoff", "execute",
            "engine.gather", "engine.stage1", "engine.stage2",
            "engine.rerank"} <= names
    counters = json.loads(snap.read_text().splitlines()[-1])["counters"]
    assert counters["service.batches"] == 3
    assert counters["queue.submitted"] == 90
    assert counters["service.deadline_met"] + counters[
        "service.deadline_missed"] == 90
    # the warmup pass dispatches 4 stages too
    assert counters["engine.dispatches"] == 4 * 4
    assert counters["engine.compiles"] == 0
    assert json.loads(census.read_text())["shapes"] == {"32": 3}
