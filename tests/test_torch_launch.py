"""The port's serving CLI, ``python -m repro_torch.launch.serve``, at a
tiny size on the CPU (``--device cpu``), with its exports and census in
a temporary directory.  Without ``--device`` it asks for the card and
raises without one (``tests/test_torch_isolation.py``)."""

import json
import re
import sys

from repro.launch import serve as j_serve
from repro_torch.launch import serve
from repro_torch.obs import export

ARGS = ["--knob", "rho", "--batch", "30", "--batches", "3", "--n-docs",
        "600", "--n-queries", "96"]


def _jax_run(tmp_path, capsys, monkeypatch) -> tuple[int, dict]:
    """The JAX CLI on the same arguments: its ``compiles=`` count and
    its last metrics snapshot's counters."""
    snap = tmp_path / "jax_metrics.jsonl"
    monkeypatch.setattr(sys, "argv", ["serve"] + ARGS + [
        "--census", "", "--metrics-snapshot", str(snap)])
    j_serve.main()
    line = capsys.readouterr().out.splitlines()[4]
    counters = json.loads(snap.read_text().splitlines()[-1])["counters"]
    return int(re.search(r"compiles=(\d+)", line).group(1)), counters


def test_serve_cli_on_the_cpu_writes_valid_exports(tmp_path, capsys,
                                                   monkeypatch):
    trace, snap = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    census = tmp_path / "build" / "warmup_census.json"
    serve.main(["--device", "cpu"] + ARGS + [
        "--census", str(census), "--trace-out", str(trace),
        "--metrics-snapshot", str(snap)])
    out = capsys.readouterr().out.splitlines()
    rows = [line.split() for line in out[1:4]]
    assert out[0].split() == ["batch", "p50_ms", "q/s", "mean_rho",
                              "in_envelope", "queue_p50"]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    # the programs of the one warmed shape, as many as the JAX CLI's
    j_compiles, j_counters = _jax_run(tmp_path, capsys, monkeypatch)
    assert out[4].startswith("q=90 ")
    assert f"compiles={j_compiles}" in out[4] and j_compiles > 0
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
    assert counters["engine.compiles"] == j_counters["engine.compiles"] \
        == j_compiles
    assert json.loads(census.read_text())["shapes"] == {"32": 3}
