"""The harness is driven by data: a configuration, a traffic mix and a
metric reader added as files (and entries in ``BENCHMARK.json``) are
found by name with no edit of the harness; and the manifest keeps to
the benchmark contract's names, units and shapes."""

import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    entries = (manifest["configs"] + manifest["workloads"]
               + manifest["end_to_end"] + manifest["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in manifest["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in manifest["configs"]:
        assert all(NAME.match(k) for k in e["reduced"])
        assert len(e["source"]) <= 200 and len(e["why"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[kind]]
        assert len(names) == len(set(names)), kind


def test_every_cell_reports_what_it_must(manifest):
    e2e = manifest["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e)
    for w in manifest["workloads"]:
        spec = bench.load_spec(w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])
        assert (ROOT / "portbench" / "workloads"
                / f"{w['traffic']}.json").exists()
    for m in e2e + manifest["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for c in manifest["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "paperish-rho.json").read_text())
    cfg["name"] = "paperish-rho-deep"
    cfg["rerank_depth"] = 128
    (pb / "configs" / "paperish-rho-deep.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "workloads" / "rho-open.json").read_text())
    traffic["rate_qps"] = 500.0
    (pb / "workloads" / "rho-slow.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "queue_ms_p50.slow.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median(run.due))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="paperish-rho-deep",
                             file="portbench/configs/paperish-rho-deep.json"))
    m["workloads"].append(dict(name="rho-slow", config="paperish-rho-deep",
                               traffic="rho-slow", chips=1, why="slow"))
    m["per_layer"].append(dict(name="queue_ms_p50.slow", unit="ms",
                               better="lower", source="program_span",
                               layer=m["per_layer"][0]["layer"],
                               moves="latency_p95_ms",
                               workloads=["rho-slow"]))
    m["end_to_end"][0]["workloads"].append("rho-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    spec = bench.load_spec("rho-slow", root)
    assert spec["config"]["rerank_depth"] == 128
    assert spec["traffic"]["rate_qps"] == 500.0
    assert [x["name"] for x in spec["per_layer"]] == ["queue_ms_p50.slow"]
    assert {x["name"] for x in spec["end_to_end"]} == {
        "latency_p95_ms", "device_mem_gb", "setup_s"}
    run = bench.RunData(config=spec["config"], traffic=spec["traffic"],
                        seconds=1.0, t0=0.0, t1=1.0,
                        due=np.array([0.1, 0.3, 0.5]),
                        done=np.array([0.2, 0.4, np.nan]),
                        failed=np.array([False, False, True]), t_close=1.1,
                        batch_of=None, batches={}, spans=[], trace=None,
                        setup_s=2.0, mem_reserved=10 ** 9)
    assert bench.reader(root, "queue_ms_p50.slow")(run) == 0.3
    assert bench.reader(root, "device_mem_gb")(run) == 1.0
    assert bench.reader(root, "latency_p95_ms")(run) == pytest.approx(
        0.6 * 1e3 - 0.1 * (0.6 - 0.1) * 1e3, rel=1e-9)
    assert bench.reader(root, "idle_share.open")(run) is None


def test_open_schedule_keeps_the_load_across_seeds():
    from portbench import traffic
    tr = dict(rate_qps=400.0, arrival_seed=5)
    a = traffic.open_schedule(tr, 10.0, np.random.default_rng(3))
    b = traffic.open_schedule(tr, 10.0, np.random.default_rng(4))
    assert len(a) == len(b) == 4000
    assert a[0] == b[0] == 0.0 and max(a.max(), b.max()) < 10.0
    assert not np.array_equal(a, b)
    gaps = [np.sort(np.diff(np.append(x, 10.0))) for x in (a, b)]
    assert np.allclose(*gaps)
