"""Exporters for the observability layer (a copy of ``repro.obs.export``).

Three surfaces, one source of truth (`TraceRecorder` + `MetricsRegistry`):

- ``chrome_trace`` / ``write_chrome_trace`` — the Trace Event Format
  consumed by Perfetto and ``chrome://tracing``: one ``"X"`` (complete)
  event per span with microsecond ``ts``/``dur``, lanes (``tid``) from
  the recorder's thread table, join keys and deterministic attrs under
  ``args`` (with the port's ``cpu_ms``/``wait_ms`` and ``dev_*``), the
  ``gc`` spans on the lane of the thread that collected.  A span with a
  resolved device interval (``obs/device.py``) is drawn a second time
  on the device's lanes (process 2, one lane a stream, named by the
  span's ``dev_stream``) from ``dev_t0`` to ``dev_t1``: host work and
  the card's work on one timeline.  Writes are atomic (tmp +
  ``os.replace``, the census pattern) so a reader never sees a torn
  file.
- ``prometheus_text`` / ``write_metrics_snapshot`` — text exposition
  (``repro_``-prefixed, dots → underscores) and an append-only JSONL
  snapshot stream for offline diffing.
- ``latency_attribution`` / ``attribution_table`` — joins one query's
  spans (request / queue / predict / execute / slot, keyed by
  ``qid == trace_id``) with the batch- and tick-scoped stage spans that
  served it, producing the per-stage ms columns the deadline-degradation
  item (ROADMAP) needs as a trainable label.  Batch-path stage spans
  join through the ``batch`` attr stamped by ``TraceRecorder.ctx``;
  continuous-path chunk windows join by time overlap with the slot
  occupancy span.  Batch-scoped stages are *shared* cost — the table
  reports them per query with a ``shared`` marker rather than dividing
  them, so the labeler chooses its own amortization.

``python -m repro_torch.obs.export trace.json`` re-validates an exported
trace against the schema check.
"""

from __future__ import annotations

import json
import os
import sys
import time


# -- Chrome trace / Perfetto ---------------------------------------------

def chrome_trace(trace) -> dict:
    """Trace Event Format payload from a recorder's completed spans
    (host lanes in process 1, device lanes in process 2)."""
    events = []
    spans = trace.spans()
    for lane, name in sorted(trace.thread_names().items()):
        events.append({"ph": "M", "pid": 1, "tid": lane,
                       "name": "thread_name", "args": {"name": name}})
    streams: dict = {}              # dev_stream -> device lane
    device = []
    for h in spans:
        args = {}
        if h.qid >= 0:
            args["qid"] = int(h.qid)
        if h.slot >= 0:
            args["slot"] = int(h.slot)
        if h.tick >= 0:
            args["tick"] = int(h.tick)
        if h.attrs:
            args.update(h.attrs)
        events.append({
            "ph": "X", "pid": 1, "tid": int(h.tid),
            "name": h.name, "cat": h.name.split(".", 1)[0],
            "ts": h.t0 * 1e6, "dur": max(0.0, (h.t1 - h.t0) * 1e6),
            "args": args,
        })
        if "dev_t0" in args:
            lane = streams.setdefault(args["dev_stream"], len(streams))
            device.append({
                "ph": "X", "pid": 2, "tid": lane, "name": h.name,
                "cat": "device", "ts": args["dev_t0"] * 1e6,
                "dur": max(0.0, (args["dev_t1"] - args["dev_t0"]) * 1e6),
                "args": args})
    if streams:
        events.append({"ph": "M", "pid": 2, "tid": 0,
                       "name": "process_name", "args": {"name": "device"}})
        for name, lane in streams.items():
            events.append({"ph": "M", "pid": 2, "tid": lane,
                           "name": "thread_name", "args": {"name": name}})
        events += device
    counts = trace.counts()
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"recorder": counts}}


def validate_chrome_trace(payload) -> list:
    """Schema check; returns a list of problems (empty == valid)."""
    errs = []
    if not isinstance(payload, dict):
        return ["payload is not an object"]
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errs.append(f"{where}: pid/tid must be ints")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
        if ph == "X":
            for k in ("ts", "dur"):
                v = ev.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    errs.append(f"{where}: {k} must be a number >= 0")
    return errs


def _atomic_write_json(path: str, payload) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def write_chrome_trace(path: str, trace) -> dict:
    payload = chrome_trace(trace)
    errs = validate_chrome_trace(payload)
    if errs:  # pragma: no cover - would be an exporter bug
        raise ValueError(f"refusing to write invalid trace: {errs[:3]}")
    _atomic_write_json(path, payload)
    return payload


# -- metrics exposition ---------------------------------------------------

def _prom_name(name: str) -> str:
    return "repro_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in name)


def prometheus_text(metrics) -> str:
    """Prometheus text exposition format, one block per metric."""
    snap = metrics.snapshot()
    lines = []
    for name, v in snap["counters"].items():
        p = _prom_name(name)
        lines += [f"# TYPE {p} counter", f"{p} {v}"]
    for name, v in snap["gauges"].items():
        p = _prom_name(name)
        lines += [f"# TYPE {p} gauge", f"{p} {v}"]
    for name, v in snap["histograms"].items():
        p = _prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        h = metrics.histogram(name)
        acc = 0
        for le, c in zip(h.upper_bounds(), v["counts"]):
            acc += c
            tag = "+Inf" if le == float("inf") else f"{le:g}"
            lines.append(f'{p}_bucket{{le="{tag}"}} {acc}')
        lines += [f"{p}_sum {v['sum']}", f"{p}_count {v['n']}"]
    return "\n".join(lines) + "\n"


def write_metrics_snapshot(path: str, metrics, extra: dict | None = None,
                           t_wall: float | None = None) -> dict:
    """Append one JSON line holding the full snapshot (timestamped)."""
    snap = metrics.snapshot()
    snap["t_wall"] = time.time() if t_wall is None else t_wall
    if extra:
        snap.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(snap) + "\n")
    return snap


# -- latency attribution --------------------------------------------------

#: span names that belong to exactly one query (qid == trace_id)
_PER_QUERY = ("request", "queue", "predict", "execute", "handoff", "slot")


def latency_attribution(trace, trace_id: int) -> dict:
    """Per-stage latency breakdown for one query.

    Returns ``{"trace_id", "spans", "stages", "shared"}`` where
    ``stages`` sums the query's own spans by name and ``shared`` sums
    the batch/tick-scoped stage spans that served it (engine stages for
    its batch, chunk windows overlapping its slot occupancy)."""
    spans = trace.spans()
    mine = [h for h in spans if h.qid == trace_id]
    stages: dict = {}
    for h in mine:
        stages[h.name] = stages.get(h.name, 0.0) + h.dur_ms

    batches = {h.attrs["batch"] for h in mine
               if h.attrs and "batch" in h.attrs}
    slot_windows = [(h.t0, h.t1) for h in mine if h.name == "slot"]

    shared: dict = {}
    for h in spans:
        if h.qid >= 0:
            continue
        hit = (h.attrs and h.attrs.get("batch") in batches)
        if not hit and slot_windows and h.name.startswith(("sched.",
                                                          "tick")):
            hit = any(h.t0 < t1 and h.t1 > t0 for t0, t1 in slot_windows)
        if hit:
            shared[h.name] = shared.get(h.name, 0.0) + h.dur_ms

    return {
        "trace_id": trace_id,
        "spans": [{"name": h.name, "ms": round(h.dur_ms, 4),
                   "slot": h.slot, "tick": h.tick,
                   "attrs": h.attrs or {}} for h in mine],
        "stages": {k: round(v, 4) for k, v in sorted(stages.items())},
        "shared": {k: round(v, 4) for k, v in sorted(shared.items())},
    }


def attribution_table(trace, records) -> list:
    """One row per TelemetryRecord with a trace join: the measured
    per-stage service time as label columns (the deadline predictor's
    training surface).  Records without a stamped ``trace_id`` are
    skipped."""
    rows = []
    for r in records:
        tid = getattr(r, "trace_id", -1)
        if tid < 0:
            continue
        att = latency_attribution(trace, tid)
        row = {"trace_id": tid, "pred_class": r.pred_class,
               "width": r.width, "total_ms": r.total_ms,
               "retire_reason": r.retire_reason}
        for k, v in att["stages"].items():
            row[f"{k}_ms"] = v
        for k, v in att["shared"].items():
            row[f"shared_{k.replace('.', '_')}_ms"] = v
        rows.append(row)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.export TRACE.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        payload = json.load(f)
    errs = validate_chrome_trace(payload)
    if errs:
        for e in errs[:20]:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    evs = payload["traceEvents"]
    n_x = sum(1 for e in evs if e["ph"] == "X")
    names = sorted({e["name"] for e in evs if e["ph"] == "X"})
    print(f"valid chrome trace: {n_x} spans, "
          f"{len(names)} span kinds: {', '.join(names)}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
