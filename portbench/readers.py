"""What the metric readers under ``metrics/`` share.  Each reader takes
a ``bench.RunData`` and returns a number, or None when the run holds
nothing to read (then the metric is left out of the result line)."""

from __future__ import annotations

import statistics

import numpy as np

from portbench import costs


def p95(values):
    """95th percentile (numpy's linear rule), None for no values."""
    return float(np.percentile(values, 95)) if len(values) else None


def latencies_ms(run) -> np.ndarray:
    """Per request of the window: due -> result.  A request that failed
    or was not done when the harness stopped waiting counts the wait it
    had had by then."""
    end = np.where(np.isnan(run.done), run.t_close, run.done)
    return (end - run.due) * 1e3


def completed(run) -> int:
    return int(np.sum((run.done >= run.t0) & (run.done <= run.t1)))


def spans(run, name: str) -> list:
    """The window's service spans named ``name`` or ``name:<key>``."""
    return [h for h in run.spans
            if h.name == name or h.name.startswith(name + ":")]


def median_span_ms(run, name: str):
    d = [h.dur_ms for h in spans(run, name)]
    return statistics.median(d) if d else None


def mean_batch(run):
    n = [h.attrs["n"] for h in spans(run, "predict")
         if h.attrs and "n" in h.attrs]
    return statistics.fmean(n) if n else None


def queue_ms(run) -> np.ndarray:
    """Per request: its due time -> the start of its batch's predict
    span (the service's dispatch)."""
    start = {h.attrs["batch"]: h.t0 for h in spans(run, "predict")
             if h.attrs and "batch" in h.attrs}
    if run.batch_of is None:
        return np.zeros(0)
    return np.array([(start[b] - d) * 1e3
                     for b, d in zip(run.batch_of, run.due) if b in start])


def _bound_s(run, kernel: str, b: int) -> float:
    """The least seconds batch ``b``'s call needs for its real requests
    (``n``): the rows that pad it to the program grid serve none."""
    cfg, bt = run.config, run.batches
    if kernel == "impact_scan":
        cost = costs.impact_scan_cost(int(bt["n"][b]), cfg["stream_cap"],
                                      cfg["n_docs"], int(bt["live"][b]))
    else:
        cost = costs.topk_cost(int(bt["n"][b]), cfg["n_docs"],
                               cfg["rerank_depth"])
    return costs.bound_s(*cost)[0]


def roofline(run, kernel: str, part: str):
    """Percent: the least time the traced calls of ``kernel`` (device ops
    whose name holds ``part``, each tied to its batch) need at the HBM
    peak, over the device time they took."""
    if run.trace is None:
        return None
    calls = [(d, b) for d, b in run.trace.kernels(part) if b >= 0]
    took = sum(d for d, _ in calls) / 1e9
    if not calls or took <= 0:
        return None
    return 100.0 * sum(_bound_s(run, kernel, b) for _, b in calls) / took


def idle_share(run):
    """Percent of the traced slice with no device op running."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
