"""Unified observability: span tracing, metrics, exporters.

One `Observability` handle bundles the two recording surfaces —
a `TraceRecorder` (bounded per-query/per-stage spans) and a
`MetricsRegistry` (deterministic counters + machine-dependent
gauges/histograms).  Serving classes accept the handle through
``bind_obs``/constructor args and default to `NULL_OBS`, whose
recorders are disabled: handles still carry timestamps (so derived
timings keep working) but nothing is stored and no lock is touched.

A copy of ``repro.obs`` (numpy-free, torch-free): the same span
taxonomy, metric names and lock-order position as the JAX package's, so
traces and counters of the two packages compare name for name.

What the port adds (``obs/trace.py`` says how, ``obs/device.py`` holds
the part that needs torch and is imported by the classes that time the
card): with the recorder enabled, every ``span()`` carries the thread's
``cpu_ms`` and ``wait_ms``; while a service runs (``start()`` to
``stop()``, the recorder's ``watch()``), each collection of the
interpreter is a ``gc`` span (attrs ``gen``, ``collected``), the server's
predict program runs in a ``predict.program`` span, and that span and
every ``engine.<stage>`` span carry their program's device interval on
the recorder's clock (``dev_t0``, ``dev_t1``, ``dev_ms``,
``dev_stream``; the counter ``trace.dev_dropped`` counts spans left
without one).  ``predict.program`` and ``gc`` are names of the port
only, not of the JAX package's taxonomy.  Tracing off (``NULL_OBS``)
reads no thread clock, records no event, hooks no collection and
opens no request span.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.metrics import (NULL_METRIC, NULL_REGISTRY, Counter,
                                     Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACE, SpanHandle, TraceRecorder

__all__ = [
    "Observability", "NULL_OBS", "TraceRecorder", "SpanHandle",
    "NULL_TRACE", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "NULL_REGISTRY", "NULL_METRIC",
]


@dataclass(frozen=True)
class Observability:
    """The pair every instrumented class binds once."""

    trace: TraceRecorder
    metrics: MetricsRegistry

    @classmethod
    def create(cls, capacity: int = 8192, clock=None) -> "Observability":
        import time
        return cls(
            trace=TraceRecorder(
                capacity=capacity,
                clock=clock if clock is not None else time.perf_counter),
            metrics=MetricsRegistry())

    @property
    def enabled(self) -> bool:
        return self.trace.enabled or self.metrics.enabled


#: shared disabled handle — the default everywhere
NULL_OBS = Observability(trace=NULL_TRACE, metrics=NULL_REGISTRY)
