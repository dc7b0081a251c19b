"""Named metrics registry: counters, gauges, log-bucket histograms.

Naming scheme (the JAX package's, docs/OBSERVABILITY.md): dotted lowercase
``<subsystem>.<what>[.<label>]`` — ``engine.dispatches``,
``sched.retired.rho_exhausted``, ``service.deadline_met``,
``online.swaps``.  The Prometheus exposition in ``export.py`` maps dots
to underscores and prefixes ``repro_``.

Two families, deliberately separated so a test can diff one and
ignore the other:

- **Counters** are deterministic integers (dispatch counts, swaps,
  compiles, cancellations).  ``counters()`` snapshots exactly these,
  sorted by name: the port's service run and the JAX package's on the
  same inputs give the same counters (``tests/test_torch_obs.py``).
- **Gauges and histograms** carry machine-dependent values (latencies,
  occupancy).  Histograms use fixed log2 buckets from a configured
  ``lo`` — bucket index is one ``math.frexp``, O(1), no allocation.

Every metric shares the registry's single ``_lock``, which occupies one
position in the analyzer's ``LOCK_REGISTRY``: a *leaf*, innermost in
the global order (service → admission → swap → obs).  Recording from inside any other serving lock is therefore legal;
nothing is ever called while holding it.  Hot-path recording is
lock+add: instrumented classes bind their metric objects once at
``bind_obs`` time instead of doing a registry lookup per event.

A disabled registry hands out the shared no-op ``NULL_METRIC`` so hot
paths carry no conditionals; ``enabled`` is fixed at construction.
"""

from __future__ import annotations

import math
import threading


class _NullMetric:
    """No-op stand-in for every metric kind; shared singleton."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def value(self):
        return 0


NULL_METRIC = _NullMetric()


class Counter:
    """Monotone deterministic integer; use only for machine-independent
    event counts (the cross-package comparison depends on it)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float (queue depth, live predictor version)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed log2 buckets: bucket 0 is ``[0, lo)``, bucket i covers
    ``[lo * 2^(i-1), lo * 2^i)``, the last bucket absorbs the tail.
    ``lo`` defaults to 1e-2 (ms scale: 10 µs floor, ~42 s ceiling at 22
    buckets)."""

    __slots__ = ("name", "_lock", "lo", "n_buckets", "_counts",
                 "_sum", "_n")

    def __init__(self, name: str, lock, lo: float = 1e-2,
                 n_buckets: int = 22):
        self.name = name
        self._lock = lock
        self.lo = float(lo)
        self.n_buckets = int(n_buckets)
        self._counts = [0] * self.n_buckets
        self._sum = 0.0
        self._n = 0

    def bucket_of(self, x: float) -> int:
        if x < self.lo:
            return 0
        # frexp(v) = (m, e) with v = m * 2^e, m in [0.5, 1) => for
        # x/lo in [2^(i-1), 2^i) the exponent e is exactly i.
        _, e = math.frexp(x / self.lo)
        return min(e, self.n_buckets - 1)

    def upper_bounds(self) -> list:
        """Inclusive upper edge per bucket; last is +inf."""
        return [self.lo * (1 << i) for i in range(self.n_buckets - 1)] \
            + [math.inf]

    def observe(self, x: float) -> None:
        i = self.bucket_of(x)
        with self._lock:
            self._counts[i] += 1
            self._sum += x
            self._n += 1

    def value(self) -> dict:
        with self._lock:
            return {"n": self._n, "sum": self._sum,
                    "counts": list(self._counts)}

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding quantile ``q`` — a coarse
        but monotone estimate (exact timings belong in the spans, not
        here)."""
        with self._lock:
            n, counts = self._n, list(self._counts)
        if n == 0:
            return 0.0
        target = q * n
        seen = 0
        bounds = self.upper_bounds()
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return bounds[i]
        return bounds[-1]


class MetricsRegistry:
    """Get-or-create registry; one lock shared by every metric."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name, cls, **kw):
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, *, lo: float = 1e-2,
                  n_buckets: int = 22) -> Histogram:
        return self._get(name, Histogram, lo=lo, n_buckets=n_buckets)

    def counters(self) -> dict:
        """Deterministic integer counters only, sorted by name — the
        diff-checked surface."""
        with self._lock:
            items = sorted(self._metrics.items())
            return {n: m._value for n, m in items if type(m) is Counter}

    def snapshot(self) -> dict:
        """Everything, grouped by kind (machine-dependent included)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for n, m in items:
            if type(m) is Counter:
                out["counters"][n] = m.value()
            elif type(m) is Gauge:
                out["gauges"][n] = m.value()
            else:
                out["histograms"][n] = m.value()
        return out


#: shared disabled registry — every lookup returns NULL_METRIC
NULL_REGISTRY = MetricsRegistry(enabled=False)
