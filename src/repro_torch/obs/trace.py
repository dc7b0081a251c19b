"""Bounded, lock-cheap span recorder for the serving stack (a copy of
``repro.obs.trace``).

One span = one timed window with deterministic identity: a dotted
``name`` (the JAX package's taxonomy), the join keys
``qid``/``slot``/``tick`` (-1 when not applicable), wall times
``t0``/``t1`` from an injectable clock, and a small ``attrs`` dict for
deterministic labels (knob classes, trigger, deadline_met -- never
device values).  Three recording styles cover every call site:

- ``with trace.span("engine.stage1") as sp: ...`` -- context manager,
  balanced even on exceptions; ``sp.dur_ms`` is readable after exit, so
  the engine's per-stage timings dict is *derived from* the span rather
  than timed twice.
- ``h = trace.begin(...)`` / ``trace.end(h)`` -- explicit, for spans
  whose begin and end live on different threads (a request's lifetime
  from admission to resolve).  ``end`` is idempotent so the resolve
  path and the cancellation path may both close the same span.
- ``trace.record(name, t0, t1, ...)`` -- retrospective, for windows the
  caller already timed with its own clock (a request's wait in the
  pending set, the hand-off between predict and execute).  Balanced by
  construction.

The recorder is a bounded ring: once ``capacity`` completed spans are
held, the oldest is overwritten and ``n_dropped`` accounts for it --
memory stays O(capacity) under unbounded churn.  All mutation happens
under one leaf lock (``_lock``) held only for an append or a dict
pop; the obs locks sit *innermost* in the global order, so recording
from inside any serving lock is legal and calling out while holding an
obs lock is not done anywhere.

A disabled recorder (``NULL_TRACE``) still stamps ``t0``/``t1`` on the
handles it returns -- so code that derives timings from ``sp.dur_ms``
works identically with observability off -- but never touches the lock,
the ring, or the counters.  ``enabled`` is fixed at construction; the
obs-off cost is one clock read per boundary.

``ctx(batch=...)`` pushes thread-local join keys merged into the attrs
of every span *begun* on that thread, which is how batch-scoped engine
stage spans acquire the batch id that ``export.latency_attribution``
later joins to per-query request spans without widening any ``serve()``
signature.

Spans wrap stage boundaries on the host.  A span that times device work
holds the device fence inside it (the engine waits for its thread's
current CUDA stream before the span ends), so ``dur_ms`` covers the
stage's device time and not just its launches.

What the port adds to the reference's recorder, all of it with the
recorder enabled only (``NULL_TRACE`` reads no thread clock, records no
event and hooks nothing):

- **Thread CPU time.**  A ``span()`` also reads ``time.thread_time()``
  just after it begins and just before it ends, and its attrs get
  ``cpu_ms`` (the calling thread on a CPU) and ``wait_ms = dur_ms -
  cpu_ms`` (the thread off a CPU: waiting for the interpreter lock, a
  Python lock, a blocking wait for the card, or the operating system).
  Only on a wall clock (``time.perf_counter``, the default): on an
  injected clock the two are not comparable and neither is recorded.
  The thread clock's step is the host's: where it advances in 10 ms
  ticks (as under a gVisor sandbox) one span's ``cpu_ms`` is a whole
  number of ticks and ``wait_ms`` may read below 0; means over many
  spans stay right.
- **Watching** (``watch()`` / ``unwatch()``, counted; a
  ``RetrievalService`` watches its enabled recorder from ``start()`` to
  ``stop()``).  While watched, a ``gc.callbacks`` hook records one
  ``gc`` span a collection on the collecting thread's lane, attrs
  ``gen`` and ``collected``, and the device timers of ``devices``
  (``obs/device.py``, one a device, keyed by its name) put an interval
  on each captured program's span: attrs ``dev_t0``/``dev_t1`` (recorder
  clock seconds), ``dev_ms`` and ``dev_stream`` (the lane).  The server
  opens a ``predict.program`` span around its predict program for it.
  Inline serving records the reference's taxonomy alone.
  ``predict.program`` and ``gc`` are names of the port only.  A
  collection's callback takes no lock (a collection may start while
  its thread holds ``_lock``): it queues the span, and ``spans()``
  moves the queue into the ring and resolves the device intervals whose
  events have completed.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from contextlib import contextmanager


class SpanHandle:
    """One span; mutable until ended, then append-only data."""

    __slots__ = ("name", "qid", "slot", "tick", "t0", "t1", "tid", "attrs")

    def __init__(self, name, qid, slot, tick, t0, tid, attrs):
        self.name = name
        self.qid = qid
        self.slot = slot
        self.tick = tick
        self.t0 = t0
        self.t1 = -1.0
        self.tid = tid
        self.attrs = attrs

    @property
    def ended(self) -> bool:
        return self.t1 >= 0.0

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __repr__(self):  # pragma: no cover - debugging aid
        ids = ",".join(f"{k}={v}" for k, v in
                       (("qid", self.qid), ("slot", self.slot),
                        ("tick", self.tick)) if v >= 0)
        dur = f"{self.dur_ms:.3f}ms" if self.ended else "open"
        return f"<span {self.name} [{ids}] {dur}>"


class TraceRecorder:
    """Bounded ring of completed spans; see module docstring."""

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 clock=time.perf_counter):
        self.capacity = max(0, int(capacity))
        self.enabled = bool(enabled) and self.capacity > 0
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: list = []      # completed spans, ring once full
        self._head = 0             # oldest entry once ring is full
        self._open: dict = {}      # id(handle) -> handle, begun not ended
        self._tids: dict = {}      # thread ident -> (lane index, name)
        self.n_begun = 0
        self.n_ended = 0
        self.n_dropped = 0
        self._local = threading.local()
        # a span's thread CPU time is comparable to its duration on the
        # wall clock only
        self._cpu = self.enabled and clock is time.perf_counter
        #: device timers (``obs/device.py``), by device name
        self.devices: dict = {}
        self._watchers = 0
        self._gc_t0 = 0.0
        self._gc_done = collections.deque()   # collections not yet spans

    # -- thread-local join-key context ----------------------------------

    @contextmanager
    def ctx(self, **ids):
        """Merge ``ids`` into the attrs of spans begun on this thread."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        base = stack[-1] if stack else {}
        stack.append({**base, **ids})
        try:
            yield
        finally:
            stack.pop()

    def _ctx_attrs(self):
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- recording ------------------------------------------------------

    def begin(self, name: str, *, qid: int = -1, slot: int = -1,
              tick: int = -1, **attrs) -> SpanHandle:
        t0 = self.clock()
        if not self.enabled:
            return SpanHandle(name, qid, slot, tick, t0, 0, attrs or None)
        ctx = self._ctx_attrs()
        if ctx:
            attrs = {**ctx, **attrs}
        ident = threading.get_ident()
        h = SpanHandle(name, qid, slot, tick, t0, 0, attrs or None)
        with self._lock:
            ent = self._tids.get(ident)
            if ent is None:
                ent = (len(self._tids), threading.current_thread().name)
                self._tids[ident] = ent
            h.tid = ent[0]
            self.n_begun += 1
            self._open[id(h)] = h
        return h

    def end(self, h: SpanHandle | None, **attrs) -> SpanHandle | None:
        """Close ``h``.  Idempotent: the first close wins, later calls
        are no-ops — so resolve and cancel may race on one request span
        without double-counting.  ``None`` handles are ignored so call
        sites need no obs-off guard."""
        t1 = self.clock()
        if h is None:
            return None
        if not self.enabled:
            if not h.ended:
                h.t1 = t1
                if attrs:
                    h.attrs = {**(h.attrs or {}), **attrs}
            return h
        with self._lock:
            if h.ended:
                return h
            h.t1 = t1
            if attrs:
                h.attrs = {**(h.attrs or {}), **attrs}
            self._open.pop(id(h), None)
            self.n_ended += 1
            self._append(h)
        return h

    @contextmanager
    def span(self, name: str, *, qid: int = -1, slot: int = -1,
             tick: int = -1, **attrs):
        h = self.begin(name, qid=qid, slot=slot, tick=tick, **attrs)
        if not self._cpu:
            try:
                yield h
            finally:
                self.end(h)
            return
        c0 = time.thread_time()
        try:
            yield h
        finally:
            cpu_ms = (time.thread_time() - c0) * 1e3
            self.end(h, cpu_ms=cpu_ms)
            if h.attrs is not None:
                h.attrs["wait_ms"] = h.dur_ms - cpu_ms

    def record(self, name: str, t0: float, t1: float, *, qid: int = -1,
               slot: int = -1, tick: int = -1, **attrs) -> SpanHandle | None:
        """Retrospective span from caller-supplied times (the caller's
        clock must be the recorder's clock for lanes to line up)."""
        if not self.enabled:
            return None
        ctx = self._ctx_attrs()
        if ctx:
            attrs = {**ctx, **attrs}
        ident = threading.get_ident()
        h = SpanHandle(name, qid, slot, tick, t0, 0, attrs or None)
        h.t1 = t1
        with self._lock:
            ent = self._tids.get(ident)
            if ent is None:
                ent = (len(self._tids), threading.current_thread().name)
                self._tids[ident] = ent
            h.tid = ent[0]
            self.n_begun += 1
            self.n_ended += 1
            self._append(h)
        return h

    def event(self, name: str, **kw) -> SpanHandle | None:
        """Zero-duration marker (fallback trips, hot-swap installs)."""
        t = self.clock()
        return self.record(name, t, t, **kw)

    # -- watching: collections and device intervals --------------------

    @property
    def watching(self) -> bool:
        return self._watchers > 0

    def watch(self) -> None:
        """Record collections and device intervals until the matching
        ``unwatch()`` (calls nest; a disabled recorder ignores both)."""
        if not self.enabled:
            return
        with self._lock:
            self._watchers += 1
            first = self._watchers == 1
        if first:
            gc.callbacks.append(self._gc_callback)

    def unwatch(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._watchers == 0:
                return
            self._watchers -= 1
            last = self._watchers == 0
        if last:
            gc.callbacks.remove(self._gc_callback)

    def _gc_callback(self, phase, info):
        # runs inside a collection, on the collecting thread, maybe
        # while it holds self._lock: queue, never lock
        if phase == "start":
            self._gc_t0 = self.clock()
            return
        th = threading.current_thread()
        self._gc_done.append((self._gc_t0, self.clock(), info["generation"],
                              info["collected"], th.ident, th.name))

    def _flush_gc(self) -> None:
        """Move the queued collections into the ring as ``gc`` spans."""
        done = self._gc_done
        with self._lock:
            while done:
                t0, t1, gen, collected, ident, tname = done.popleft()
                ent = self._tids.get(ident)
                if ent is None:
                    ent = (len(self._tids), tname)
                    self._tids[ident] = ent
                h = SpanHandle("gc", -1, -1, -1, t0, ent[0],
                               {"gen": gen, "collected": collected})
                h.t1 = t1
                self.n_begun += 1
                self.n_ended += 1
                self._append(h)

    def _append(self, h):
        # caller holds self._lock
        if len(self._ring) < self.capacity:
            self._ring.append(h)
        else:
            self._ring[self._head] = h
            self._head = (self._head + 1) % self.capacity
            self.n_dropped += 1

    # -- inspection -----------------------------------------------------

    def spans(self) -> list:
        """Completed spans, oldest first (a snapshot copy), with the
        queued collections moved in and the device intervals that have
        completed resolved."""
        self._flush_gc()
        for timer in list(self.devices.values()):
            timer.resolve()
        with self._lock:
            ring = list(self._ring)
            head = self._head
        return ring[head:] + ring[:head]

    def open_spans(self) -> list:
        with self._lock:
            return list(self._open.values())

    def counts(self) -> dict:
        with self._lock:
            return {"n_begun": self.n_begun, "n_ended": self.n_ended,
                    "n_dropped": self.n_dropped,
                    "n_open": len(self._open), "n_held": len(self._ring)}

    def thread_names(self) -> dict:
        with self._lock:
            return {lane: name for lane, name in self._tids.values()}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._head = 0
            self._open.clear()
            self._gc_done.clear()
            self.n_begun = self.n_ended = self.n_dropped = 0


#: shared disabled recorder — stamps times on handles, records nothing
NULL_TRACE = TraceRecorder(capacity=0, enabled=False)
