"""Device intervals of the port's spans, on the span recorder's clock.

A captured program's call (the server's predict program, each engine
stage) is host work that queues device work: its span shows the host's
time, and the card's time is somewhere inside or after it.  A
``DeviceTimer`` puts a CUDA event pair around the call, on the calling
thread's current stream (the start before the copy-in, the end after
the clone-out), and later resolves the pair into attrs of the span:

- ``dev_t0`` / ``dev_t1``: when the stream reached each event, in the
  recorder's clock seconds, so host spans and device intervals sit on
  one timeline (``export.chrome_trace`` draws a device lane a stream);
- ``dev_ms``: the interval's length on the card's clock, which holds
  any gap in which the stream waited for the host's launches;
- ``dev_stream``: the lane, ``"<device> stream <id>"``.

The card's clock is tied to the recorder's by an anchor: an event
recorded on a stream with nothing queued, beside the recorder clock
read just after the record.  The caller says where that holds
(``anchor()`` just after a readback, which waited for the stream).  An
anchor whose record took longer than ``skew_s`` (the thread lost the
interpreter lock around it, so the clock reading is late) is tried
again at the next call, and kept only while no better anchor was taken
in the last ``4 * refresh_s``.  A good anchor is taken at most every
``refresh_s`` seconds, the newest one whose event has completed maps
every pair, and a pair's times are its events' ``elapsed_time`` from
the anchor's.

Nothing here waits for the card: a pair is resolved once its end event
has completed (``query()``), when an anchor is taken, when the pool runs
dry, or at the latest when ``TraceRecorder.spans()`` is read; a pair
still running then stays queued for a later read.  Events come from a
bounded pool (``capacity`` events, two a pair) and go back to it once
resolved; a span that finds the pool empty gets no interval, and the
registry's counter ``trace.dev_dropped`` counts it.

A timer records only while its recorder is watched (``watch()``: a
``RetrievalService`` from ``start()`` to ``stop()``); a disabled
recorder has no timer at all (``timer`` returns None), so tracing off
records no event.  On the CPU a program runs synchronously, so a
``HostTimer`` gives a span the call's own host interval, lane
``"cpu"``.
"""

from __future__ import annotations

import threading

import torch


def _put(h, t0: float, t1: float, lane: str) -> None:
    attrs = h.attrs if h.attrs is not None else {}
    attrs.update(dev_t0=t0, dev_t1=t1, dev_ms=(t1 - t0) * 1e3,
                 dev_stream=lane)
    h.attrs = attrs


def _call(timer, h, fn, args, kwargs):
    tok = timer.start(h)
    try:
        return fn(*args, **kwargs)
    finally:
        timer.stop(tok)


class HostTimer:
    """The CPU's timer: a span's interval is its call's host interval."""

    lane = "cpu"

    def __init__(self, trace):
        self.trace = trace

    def start(self, h):
        return (h, self.trace.clock()) if self.trace.watching else None

    def stop(self, tok) -> None:
        if tok is not None:
            h, t0 = tok
            _put(h, t0, self.trace.clock(), self.lane)

    def call(self, h, fn, *args, **kwargs):
        return _call(self, h, fn, args, kwargs)

    def anchor(self) -> None:
        pass

    def resolve(self) -> None:
        pass


class DeviceTimer:
    """CUDA event pairs around program calls; see the module docstring.
    ``event`` and ``stream`` make an event and give the calling thread's
    current stream (tests pass stand-ins)."""

    refresh_s = 0.5
    skew_s = 50e-6

    def __init__(self, trace, device, metrics, *, capacity: int = 1024,
                 event=None, stream=None):
        self.trace = trace
        self.device = device
        self._metrics = metrics
        self.capacity = int(capacity)
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._stream = stream or (lambda: torch.cuda.current_stream(device))
        self._lock = threading.Lock()
        self._free: list = []
        self._made = 0
        self._pending: list = []          # (span, start, end, lane)
        self._anchors: list = []          # (event, recorder time), by age
        self._t_anchor = float("-inf")
        self.n_dropped = 0

    def start(self, h):
        """Record the start of ``h``'s interval; returns the token for
        ``stop``, or None (not watched, or the pool is spent)."""
        if not self.trace.watching:
            return None
        with self._lock:
            if len(self._free) < 2 and self._made + 2 > self.capacity:
                self._resolve_held()
            if len(self._free) >= 2:
                e0, e1 = self._free.pop(), self._free.pop()
            elif self._made + 2 <= self.capacity:
                e0, e1 = self._event(), self._event()
                self._made += 2
            else:
                e0 = e1 = None
                self.n_dropped += 1
        if e0 is None:
            self._metrics.counter("trace.dev_dropped").inc()
            return None
        s = self._stream()
        e0.record(s)
        return h, e0, e1, s

    def stop(self, tok) -> None:
        if tok is None:
            return
        h, e0, e1, s = tok
        e1.record(s)
        lane = f"{self.device} stream {s.stream_id}"
        with self._lock:
            self._pending.append((h, e0, e1, lane))

    def call(self, h, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` inside ``h``'s device interval."""
        return _call(self, h, fn, args, kwargs)

    def anchor(self) -> None:
        """Tie the card's clock to the recorder's, at most every
        ``refresh_s``: call only where the calling thread's current
        stream has nothing queued (just after a readback)."""
        if not self.trace.watching:
            return
        if self.trace.clock() - self._t_anchor < self.refresh_s:
            return
        e, s = self._event(), self._stream()
        t0 = self.trace.clock()
        e.record(s)
        t = self.trace.clock()
        late = t - t0 > self.skew_s
        with self._lock:
            if late and t - self._t_anchor < 4 * self.refresh_s:
                return             # the anchor before still serves
            if not late:
                self._t_anchor = t
            self._anchors.append((e, t))
            self._resolve_held()

    def resolve(self) -> None:
        """Resolve every pair whose end event has completed."""
        with self._lock:
            self._resolve_held()

    def _resolve_held(self) -> None:
        # caller holds self._lock
        anchors = self._anchors
        for i in range(len(anchors) - 1, -1, -1):
            if anchors[i][0].query():
                del anchors[:i]
                break
        else:
            return
        ea, ta = anchors[0]
        keep = []
        for item in self._pending:
            h, e0, e1, lane = item
            if not e1.query():
                keep.append(item)
                continue
            _put(h, ta + ea.elapsed_time(e0) / 1e3,
                 ta + ea.elapsed_time(e1) / 1e3, lane)
            self._free += (e0, e1)
        self._pending = keep


def timer(obs, device):
    """The timer that ``obs``'s recorder keeps for ``device``, made at
    the first call; None when the recorder is disabled."""
    trace = obs.trace
    if not trace.enabled:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    found = trace.devices.get(str(device))
    if found is None:
        made = (DeviceTimer(trace, device, obs.metrics)
                if device.type == "cuda" else HostTimer(trace))
        found = trace.devices.setdefault(str(device), made)
    return found
