"""Deadline-driven request admission over the padded-batch grid (a copy
of ``repro.serving.admission``).

``AdmissionQueue`` is the front door of the unified serving API
(serving/service.py): callers ``submit`` one request at a time and get a
``concurrent.futures.Future`` back; the queue forms batches from the
pending set by *deadline*, not arrival order, so a late-arriving urgent
request can jump the line (the tail-latency framing of Mackenzie et al.,
arXiv:1704.03970 — deadlines under load, not fixed micro-batches).

Batch formation policy (``poll``): dispatch the up-to-``max_batch``
earliest-deadline requests as soon as any of

  * the pending set can fill a whole batch (``max_batch``),
  * the oldest pending request has waited ``max_wait_ms`` (bounded
    staleness even at low load), or
  * the most urgent deadline is within ``service_estimate_ms`` of now
    (leaving just enough slack to actually serve it)

holds.  Batch sizes are snapped up to the ``pad_multiple`` grid the
engine compiles for, and every formed batch's padded size is recorded in
``shape_counts`` — that census is what the learned warmup policy
(service.WarmupPolicy) reads instead of an explicit batch-size list.

The queue is pure batching logic: thread-safe but threadless, with an
injectable clock (every public method takes ``now=``) so tests drive the
policy deterministically.  The service owns the threads.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time
from concurrent.futures import Future

from repro_torch.obs import NULL_OBS
from repro_torch.serving import bucketing

__all__ = ["AdmissionConfig", "Request", "Batch", "AdmissionQueue"]


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    max_batch: int = 128           # dispatch cap (pre-padding)
    pad_multiple: int = 8          # engine pad grid
    max_wait_ms: float = 5.0       # oldest-request staleness bound
    service_estimate_ms: float = 2.0   # slack reserved to run the batch
    default_deadline_ms: float = 100.0  # used when submit() gives none


@dataclasses.dataclass
class Request:
    payload: object                # one request row (backend-defined)
    deadline: float                # absolute, perf_counter seconds
    t_submit: float
    seq: int                       # FIFO tie-break within a deadline
    future: Future
    span: object = None            # open "request" span (None with
    #                                tracing off); seq is the trace_id
    #                                joining spans to telemetry

    def sort_key(self):
        return (self.deadline, self.seq)


@dataclasses.dataclass
class Batch:
    requests: list[Request]
    padded_size: int
    t_formed: float
    trigger: str                   # "full" | "wait" | "deadline" | "flush"

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def payloads(self) -> list:
        return [r.payload for r in self.requests]


class AdmissionQueue:
    """Deadline-ordered pending set + the batch formation policy."""

    def __init__(self, cfg: AdmissionConfig | None = None):
        self.cfg = cfg or AdmissionConfig()
        self._lock = threading.Lock()
        self._heap: list[tuple[tuple, Request]] = []
        self._ready: collections.deque[Batch] = collections.deque()
        self._seq = itertools.count()
        self.shape_counts: collections.Counter[int] = collections.Counter()
        self.n_submitted = 0
        self.obs = NULL_OBS
        self._m_submitted = NULL_OBS.metrics.counter("queue.submitted")

    def bind_obs(self, obs) -> None:
        """Attach an observability handle (obs locks are leaves, so
        recording under ``_lock`` is within the global order)."""
        self.obs = obs
        self._m_submitted = obs.metrics.counter("queue.submitted")

    # ------------------------------------------------------------ submit --
    def submit(self, payload, deadline_ms: float | None = None,
               now: float | None = None) -> Future:
        """Enqueue one request; returns the future its result resolves."""
        now = time.perf_counter() if now is None else now
        if deadline_ms is None:
            deadline_ms = self.cfg.default_deadline_ms
        fut: Future = Future()
        req = Request(payload=payload, deadline=now + deadline_ms / 1e3,
                      t_submit=now, seq=next(self._seq), future=fut)
        if self.obs.trace.enabled:
            req.span = self.obs.trace.begin("request", qid=req.seq)
        self._m_submitted.inc()
        with self._lock:
            heapq.heappush(self._heap, (req.sort_key(), req))
            self.n_submitted += 1
        return fut

    def submit_many(self, payloads, deadline_ms: float | None = None,
                    now: float | None = None) -> list[Future]:
        return [self.submit(p, deadline_ms, now=now) for p in payloads]

    # -------------------------------------------------------------- state --
    def __len__(self) -> int:
        with self._lock:
            return len(self._heap) + sum(len(b) for b in self._ready)

    def _oldest(self) -> Request | None:
        return min((r for _, r in self._heap),
                   key=lambda r: r.t_submit, default=None)

    def next_event(self, now: float) -> float | None:
        """Seconds until the policy could next fire (None: queue empty,
        0.0: a batch is ready now).  The service thread sleeps this long."""
        with self._lock:
            if self._ready:
                return 0.0
            if not self._heap:
                return None
            if len(self._heap) >= self.cfg.max_batch:
                return 0.0
            oldest = self._oldest()
            urgent = self._heap[0][1]
            t_wait = oldest.t_submit + self.cfg.max_wait_ms / 1e3
            t_dead = urgent.deadline - self.cfg.service_estimate_ms / 1e3
            return max(0.0, min(t_wait, t_dead) - now)

    # --------------------------------------------------------------- poll --
    def poll(self, now: float | None = None) -> Batch | None:
        """Return the next batch if the formation policy fires, else None.

        Requests leave in deadline order (FIFO within equal deadlines), so
        the most urgent work rides the earliest dispatch.
        """
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._ready:
                return self._ready.popleft()
            if not self._heap:
                return None
            trigger = None
            if len(self._heap) >= self.cfg.max_batch:
                trigger = "full"
            else:
                oldest = self._oldest()
                urgent = self._heap[0][1]
                if now - oldest.t_submit >= self.cfg.max_wait_ms / 1e3:
                    trigger = "wait"
                elif (urgent.deadline - now
                      <= self.cfg.service_estimate_ms / 1e3):
                    trigger = "deadline"
            if trigger is None:
                return None
            return self._form(trigger, now)

    # ------------------------------------------------------ slot handoff --
    def take_urgent(self, n: int) -> list[Request]:
        """Pop up to ``n`` most-urgent pending requests (deadline order,
        FIFO within equal deadlines) — the continuous scheduler's slot
        refill path.  Bypasses batch formation entirely: no census entry,
        nothing lands in ``_ready``; the scheduler owns the popped
        requests until it resolves them or hands them back."""
        with self._lock:
            take = min(int(n), len(self._heap))
            return [heapq.heappop(self._heap)[1] for _ in range(take)]

    def requeue(self, reqs) -> None:
        """Return un-admitted requests (class co-grouping leftovers) to
        the pending set; the heap restores deadline order, and their
        original submit times keep staleness accounting honest."""
        with self._lock:
            for r in reqs:
                heapq.heappush(self._heap, (r.sort_key(), r))

    def flush(self, now: float | None = None) -> list[Batch]:
        """Force-form batches from everything pending (drain / shutdown /
        deterministic tests).  Formed batches queue up for ``poll``."""
        now = time.perf_counter() if now is None else now
        out = []
        with self._lock:
            while self._heap:
                b = self._form("flush", now)
                self._ready.append(b)
                out.append(b)
        return out

    def _form(self, trigger: str, now: float) -> Batch:
        # caller holds the lock
        take = min(len(self._heap), self.cfg.max_batch)
        reqs = [heapq.heappop(self._heap)[1] for _ in range(take)]
        padded = bucketing.pad_length(len(reqs), self.cfg.pad_multiple)
        self.shape_counts[padded] += 1
        for r in reqs:
            # retrospective: the request's wait in the pending set
            self.obs.trace.record("queue", r.t_submit, now, qid=r.seq,
                                  trigger=trigger)
        return Batch(requests=reqs, padded_size=padded, t_formed=now,
                     trigger=trigger)
