"""Unified async serving API: one RetrievalService over pluggable backends
(the port of ``repro.serving.service``).

    service = RetrievalService(EngineBackend(server))
    with service:
        fut = service.submit(query_row, deadline_ms=50.0)
        out = fut.result()          # {"ranked": ..., "queue_ms": ..., ...}

* **Admission** (serving/admission.py): requests carry deadlines; the
  queue forms batches by deadline and max-batch-size over the engine's
  pad grid and returns per-request futures.
* **Backends**: anything implementing the small ``Backend`` protocol --
  ``EngineBackend`` (cascade + batch-once engine),
  ``ShardedEngineBackend`` (the same over a mesh-sharded engine) and
  ``FunnelBackend`` (two-tower + BST funnel).  ``ContinuousBackend``
  opts out of batch formation: the slot-table scheduler
  (``serving/sched``) admits requests into in-flight work at stage
  boundaries and retires each one at its own predicted budget, all on
  one tick thread on the device's default stream.
* **Overlap**: the backend splits into ``predict`` (the admission-side
  cascade) and ``execute`` (the staged engine dispatch); the service runs
  them on separate threads connected by a bounded handoff queue, so the
  cascade prediction for batch N+1 overlaps the engine dispatch of
  batch N.  On a CUDA backend the admission thread issues predict's
  device work on a CUDA stream of its own, and every timing fence of the
  engine and the funnel waits for the calling thread's stream alone, so
  a stage's span does not absorb the other thread's predict.  The
  execution and warmup threads stay on the device's default stream, the
  stream ``warmup_now`` and inline serving use: the caching allocator
  keeps each stream's blocks apart, so a warmup on another stream would
  leave the execution stream's first batch to allocate afresh.  The
  price: a shape the warmup thread warms while traffic is live queues
  its device work ahead of the live batch on that stream, and the
  batch's stage spans and ``service_ms`` include it.  No tensor crosses
  threads: predict hands numpy classes to execute.
* **Learned warmup** (``WarmupPolicy``): instead of an explicit
  ``warmup_batch_sizes`` list, the policy watches the admission queue's
  padded-batch-size census and warms the most common shapes on a
  background thread: warming a shape builds the engine's programs for it
  (on a card, a CUDA graph per stage, captured on a side stream in the
  warmup thread while the execution thread serves beside it).
* **The collector**: while a service runs threaded, the objects that
  exist when it starts (the imports', the index's, the built programs')
  are frozen out of the collector (``gc.freeze()``, after one
  ``gc.collect()`` so no set-up garbage is kept), so a full collection
  walks only what serving allocated.  The freeze is the process's and
  counted: two services share it, and the last ``stop()`` unfreezes.

``step()`` runs one admission+dispatch cycle inline (no threads, the
caller's stream) -- the deterministic mode tests and synchronous callers
use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import queue as queue_lib
import threading
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.obs import NULL_OBS, NULL_TRACE
from repro_torch.serving import bucketing
from repro_torch.serving.admission import (AdmissionConfig, AdmissionQueue,
                                           Batch)
from repro_torch.serving.server import ServerStats

__all__ = ["Backend", "EngineBackend", "ShardedEngineBackend",
           "ContinuousBackend", "FunnelBackend", "WarmupPolicy",
           "RetrievalService"]

# predicted batches the admission thread may run ahead of execution
_HANDOFF_DEPTH = 2

# services running threaded, which hold the process's collector freeze
_freeze_lock = threading.Lock()
_freeze_holders = 0


def _hold_freeze() -> int:
    """Take a hold on the collector freeze; the first holder collects
    what is garbage now and freezes the rest.  Returns the objects this
    hold froze (0 when the heap was already frozen by another hold)."""
    global _freeze_holders
    with _freeze_lock:
        _freeze_holders += 1
        if _freeze_holders > 1:
            return 0
        gc.collect()
        gc.freeze()
        return gc.get_freeze_count()


def _release_freeze() -> None:
    """Drop a hold; the last one unfreezes, and the frozen objects go
    back into the eldest generation."""
    global _freeze_holders
    with _freeze_lock:
        _freeze_holders -= 1
        if _freeze_holders == 0:
            gc.unfreeze()


# ------------------------------------------------------------- backends --

@runtime_checkable
class Backend(Protocol):
    """What a workload must provide to be served by RetrievalService.

    ``predict`` is the cheap admission-side stage (the cascade); the
    service overlaps it with the previous batch's ``execute``.  Both
    operate on a *collated* batch so the service never inspects payloads.
    """

    pad_multiple: int
    n_classes: int                    # cascade classes (histogram width)
    device: torch.device              # where predict and execute run

    def collate(self, payloads: list):
        """Stack per-request payload rows into one batch object."""
        ...

    def predict(self, batch):
        """Admission-side parameter prediction (cascade forward pass)."""
        ...

    def execute(self, batch, pred) -> tuple[list[dict], dict]:
        """Serve the batch at the predicted parameters.  Returns
        (per-request result dicts, per-stage timings in ms)."""
        ...

    def warmup_shape(self, padded_size: int) -> int | None:
        """Build the programs of one padded batch size; returns the
        number of fresh builds (0 if already warm), or None when the
        backend cannot warm yet (e.g. request sizing still unknown) --
        the policy will retry such shapes later."""
        ...

    @property
    def n_compiles(self) -> int | None:
        """Executable-cache size, when the backend tracks one."""
        ...


class EngineBackend:
    """Text-retrieval backend: forest cascade + batch-once ServingEngine.

    Payload per request: one ``(qlen,)`` int32 query-term row.
    """

    def __init__(self, server, query_len: int | None = None):
        self.server = server
        self.pad_multiple = server.engine.batch_multiple
        self.n_classes = len(server.cfg.cutoffs) + 1
        self.device = server.device
        self.query_len = query_len     # learned from the first batch

    def collate(self, payloads: list) -> np.ndarray:
        qt = np.stack([np.asarray(p, np.int32) for p in payloads])
        self.query_len = qt.shape[1]
        return qt

    def predict(self, qt: np.ndarray):
        # the predictor version is read *with* the weights the predict
        # copies in: a hot-swap landing before, during or after it must
        # not re-attribute this batch's classes to other weights
        return self.server.predict_versioned(qt)

    def execute(self, qt, pred) -> tuple[list[dict], dict]:
        classes, ver = pred
        server = self.server
        widths = server.params_of(np.asarray(classes))
        dclasses, depths = server.predict_depths(qt)
        ranked, timings = server.engine.serve(qt, widths, depth_vec=depths)
        results = [
            {"ranked": ranked[i], "class": int(classes[i]),
             "width": float(widths[i]), "predictor_version": ver,
             "depth": (float(depths[i]) if depths is not None else None),
             "depth_class": (int(dclasses[i]) if dclasses is not None
                             else None)}
            for i in range(qt.shape[0])
        ]
        return results, timings

    def warmup_shape(self, padded_size: int) -> int | None:
        if not self.query_len:
            return None                # no batch seen yet to size queries
        with_depth = self.server.has_depth_knob
        n = self.server.engine.warmup_shape(padded_size, self.query_len,
                                            with_depth=with_depth)
        dummy = np.full((padded_size, self.query_len), -1, np.int32)
        if self.server.cascade is not None:
            self.server.predict_classes(dummy)
        if with_depth and self.server.depth_cascade is not None:
            self.server.predict_classes(dummy, knob="depth")
        return n

    @property
    def n_compiles(self) -> int | None:
        return self.server.engine.n_compiles

    def bind_obs(self, obs) -> None:
        """Forward the service's observability handle to the server and
        its engine (the predict program's span, per-stage spans,
        dispatch/compile counters)."""
        self.server.bind_obs(obs)

    @property
    def predictor_version(self) -> int:
        """Version stamp of the live cascade weights."""
        return self.server.predictor_version

    def swap_predictor(self, node_params, thresholds=None, *,
                       version: int | None = None,
                       knob: str | None = None) -> int:
        """Hot-swap a knob's cascade tables in the server's predict path
        (see ``pipeline.RetrievalServer.swap_predictor``)."""
        return self.server.swap_predictor(node_params, thresholds,
                                          version=version, knob=knob)


class ShardedEngineBackend(EngineBackend):
    """``EngineBackend`` over a mesh-sharded engine.

    The same protocol: admission, the predict/execute overlap, learned
    warmup and per-stage timing work unchanged, while the engine shards
    the doc dimension over the mesh's 'model' axis and request batches
    over ('pod', 'data').  The admission ``pad_multiple`` (the engine's
    ``batch_multiple``) makes every padded batch divide over the data
    axes.  Build the server with a mesh::

        server = RetrievalServer(index, casc, cfg, mesh=mesh)
        service = RetrievalService(ShardedEngineBackend(server))
    """

    def __init__(self, server, query_len: int | None = None):
        from repro_torch.serving.engine import ShardedServingEngine
        if not isinstance(server.engine, ShardedServingEngine):
            raise TypeError(
                "ShardedEngineBackend needs a RetrievalServer built with "
                "a mesh (RetrievalServer(..., mesh=mesh)); got an "
                "unsharded engine — use EngineBackend for that.")
        super().__init__(server, query_len)


class ContinuousBackend:
    """Continuous-batching backend: the slot-table scheduler
    (``serving/sched``) replaces batch-once formation.

    It deviates from the ``Backend`` protocol on purpose: the service
    detects a ``ContinuousBackend`` and routes admission straight to the
    scheduler's slot refill (``collate``/``predict``/``execute`` never
    run).  Warmup, stats, telemetry and the hot-swap hook keep
    ``EngineBackend``'s surface.

    Constructor knobs (forwarded to ``ContinuousScheduler``): ``slots``
    (table capacity), ``grain`` (refill/finalize group width, default
    the engine's pad multiple), ``chunk_p`` (stage-1 chunk length,
    default the largest divisor of ``stream_cap`` <= cap/8), ``window``
    (candidate pool for class co-grouping), ``co_group``, and
    ``fixed_param`` (serve everything at one budget: the
    dynamic-vs-fixed race's baseline arm).
    """

    def __init__(self, server, query_len: int | None = None, *,
                 slots: int = 32, grain: int | None = None,
                 chunk_p: int | None = None, window: int | None = None,
                 co_group: bool = True, fixed_param: int | None = None):
        eng = server.engine
        if not eng.supports_continuous:
            raise TypeError("ContinuousBackend: "
                            + eng.continuous_unsupported_reason)
        self.server = server
        self.pad_multiple = eng.batch_multiple
        self.n_classes = len(server.cfg.cutoffs) + 1
        self.device = server.device
        self.query_len = query_len
        self._sched_kw = dict(slots=slots, grain=grain, chunk_p=chunk_p,
                              window=window, co_group=co_group,
                              fixed_param=fixed_param)
        self.scheduler = None          # bound by RetrievalService

    def bind_obs(self, obs) -> None:
        self.server.engine.bind_obs(obs)
        if self.scheduler is not None:
            self.scheduler.bind_obs(obs)

    def make_scheduler(self, queue, on_results):
        from repro_torch.serving.sched import ContinuousScheduler
        self.scheduler = ContinuousScheduler(
            self.server, queue, query_len=self.query_len,
            on_results=on_results, **self._sched_kw)
        return self.scheduler

    def warmup_shape(self, padded_size: int) -> int | None:
        # the scheduler's shapes are fixed by (slots, grain, chunk_p),
        # not the admission census: any observed size warms the same
        # four stages and the cascade's padded candidate windows
        del padded_size
        if self.scheduler is None:
            return None
        return self.scheduler.warmup()

    @property
    def n_compiles(self) -> int | None:
        return self.server.engine.n_compiles

    @property
    def predictor_version(self) -> int:
        return self.server.predictor_version

    def swap_predictor(self, node_params, thresholds=None, *,
                       version: int | None = None,
                       knob: str | None = None) -> int:
        return self.server.swap_predictor(node_params, thresholds,
                                          version=version, knob=knob)


class FunnelBackend:
    """Recsys-funnel backend: two-tower stage 1 + BST stage 2.

    Payload per request: ``(user_feats_row, hist_items_row)``.  The
    backend pads batches to the same grid the admission queue censuses;
    padding rows (zero features, empty history, class 0) are sliced off
    before results resolve.
    """

    def __init__(self, funnel, pad_multiple: int = 8):
        self.funnel = funnel
        self.pad_multiple = pad_multiple
        self.n_classes = len(funnel.cfg.cutoffs) + 1
        self.device = funnel.device
        self._warm_shapes: set[int] = set()
        self.trace = NULL_TRACE

    def bind_obs(self, obs) -> None:
        self.trace = obs.trace

    def collate(self, payloads: list):
        uf = np.stack([np.asarray(p[0], np.float32) for p in payloads])
        hist = np.stack([np.asarray(p[1], np.int32) for p in payloads])
        return uf, hist

    def _pad(self, uf, hist, classes=None):
        n = uf.shape[0]
        uf = bucketing.pad_rows(uf, self.pad_multiple, fill=0.0)
        hist = bucketing.pad_rows(hist, self.pad_multiple, fill=-1)
        if classes is not None:
            classes = bucketing.pad_rows(
                np.asarray(classes), self.pad_multiple, fill=0)
        return n, uf, hist, classes

    def predict(self, batch) -> np.ndarray:
        n, uf, hist, _ = self._pad(*batch)
        return self.funnel.predict(uf, hist)[:n]

    def execute(self, batch, classes) -> tuple[list[dict], dict]:
        n, uf, hist, cls = self._pad(*batch, classes)
        with self.trace.span("engine.funnel") as sp:
            dcls = (self.funnel.predict(uf, hist, knob="depth")
                    if self.funnel.has_depth_knob else None)
            out = self.funnel.execute(uf, hist, cls, depth_classes=dcls)
        timings = {"funnel_ms": sp.dur_ms}
        results = [
            {"ranked": out["ranked"][i], "class": int(classes[i]),
             "width": float(out["k"][i]),
             "depth": (float(out["depths"][i]) if dcls is not None
                       else None)}
            for i in range(n)
        ]
        return results, timings

    def warmup_shape(self, padded_size: int) -> int:
        """Build the funnel's programs of every cutoff at ``padded_size``
        (one execute per cutoff: a program is keyed on the batch's
        largest k as well), as the JAX backend warms them.  Returns the
        cutoffs run, 0 when the shape was already warm here."""
        if padded_size in self._warm_shapes:
            return 0
        cfg = self.funnel.cfg
        uf = np.zeros((padded_size, cfg.tower.d_user_in), np.float32)
        hist = np.full((padded_size, cfg.bst.seq_len), -1, np.int32)
        self.funnel.predict(uf, hist)
        classes = np.zeros(padded_size, np.int64)
        for c in range(len(cfg.cutoffs)):
            self.funnel.execute(uf, hist, np.full_like(classes, c))
        self._warm_shapes.add(padded_size)
        return len(cfg.cutoffs)

    @property
    def n_compiles(self) -> int | None:
        return None    # the reference's: its jit cache is jax's (the
        #                programs built are Funnel.n_compiles)


# --------------------------------------------------------------- warmup --

class WarmupPolicy:
    """Learned warmup: run the padded batch shapes the admission queue
    actually produces once, instead of an operator-supplied list.

    ``observe`` feeds the policy one formed batch's padded size; once a
    shape has been seen ``min_count`` times it is scheduled (the
    service's background thread calls ``run``).  At most ``max_shapes``
    distinct shapes are ever warmed.

    With a ``census_path``, the census *persists across runs*: the
    service saves the observed shape counts on ``stop()`` and reloads
    them at construction, scheduling the previous run's most common
    shapes immediately.  Shapes that fail to warm land in ``failed``.
    """

    def __init__(self, min_count: int = 1, max_shapes: int = 8,
                 census_path: str | None = None):
        self.min_count = min_count
        self.max_shapes = max_shapes
        self.census_path = census_path
        self.counts: dict[int, int] = {}
        self.compiled: set[int] = set()
        self.failed: dict[int, Exception] = {}
        self._pending: queue_lib.SimpleQueue = queue_lib.SimpleQueue()
        self._scheduled: set[int] = set()
        self._lock = threading.Lock()

    # ----------------------------------------------- census persistence --
    def load_census(self) -> list[int]:
        """Seed the census from the previous run's persisted shape counts
        and schedule the most common shapes for background warmup.
        Returns the scheduled shapes (empty when there is no census)."""
        if not self.census_path or not os.path.exists(self.census_path):
            return []
        try:
            with open(self.census_path) as f:
                raw = json.load(f).get("shapes", {})
            shapes = {int(s): int(c) for s, c in raw.items()}
        except (OSError, ValueError, TypeError, AttributeError):
            return []                  # corrupt census: start fresh
        scheduled = []
        with self._lock:
            for s, c in shapes.items():
                self.counts[s] = self.counts.get(s, 0) + c
            order = sorted(self.counts, key=lambda s: (-self.counts[s], s))
            # schedule at most half the slots from history: _scheduled
            # never shrinks, so a full census would otherwise lock live
            # traffic's new shapes out of background warmup forever
            cap = max(1, self.max_shapes // 2)
            for s in order:
                if (self.counts[s] >= self.min_count
                        and s not in self._scheduled
                        and len(self._scheduled) < cap):
                    self._scheduled.add(s)
                    self._pending.put(s)
                    scheduled.append(s)
        return scheduled

    def save_census(self) -> str | None:
        """Persist the observed padded-shape counts (no-op without a
        ``census_path``); the write is atomic (tmp + rename)."""
        if not self.census_path:
            return None
        with self._lock:
            shapes = {str(s): int(c) for s, c in sorted(self.counts.items())}
        payload = {"shapes": shapes, "unix_time": time.time()}
        d = os.path.dirname(os.path.abspath(self.census_path))
        os.makedirs(d, exist_ok=True)
        tmp = self.census_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, self.census_path)
        return self.census_path

    def observe(self, padded_size: int) -> None:
        with self._lock:
            self.counts[padded_size] = self.counts.get(padded_size, 0) + 1
            if (self.counts[padded_size] >= self.min_count
                    and padded_size not in self._scheduled
                    and len(self._scheduled) < self.max_shapes):
                self._scheduled.add(padded_size)
                self._pending.put(padded_size)

    def top_shapes(self, k: int | None = None) -> list[int]:
        """Most frequently observed padded sizes, descending."""
        with self._lock:
            order = sorted(self.counts, key=lambda s: (-self.counts[s], s))
        return order[:k or self.max_shapes]

    def run(self, backend: Backend, block: bool = False,
            timeout: float | None = 0.05) -> int:
        """Warm scheduled shapes on the calling thread.  Returns the
        number of shapes warmed this call."""
        done = 0
        while True:
            try:
                shape = self._pending.get(block=block, timeout=timeout)
            except queue_lib.Empty:
                return done
            with self._lock:
                warm = shape in self.compiled
            if warm:
                continue
            try:
                # outside the lock: concurrent observe()/census calls
                # must not stall behind a warmup run
                n = backend.warmup_shape(shape)
            except Exception as e:     # noqa: BLE001 -- warmup must never
                with self._lock:       # kill the background thread; the
                    self.failed[shape] = e  # shape just warms at serve
                continue                    # time
            if n is None:
                # backend can't warm yet (e.g. request sizing unknown):
                # leave it schedulable for a later pass
                with self._lock:
                    self._scheduled.discard(shape)
                continue
            with self._lock:
                self.compiled.add(shape)
            done += 1

    def prewarm(self, backend: Backend, sizes) -> int:
        """Synchronous explicit warmup (deploy-time / benchmarks)."""
        n = 0
        for s in sizes:
            s = bucketing.pad_length(int(s), backend.pad_multiple)
            with self._lock:
                warm = s in self.compiled
            if warm:
                continue
            if backend.warmup_shape(s) is None:
                continue               # backend can't size this shape yet
            with self._lock:
                self.compiled.add(s)
                self._scheduled.add(s)
            n += 1
        return n


# -------------------------------------------------------------- service --

@dataclasses.dataclass
class _BatchRecord:
    n: int
    predict_ms: float
    service_ms: float
    queue_ms: list                     # per request: admission delay
    total_ms: list                     # per request: submit -> resolve
    timings: dict
    classes: list
    widths: list


class RetrievalService:
    """One async request/response front door over any ``Backend``.

    Threaded mode (``start``/``stop`` or context manager): an admission
    thread forms batches and runs ``backend.predict``; an execution
    thread runs ``backend.execute`` and resolves futures -- so prediction
    for batch N+1 overlaps dispatch of batch N.  A third daemon thread
    drains the warmup policy.  On a card the admission thread runs on a
    CUDA stream of its own; execution and warmup share the default
    stream, whose allocator blocks the warmup fills, so a batch's stage
    spans include any warmup running beside it.  From ``start`` to
    ``stop`` the heap that existed at ``start`` is frozen out of the
    collector; the ``service.gc_frozen`` gauge reads the objects this
    service froze.

    Inline mode: ``step()`` performs one poll->predict->execute cycle on
    the calling thread (deterministic; used by tests and ``serve_all``
    when the service is not started).
    """

    _SENTINEL = object()

    def __init__(self, backend: Backend,
                 admission: AdmissionConfig | None = None,
                 warmup: WarmupPolicy | None = None,
                 telemetry=None,
                 obs=None):
        if admission is None:
            admission = AdmissionConfig(pad_multiple=backend.pad_multiple)
        elif admission.pad_multiple != backend.pad_multiple:
            # the backend's grid is ground truth: a mismatched census
            # would warm shapes the engine never pads to
            admission = dataclasses.replace(
                admission, pad_multiple=backend.pad_multiple)
        self.backend = backend
        self.queue = AdmissionQueue(admission)
        self.warmup = WarmupPolicy() if warmup is None else warmup
        # previous run's padded-shape census (if the policy persists one)
        self.warmup.load_census()
        #: optional telemetry tap (duck-typed: anything with
        #: ``record(payload, result, version, t_wall)``), called per
        #: request after the futures resolve
        self.telemetry = telemetry
        self._handoff: queue_lib.Queue = queue_lib.Queue(_HANDOFF_DEPTH)
        self._records: list[_BatchRecord] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition()
        self._gen = 0                  # bumps on submit/flush (lost-wakeup
        self._stop = threading.Event()  # guard for the admit loop)
        self._outstanding = 0
        self._n_deadline_met = 0
        self._n_deadline_missed = 0
        self._n_cancelled = 0
        self._threads: list[threading.Thread] = []
        # continuous mode: a ContinuousBackend swaps batch formation for
        # the slot-table scheduler; admission still runs through
        # self.queue (deadline heap), but the scheduler pops it directly
        self._sched = None
        if isinstance(backend, ContinuousBackend):
            self._sched = backend.make_scheduler(self.queue,
                                                 self._note_results)
        # predict's stream, made once: its creation and its allocator
        # blocks are paid here and outlive a stop()/start(); None off CUDA
        dev = backend.device
        self._predict_stream = (torch.cuda.Stream(device=dev)
                                if dev.type == "cuda" else None)
        #: one observability handle for the whole request path: the
        #: service binds it to the queue, the backend (which forwards to
        #: the engine) and its own loops.  NULL_OBS (the default) records
        #: nothing; handles still carry times.
        self.obs = NULL_OBS if obs is None else obs
        self.queue.bind_obs(self.obs)
        bind = getattr(backend, "bind_obs", None)
        if bind is not None:
            bind(self.obs)
        self._bseq = itertools.count()  # batch join key for trace.ctx
        self._m_batches = self.obs.metrics.counter("service.batches")
        self._m_met = self.obs.metrics.counter("service.deadline_met")
        self._m_missed = self.obs.metrics.counter(
            "service.deadline_missed")
        self._m_cancelled = self.obs.metrics.counter("service.cancelled")
        self._m_frozen = self.obs.metrics.gauge("service.gc_frozen")

    # ------------------------------------------------------------ submit --
    def submit(self, payload, deadline_ms: float | None = None):
        fut = self.queue.submit(payload, deadline_ms)
        with self._lock:
            self._outstanding += 1
        fut.add_done_callback(self._on_done)
        with self._wake:
            self._gen += 1
            self._wake.notify_all()
        return fut

    def submit_many(self, payloads, deadline_ms: float | None = None):
        return [self.submit(p, deadline_ms) for p in payloads]

    def flush(self) -> None:
        """Force the pending set into batches immediately.  In continuous
        mode this only wakes the scheduler: forming batches would strand
        requests in the queue's ready deque, which the scheduler's slot
        refill never reads."""
        if self._sched is None:
            self.queue.flush()
        with self._wake:
            self._gen += 1
            self._wake.notify_all()

    def _on_done(self, fut) -> None:
        with self._lock:
            self._outstanding -= 1
            if fut.cancelled():
                # stop()-aborted, never served: tracked apart so it can't
                # be mistaken for a deadline miss (ServerStats.deadline_met)
                self._n_cancelled += 1
                self._m_cancelled.inc()

    # ------------------------------------------------------------ inline --
    def step(self, now: float | None = None) -> int:
        """Run one admission+dispatch cycle inline.  Batch-once mode:
        returns the number of requests served (0 when no batch was
        ready).  Continuous mode: runs one scheduler tick and returns its
        work units -- dispatches plus resolutions, so 0 still means
        'nothing to do' but a positive count may resolve no futures
        yet."""
        if self._sched is not None:
            return self._sched.tick(now)
        b = self.queue.poll(now)
        if b is None:
            return 0
        self.warmup.observe(b.padded_size)
        self._run_batch(b)
        return len(b)

    def serve_all(self, payloads, deadline_ms: float | None = None,
                  timeout: float | None = None) -> list[dict]:
        """Submit a request stream and wait for every result (in
        submission order).  Uses the worker threads when started, else
        serves inline."""
        futs = self.submit_many(payloads, deadline_ms)
        self.flush()
        if not self._threads:
            if self._sched is not None:
                # a tick can do work without resolving anything, so loop
                # on outstanding; an idle tick with work pending is a
                # fault to raise, not to spin on
                while self.outstanding:
                    if not self.step():
                        raise RuntimeError(
                            "continuous scheduler went idle with "
                            f"{self.outstanding} requests outstanding")
            else:
                while self.step():
                    pass
        return [f.result(timeout) for f in futs]

    # --------------------------------------------------------- execution --
    def _run_batch(self, b: Batch, pre=None) -> None:
        trace = self.obs.trace
        try:
            if pre is None:
                bseq = next(self._bseq)
                batch = self.backend.collate(b.payloads)
                # predict_ms / service_ms are *derived* from the span
                # handles (which stamp times even with obs off), and
                # trace.ctx tags the batch-scoped engine stage spans with
                # the join key latency_attribution uses
                with trace.ctx(batch=bseq):
                    with trace.span("predict", n=len(b)) as psp:
                        pred = self.backend.predict(batch)
                predict_ms = psp.dur_ms
            else:
                batch, pred, predict_ms, bseq, t_ready = pre
                # handoff wait between the admit thread's predict and
                # this exec-thread dispatch (threaded overlap's queue)
                trace.record("handoff", t_ready, trace.clock(),
                             batch=bseq, n=len(b))
            with trace.ctx(batch=bseq):
                with trace.span("execute", n=len(b)) as esp:
                    results, timings = self.backend.execute(batch, pred)
            t_done = esp.t1
            service_ms = esp.dur_ms
        except Exception as e:                 # noqa: BLE001
            for r in b.requests:
                if not r.future.done():
                    r.future.set_exception(e)
                trace.end(r.span, error=type(e).__name__)
            return
        queue_ms = [(b.t_formed - r.t_submit) * 1e3 for r in b.requests]
        # total spans submit -> results ready, so it also counts the
        # handoff wait between predict and execute in threaded mode --
        # the number deadline_met is judged against
        total_ms = [(t_done - r.t_submit) * 1e3 for r in b.requests]
        rec = _BatchRecord(
            n=len(b), predict_ms=predict_ms, service_ms=service_ms,
            queue_ms=queue_ms, total_ms=total_ms, timings=dict(timings),
            classes=[res.get("class") for res in results],
            widths=[res.get("width") for res in results])
        with self._lock:
            self._records.append(rec)
        enriched = []
        for req, res, qms, tms in zip(b.requests, results, queue_ms,
                                      total_ms):
            res = dict(res)
            res["queue_ms"] = qms
            res["predict_ms"] = predict_ms
            res["service_ms"] = service_ms
            res["total_ms"] = tms
            res["deadline_met"] = t_done <= req.deadline
            res["trace_id"] = int(req.seq)
            enriched.append(res)
            if not req.future.done():
                req.future.set_result(res)
            trace.end(req.span, batch=bseq,
                      deadline_met=bool(res["deadline_met"]))
        met = sum(1 for res in enriched if res["deadline_met"])
        with self._lock:
            self._n_deadline_met += met
            self._n_deadline_missed += len(enriched) - met
        self._m_batches.inc()
        self._m_met.inc(met)
        self._m_missed.inc(len(enriched) - met)
        if self.telemetry is not None:
            # tap *after* the futures resolve: the append never adds to
            # request latency, only to the exec thread's turnaround
            ver = getattr(self.backend, "predictor_version", 0)
            try:
                for req, res in zip(b.requests, enriched):
                    self.telemetry.record(req.payload, res,
                                          res.get("predictor_version",
                                                  ver),
                                          t_done)
            except Exception:          # noqa: BLE001 -- a faulty (duck-
                pass                   # typed) recorder must never kill
                #                        the exec thread

    def _note_results(self, requests, results, t_done, *,
                      service_ms: float) -> None:
        """Continuous-mode accounting: the scheduler resolves futures
        itself and reports each finalized group here -- records,
        deadline counters and the telemetry tap mirror ``_run_batch``."""
        rec = _BatchRecord(
            n=len(requests),
            predict_ms=float(np.mean([res["predict_ms"]
                                      for res in results])),
            service_ms=service_ms,
            queue_ms=[res["queue_ms"] for res in results],
            total_ms=[res["total_ms"] for res in results],
            timings={},
            classes=[res.get("class") for res in results],
            widths=[res.get("width") for res in results])
        met = sum(1 for res in results if res["deadline_met"])
        with self._lock:
            self._records.append(rec)
            self._n_deadline_met += met
            self._n_deadline_missed += len(results) - met
        self._m_batches.inc()
        self._m_met.inc(met)
        self._m_missed.inc(len(results) - met)
        if self.telemetry is not None:
            ver = getattr(self.backend, "predictor_version", 0)
            try:
                for req, res in zip(requests, results):
                    self.telemetry.record(req.payload, res,
                                          res.get("predictor_version",
                                                  ver),
                                          t_done)
            except Exception:          # noqa: BLE001 -- as in _run_batch:
                pass                   # a faulty recorder must never kill
                #                        the tick thread

    # ----------------------------------------------------------- threads --
    def _sched_loop(self) -> None:
        """Continuous-mode worker: tick until stopped, sleeping only when
        a tick reports no work (lost-wakeup guarded like _admit_loop).  A
        tick that raises fails the in-flight slots and keeps serving:
        one poisoned group must not wedge every later request."""
        while not self._stop.is_set():
            with self._wake:
                gen0 = self._gen
            try:
                n = self._sched.tick()
            except Exception as e:     # noqa: BLE001
                self._sched.abort(e)
                continue
            if n:
                continue
            with self._wake:
                if self._gen == gen0:
                    self._wake.wait(0.001)

    def _on_predict_stream(self):
        """Put the calling thread's device work on predict's stream,
        ordered after everything already queued on the device's current
        stream (index, parameters); a no-op off CUDA."""
        s = self._predict_stream
        if s is None:
            return contextlib.nullcontext()
        s.wait_stream(torch.cuda.current_stream(s.device))
        return torch.cuda.stream(s)

    def _admit_loop(self) -> None:
        with self._on_predict_stream():
            while not self._stop.is_set():
                with self._wake:
                    gen0 = self._gen
                b = self.queue.poll()
                if b is None:
                    delay = self.queue.next_event(time.perf_counter())
                    with self._wake:
                        # a submit/flush between poll() and here bumped
                        # _gen and its notify found no waiter -- re-poll
                        # instead of sleeping on stale state
                        if self._gen == gen0:
                            self._wake.wait(0.05 if delay is None
                                            else min(delay, 0.05) or 0.0005)
                    continue
                try:
                    batch = self.backend.collate(b.payloads)
                    # census after collate so the backend can size warmup
                    # queries for shapes the background thread warms
                    self.warmup.observe(b.padded_size)
                    bseq = next(self._bseq)
                    trace = self.obs.trace
                    with trace.ctx(batch=bseq):
                        with trace.span("predict", n=len(b)) as psp:
                            pred = self.backend.predict(batch)
                    # psp.t1 is when the batch became ready for handoff
                    item = (b, (batch, pred, psp.dur_ms, bseq, psp.t1))
                except Exception as e:             # noqa: BLE001
                    for r in b.requests:
                        if not r.future.done():
                            r.future.set_exception(e)
                        self.obs.trace.end(r.span, error=type(e).__name__)
                    continue
                placed = False
                while not self._stop.is_set():
                    try:
                        self._handoff.put(item, timeout=0.05)
                        placed = True
                        break
                    except queue_lib.Full:
                        continue
                if not placed:         # stopped mid-handoff: don't strand
                    for r in b.requests:   # waiters on an unresolved future
                        r.future.cancel()
                        self.obs.trace.end(r.span, cancelled=True)
        self._handoff.put((self._SENTINEL, None))

    def _exec_loop(self) -> None:
        while True:
            b, pre = self._handoff.get()
            if b is self._SENTINEL:
                return
            self._run_batch(b, pre)

    def _warmup_loop(self) -> None:
        while not self._stop.is_set():
            self.warmup.run(self.backend, block=True, timeout=0.1)

    def start(self) -> "RetrievalService":
        if self._threads:
            return self
        self._stop.clear()
        if self._sched is not None:
            # one tick thread owns all scheduler device state, on the
            # device's default stream; warmup still runs aside (the
            # scheduler's warmup never touches live state)
            self._threads = [
                threading.Thread(target=self._sched_loop, name="svc-sched",
                                 daemon=True),
                threading.Thread(target=self._warmup_loop,
                                 name="svc-warmup", daemon=True),
            ]
        else:
            self._threads = [
                threading.Thread(target=self._admit_loop, name="svc-admit",
                                 daemon=True),
                threading.Thread(target=self._exec_loop, name="svc-exec",
                                 daemon=True),
                threading.Thread(target=self._warmup_loop,
                                 name="svc-warmup", daemon=True),
            ]
        # the set-up heap leaves the collector's walks while the workers
        # run; the collection this takes is set-up, not a served one
        self._m_frozen.set(_hold_freeze())
        # collections and device intervals: recorded while the workers
        # run (a disabled recorder ignores this)
        self.obs.trace.watch()
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has resolved."""
        t_end = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                left = self._outstanding
            if left == 0:
                return True
            if not self._threads:
                if not self.step():
                    self.flush()
            if t_end is not None and time.perf_counter() > t_end:
                return False
            if self._threads:
                time.sleep(0.001)

    @property
    def outstanding(self) -> int:
        """Requests submitted but not yet resolved."""
        with self._lock:
            return self._outstanding

    def swap_predictor(self, node_params, thresholds=None, *,
                       version: int | None = None,
                       knob: str | None = None) -> int:
        """Hot-swap hook: delegate to the backend when it supports
        swapping (EngineBackend)."""
        fn = getattr(self.backend, "swap_predictor", None)
        if fn is None:
            raise TypeError(
                f"backend {type(self.backend).__name__} has no "
                "swap_predictor hook")
        return fn(node_params, thresholds, version=version, knob=knob)

    def stop(self, drain: bool = True) -> None:
        if drain:
            self.flush()
            self.drain()
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        for t in self._threads:
            # the warmup thread may be mid-run; wait it out (bounded by
            # one shape's warmup)
            t.join(timeout=60.0 if t.name == "svc-warmup" else 5.0)
        if self._threads:
            self.obs.trace.unwatch()
            _release_freeze()
        self._threads = []
        if not drain:                  # abort path: resolve, don't strand
            if self._sched is not None:
                # the tick thread has joined; cancel mid-flight slots
                self._sched.abort()
            self.queue.flush()
            while (b := self.queue.poll()) is not None:
                for r in b.requests:
                    r.future.cancel()
                    self.obs.trace.end(r.span, cancelled=True)
        # drain leftovers (the sentinel, plus -- if a join timed out mid-
        # warmup -- predicted batches whose waiters must not strand)
        while not self._handoff.empty():
            try:
                item, _ = self._handoff.get_nowait()
            except queue_lib.Empty:
                break
            if item is not self._SENTINEL:
                for r in item.requests:
                    r.future.cancel()
                    self.obs.trace.end(r.span, cancelled=True)
        # persist the padded-shape census for the next run's deploy-time
        # warmup (no-op unless the policy was given a census_path)
        self.warmup.save_census()

    def __enter__(self) -> "RetrievalService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # ------------------------------------------------------------- stats --
    def warmup_now(self, sizes) -> int:
        """Explicit synchronous warmup (deploy-time escape hatch)."""
        return self.warmup.prewarm(self.backend, sizes)

    def reset_stats(self) -> None:
        """Drop accumulated batch records (e.g. after a warmup pass, so
        reported percentiles reflect steady state only)."""
        with self._lock:
            self._records.clear()

    def stats(self) -> ServerStats:
        """Aggregate service-side accounting into a ServerStats.

        ``latencies_ms`` is *per request*, submit -> resolve (admission
        delay + predict + handoff + execute), so p50/p99 are true request
        latency percentiles."""
        with self._lock:
            recs = list(self._records)
            met, missed = self._n_deadline_met, self._n_deadline_missed
            cancelled = self._n_cancelled
        lat = [t for r in recs for t in r.total_ms]
        queue_ms = [q for r in recs for q in r.queue_ms]
        service_ms = [r.service_ms for r in recs]
        classes = np.array([c for r in recs for c in r.classes
                            if c is not None], np.int64)
        widths = np.array([w for r in recs for w in r.widths
                           if w is not None], np.float64)
        stage_ms = None
        rows = [r.timings for r in recs if r.timings]
        if rows:
            # report p99 and the sample count per stage as well as the
            # mean: one slow batch would vanish into an average
            keys = set().union(*rows)
            stage_ms = {}
            for k in sorted(keys):
                v = np.asarray([r[k] for r in rows if k in r], np.float64)
                stage_ms[k] = {"mean": float(v.mean()),
                               "p99": float(np.percentile(v, 99)),
                               "n": int(v.size)}
        return ServerStats(
            n_queries=int(sum(r.n for r in recs)),
            latencies_ms=lat,
            mean_param=float(widths.mean()) if widths.size else float("nan"),
            class_histogram=np.bincount(
                classes, minlength=self.backend.n_classes),
            pct_in_envelope=None,
            stage_ms=stage_ms,
            n_compiles=self.backend.n_compiles,
            queue_ms=queue_ms,
            service_ms=service_ms,
            n_deadline_met=met,
            n_deadline_missed=missed,
            n_cancelled=cancelled,
        )
