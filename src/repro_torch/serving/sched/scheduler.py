"""The continuous-batching tick loop.

One ``tick`` runs up to three stage-boundary steps, in the order that
keeps the slots busiest:

  1. **finalize** -- pop a group of retired slots (grain-sized, or
     partial when no slot is active or a retiree's deadline is close),
     run pool selection + stage 2 + rerank for just those rows, resolve
     their futures, free the slots;
  2. **refill**  -- pop the most urgent pending window from the
     admission queue, predict classes for the whole window, admit the
     grain-sized subset with the least class spread around the most
     urgent request (which always ships), hand the rest back;
  3. **chunk**   -- advance every active slot one posting chunk; slots
     whose budget (``min(predicted rho, stream length)``, or the full
     stream on the k knob) is spent retire at once and wait for the next
     finalize group.

All device work goes through ``engine.SchedPrograms``'s four fixed-shape
stages.  Host bookkeeping (``SlotTable``) is the only source of stream
positions; the device-to-host points are the admission-time stream
lengths and the finalize results.  On a card the tick thread issues its
work on the device's current stream, as the batch-once exec thread does.

Threading contract: ``tick`` (and therefore all device state) belongs to
one thread at a time; ``_lock`` guards the slot table and counters so
``stats``/``abort`` can run from the service's control thread.
``abort`` must only be called from the tick thread or after it has
quiesced.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from repro_torch.obs import NULL_OBS
from repro_torch.serving import bucketing
from repro_torch.serving.engine import SchedPrograms
from repro_torch.serving.sched.slots import SlotTable

__all__ = ["ContinuousScheduler"]


class ContinuousScheduler:
    """Slot-based in-flight scheduler over a ``RetrievalServer``.

    fixed_param: serve every request at this parameter without the
    cascade (the dynamic-vs-fixed race's baseline arm: the same
    machinery at a fixed budget).
    """

    def __init__(self, server, queue, *, slots: int = 32,
                 grain: int | None = None, chunk_p: int | None = None,
                 query_len: int | None = None, window: int | None = None,
                 co_group: bool = True, fixed_param: int | None = None,
                 on_results=None, clock=time.perf_counter):
        engine = server.engine
        self.server = server
        self.queue = queue
        self.grain = int(grain) if grain else engine.batch_multiple
        self.slots = int(slots)
        if self.grain > self.slots:
            raise ValueError(
                f"grain={self.grain} exceeds slots={self.slots}: a full "
                "retire group must fit the table or finalize can starve")
        # for_engine picks the sharded programs on a mesh engine; the fixed
        # arm's budget joins their static budget grid, so its local retire
        # bounds come with the gather like any cutoff's
        self.prog = SchedPrograms.for_engine(
            engine, grain=self.grain, chunk_p=chunk_p,
            extra_widths=(() if fixed_param is None
                          else (int(fixed_param),)))
        self.window = int(window) if window else 2 * self.grain
        self.co_group = bool(co_group)
        self.fixed_param = (None if fixed_param is None
                            else int(fixed_param))
        self.on_results = on_results
        self.clock = clock
        self.knob = server.cfg.knob
        # the depth knob retires each slot at its predicted reranking
        # depth; the fixed arm and depth-off configs use the static pool
        # width (a no-op mask)
        self.full_depth = int(server.cfg.depth_pool_width)
        self.use_depth = fixed_param is None and server.has_depth_knob
        self.query_len = query_len
        self._est = queue.cfg.service_estimate_ms / 1e3
        self._state = None             # SchedState; tick-thread only
        self._lock = threading.Lock()
        self.table = SlotTable(self.slots)
        self._retired = []             # retire-ordered, awaiting finalize
        self.retire_reasons = collections.Counter()
        self.n_admitted = 0
        self.n_retired = 0
        self.n_refill_calls = 0
        self.n_chunk_calls = 0
        self.n_finalize_calls = 0
        # stage-2 work under the depth knob: candidate-pool rows admitted
        # into the rerank vs the depth-free pool rows (host arithmetic
        # over admission-time predictions, deterministic)
        self.n_rows_scored = 0
        self.n_rows_full = 0
        # tick-thread only (like _state): the tick id stamped on spans
        self._tick_id = 0
        self.bind_obs(NULL_OBS)

    def bind_obs(self, obs) -> None:
        """Attach an observability handle and pre-bind the hot-path
        metric objects."""
        self.obs = obs
        self._m_ticks = obs.metrics.counter("sched.ticks")
        self._m_retired = {
            r: obs.metrics.counter("sched.retired." + r)
            for r in ("rho_exhausted", "stream_exhausted",
                      "pool_complete")}

    # -------------------------------------------------------------- tick --
    def tick(self, now: float | None = None) -> int:
        """One scheduling step: finalize, refill, chunk.  Returns the
        number of work units (dispatches + resolutions) performed; 0
        means the scheduler is idle and the queue is empty."""
        t = self.clock() if now is None else now
        ev = self._finalize_step(t)
        ev += self._refill_step(t)
        ev += self._chunk_step(t)
        if ev:
            # working ticks only: idle polls would flood the span ring
            self.obs.trace.record("tick", t, self.clock(),
                                  tick=self._tick_id, ev=ev)
            self._m_ticks.inc()
            self._tick_id += 1
        return ev

    @property
    def idle(self) -> bool:
        with self._lock:
            return self.table.n_occupied == 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_admitted": self.n_admitted,
                "n_retired": self.n_retired,
                "n_refill_calls": self.n_refill_calls,
                "n_chunk_calls": self.n_chunk_calls,
                "n_finalize_calls": self.n_finalize_calls,
                "n_rows_scored": self.n_rows_scored,
                "n_rows_full": self.n_rows_full,
                "retire_reasons": dict(self.retire_reasons),
                "chunks_max": self.prog.n_chunks,
                "slots": self.slots,
                "grain": self.grain,
                "chunk_p": self.prog.chunk_p,
                "sharded": self.prog.sharded,
            }

    # ---------------------------------------------------------- finalize --
    def _finalize_step(self, t: float) -> int:
        with self._lock:
            g = self._pop_group(t)
        if not g:
            return 0
        t0 = self.clock()
        pad = len(g)
        idx = np.full(self.grain, g[0].idx, np.int32)
        pvec = np.ones(self.grain, np.int32)
        dvec = np.ones(self.grain, np.int32)
        qids = np.full(self.grain, g[0].qid, np.int32)
        idx[:pad] = [s.idx for s in g]
        pvec[:pad] = [s.width for s in g]
        dvec[:pad] = [s.depth for s in g]
        qids[:pad] = [s.qid for s in g]
        ranked = self.prog.finalize(self._state, idx, pvec, dvec, qids)
        t_done = self.clock()
        reqs, results = [], []
        for i, s in enumerate(g):
            r = s.req
            results.append({
                "ranked": ranked[i],
                "class": (None if self.fixed_param is not None
                          else int(s.pred_class)),
                "width": float(s.width),
                "depth": float(s.depth),
                "depth_class": (int(s.depth_class) if self.use_depth
                                else None),
                "predictor_version": s.version,
                "queue_ms": (s.t_admit - r.t_submit) * 1e3,
                "predict_ms": s.predict_ms,
                "service_ms": (t_done - s.t_admit) * 1e3,
                "total_ms": (t_done - r.t_submit) * 1e3,
                "deadline_met": t_done <= r.deadline,
                "retire_reason": s.retire_reason,
                "chunks_executed": s.chunks,
                "chunks_max": self.prog.n_chunks,
                "slot_occupancy": s.occupancy,
                "trace_id": int(r.seq),
            })
            reqs.append(r)
        trace = self.obs.trace
        for s in g:
            # slot occupancy window, admission to retirement
            trace.record("slot", s.t_admit, s.t_retire, qid=s.qid,
                         slot=s.idx, width=int(s.width),
                         depth=int(s.depth), chunks=int(s.chunks),
                         retire_reason=s.retire_reason,
                         occupancy=round(float(s.occupancy), 4))
        for r, res in zip(reqs, results):
            if not r.future.done():
                r.future.set_result(res)
            trace.end(r.span, retire_reason=res["retire_reason"],
                      deadline_met=bool(res["deadline_met"]))
        if self.on_results is not None:
            self.on_results(reqs, results, t_done,
                            service_ms=(t_done - t0) * 1e3)
        trace.record("tick.finalize", t0, self.clock(),
                     tick=self._tick_id, n=len(g))
        with self._lock:
            for s in g:
                # pool rows the rerank scored for this slot vs the
                # depth-free pool (k: the predicted pool width, clamped
                # to the static pool; rho: the static depth)
                full = (min(s.width, self.full_depth)
                        if self.knob == "k" else self.full_depth)
                self.n_rows_scored += min(s.depth, full)
                self.n_rows_full += full
                self.table.release(s)
            self.n_finalize_calls += 1
        return len(g)

    def _pop_group(self, t: float):
        # caller holds the lock.  Fire on: a full grain of retirees; no
        # active slot left to overlap with (drain / trickle traffic); or
        # a retiree's deadline within the service estimate.
        if not self._retired:
            return None
        full = len(self._retired) >= self.grain
        starved = not self.table.active()
        urgent = (min(s.req.deadline for s in self._retired) - t
                  <= self._est)
        if not (full or starved or urgent):
            return None
        g = self._retired[: self.grain]
        del self._retired[: len(g)]
        return g

    # ------------------------------------------------------------ refill --
    def _refill_step(self, t: float) -> int:
        ev = 0
        while True:
            with self._lock:
                free = self.table.n_free
            if free == 0:
                break
            cand = self.queue.take_urgent(self.window)
            cand = [r for r in cand if self._fits(r)]
            if not cand:
                break
            n = min(free, self.grain, len(cand))
            t0 = self.clock()
            classes, ver = self._predict(cand)
            t1 = self.clock()
            predict_ms = (t1 - t0) * 1e3
            self.obs.trace.record("predict", t0, t1,
                                  tick=self._tick_id, n=len(cand))
            keep, back = self._select(cand, classes, n)
            if back.size:
                self.queue.requeue([cand[i] for i in back])
            self._admit([cand[i] for i in keep], classes[keep], ver,
                        predict_ms, t)
            self.obs.trace.record("tick.refill", t0, self.clock(),
                                  tick=self._tick_id, n=len(keep))
            ev += 1
            if len(keep) < self.grain:
                break                  # queue drained below a full grain
        return ev

    def _fits(self, req) -> bool:
        # adopt the first request's width as the slot row width; longer
        # queries cannot ride this table and fail fast instead of hanging
        p = np.asarray(req.payload, np.int32).ravel()
        if self.query_len is None:
            self.query_len = max(int(p.shape[0]), 1)
        if p.shape[0] <= self.query_len:
            return True
        if not req.future.done():
            req.future.set_exception(ValueError(
                f"query length {p.shape[0]} exceeds the scheduler's slot "
                f"width {self.query_len} (set query_len at construction)"))
        return False

    def _rows(self, reqs, n: int) -> np.ndarray:
        qt = np.full((n, self.query_len), -1, np.int32)
        for i, r in enumerate(reqs):
            p = np.asarray(r.payload, np.int32).ravel()
            qt[i, : p.shape[0]] = p
        return qt

    def _predict(self, cand):
        if self.fixed_param is not None:
            # the fixed arm runs no cascade: every query at one budget
            return (np.zeros(len(cand), np.int64),
                    self.server.predictor_version)
        return self.server.predict_versioned(self._rows(cand, len(cand)))

    def _select(self, cand, classes, n: int):
        """Refill-group choice: the most urgent request (cand[0]) always
        ships; the remaining seats go to the candidates whose predicted
        class is nearest its class (stable by urgency), so a group's
        padded maxima track its members instead of the global worst
        case."""
        if len(cand) <= n:
            return np.arange(len(cand)), np.array([], np.int64)
        order = np.arange(1, len(cand))
        if self.co_group and self.fixed_param is None:
            spread = np.abs(classes[1:] - classes[0])
            order = order[np.argsort(spread, kind="stable")]
        keep = np.concatenate(([0], order[: n - 1]))
        back = np.setdiff1d(np.arange(len(cand)), keep)
        return np.sort(keep), back

    def _admit(self, group, classes, ver, predict_ms: float,
               t: float) -> None:
        if not group:
            return
        if self._state is None:
            self._state = self.prog.init_state(self.slots, self.query_len)
        qt = self._rows(group, self.grain)
        rows, slen, lend = self.prog.gather(qt)
        with self._lock:
            taken = [self.table.acquire() for _ in group]
            self.n_refill_calls += 1
        idx = np.full(self.grain, self.slots, np.int32)  # pad rows drop
        idx[: len(group)] = [s.idx for s in taken]
        self._state = self.prog.refill(self._state, idx, rows)
        if self.fixed_param is not None:
            widths = np.full(len(group), self.fixed_param, np.int64)
            if self.knob == "rho":
                widths = np.minimum(widths, self.server.cfg.stream_cap)
        else:
            widths = np.asarray(self.server.params_of(classes))
        if self.use_depth:
            dclasses, depths = self.server.predict_depths(qt[: len(group)])
        else:
            dclasses, depths = None, None
        with self._lock:
            occ = self.table.n_occupied / self.slots
            for i, (s, r) in enumerate(zip(taken, group)):
                s.req = r
                s.qid = int(r.seq)
                s.pred_class = int(classes[i])
                s.width = int(widths[i])
                s.depth = (int(depths[i]) if depths is not None
                           else self.full_depth)
                s.depth_class = (int(dclasses[i])
                                 if dclasses is not None else -1)
                s.version = int(ver)
                s.predict_ms = predict_ms
                s.t_admit = t
                s.pos = 0
                s.chunks = 0
                sl = int(slen[i])
                s.end = min(s.width, sl) if self.knob == "rho" else sl
                if self.prog.sharded:
                    # the worst shard's local stream end for this slot's
                    # budget, from the gather's metadata; the local cursor
                    # retires against it (lend is 0 exactly when end is:
                    # some shard owns global position 0 of any stream)
                    col = self.prog.lend_col(
                        s.width if self.knob == "rho"
                        else self.server.cfg.stream_cap)
                    s.lpos = 0
                    s.lend = int(lend[i, col])
                    done = s.lpos >= s.lend
                else:
                    done = s.pos >= s.end
                self.n_admitted += 1
                # the request's wait in the pending set (take_urgent
                # bypasses batch formation, so the queue span lands here)
                self.obs.trace.record("queue", r.t_submit, t, qid=s.qid,
                                      slot=s.idx)
                if done:               # empty stream: retire immediately
                    self._retire(s, t, occ)

    # ------------------------------------------------------------- chunk --
    def _chunk_step(self, t: float) -> int:
        t0 = self.clock()
        with self._lock:
            act = self.table.active()
            if not act:
                return 0
            pos = np.zeros(self.slots, np.int32)
            end = np.zeros(self.slots, np.int32)
            sharded = self.prog.sharded
            for s in act:
                # sharded programs window the local partitioned stream;
                # the device mask still applies the global rho budget
                pos[s.idx] = s.lpos if sharded else s.pos
                end[s.idx] = s.end
            self.n_chunk_calls += 1
        self._state = self.prog.chunk(self._state, pos, end)
        with self._lock:
            occ = self.table.n_occupied / self.slots
            cp = self.prog.chunk_p
            for s in act:
                s.chunks += 1
                if sharded:
                    s.lpos = min(s.lpos + cp, s.lend)
                    done = s.lpos >= s.lend
                else:
                    s.pos = min(s.pos + cp, s.end)
                    done = s.pos >= s.end
                if done:
                    self._retire(s, t, occ)
        # host-only recording: the chunk dispatch window (the sched.chunk
        # span inside prog.chunk covers the dispatch itself)
        self.obs.trace.record("tick.chunk", t0, self.clock(),
                              tick=self._tick_id, n=len(act))
        return 1

    def _retire(self, s, t: float, occupancy: float) -> None:
        # caller holds the lock
        if self.knob == "rho":
            reason = ("rho_exhausted" if s.width <= s.end
                      else "stream_exhausted")
        else:
            reason = "pool_complete"
        s.retire_reason = reason
        s.t_retire = t
        s.occupancy = occupancy
        self._retired.append(s)
        self.retire_reasons[reason] += 1
        self.n_retired += 1
        self._m_retired[reason].inc()

    # ----------------------------------------------------------- control --
    def abort(self, exc: BaseException | None = None) -> None:
        """Fail (or cancel) every in-flight request and reset the table.
        Only call from the tick thread, or after it has quiesced."""
        with self._lock:
            live = self.table.occupied()
            self._retired.clear()
            for s in live:
                r = s.req
                if r is not None and not r.future.done():
                    if exc is not None:
                        r.future.set_exception(exc)
                    else:
                        r.future.cancel()
                if r is not None:
                    self.obs.trace.end(r.span, aborted=True)
                self.table.release(s)

    def warmup(self, query_len: int | None = None) -> int | None:
        """Build the four scheduler programs, and run the cascade at
        every padded candidate-window width.  Returns the programs built
        (the JAX scheduler's compile count), or None while the query
        width is still unknown."""
        ql = query_len or self.query_len
        if not ql:
            return None
        self.query_len = ql
        engine = self.server.engine
        n = self.prog.warmup(self.slots, ql)
        if self.fixed_param is None and self.server.cascade is not None:
            m = engine.batch_multiple
            top = bucketing.pad_length(self.window, m)
            for w in range(m, top + 1, m):
                self.server.predict_classes(np.full((w, ql), -1, np.int32))
        if self.use_depth and self.server.depth_cascade is not None:
            # the depth cascade runs on admitted groups (<= grain rows,
            # padded to the batch grid)
            w = bucketing.pad_length(self.grain, engine.batch_multiple)
            self.server.predict_classes(np.full((w, ql), -1, np.int32),
                                        knob="depth")
        return n
