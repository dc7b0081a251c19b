"""Batch-once serving engine (unsharded).

One pass of four stages per (padded) batch, whatever mix of classes the
cascade predicted:

  gather   -- posting streams + stage-2 score streams, once per batch
  stage1   -- accumulate with a per-query rho vector (one kernel launch
              for every rho bucket) and select the candidate pool at a
              static width, masked per query by the k vector
  stage2   -- dense per-scorer accumulators + second-stage scores
  rerank   -- the final list from each query's pool

The predicted parameter enters every stage as a tensor, never as a
shape.  Kernel routing mirrors the JAX engine's kernel path: the
accumulation goes through ``impact_scan`` (per-query rho plus the gather
stage's per-block doc-id bounds) and the pool selection through
``topk`` for widths up to ``KP_MAX``.  The tensors' device picks the
route: the hand-written kernels on a CUDA device, their plain versions
on the CPU.  Everything else is plain torch, where the JAX engine runs
jnp.

PyTorch runs eagerly and this engine keeps no program cache, so
``n_compiles`` and the ``engine.compiles`` counter stay 0; capturing a
CUDA graph per padded shape is later work.  Each stage runs inside an
``engine.<name>`` span (``bind_obs``; the JAX engine's names) and counts
one dispatch; its timing is the span's, fenced inside the span on the
calling thread's current CUDA stream, so a stage of one service thread
does not wait for another thread's work.  The ranked lists leave the
device once, through ``.cpu().numpy()``.
Stage-2 noise qids are the query's batch position, as in the JAX engine.

``SchedPrograms`` is the continuous scheduler's execution surface over
the same engine (``serving/sched``): four stage functions -- gather,
refill, chunk, finalize -- whose shapes are fixed by the slot table, so
any admit/retire churn runs the same kernels at the same shapes.  The
chunk runs ``impact_scan`` on a (slots, chunk_p) window of the table;
the finalize runs ``topk`` on a group of ``grain`` finished rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.device import fence, resolve_device
from repro_torch.retrieval import gold, jass
from repro_torch.retrieval import topk as topk_lib
from repro_torch.retrieval.index import block_doc_bounds
from repro_torch.serving import bucketing

__all__ = ["SchedPrograms", "SchedState", "ServingEngine"]


def _pad_ranked(ranked: np.ndarray, depth: int) -> np.ndarray:
    """Pad a ranked matrix out to ``depth`` columns with the explicit -1
    no-document sentinel, so every serve path returns (n, rerank_depth)."""
    if ranked.shape[1] >= depth:
        return ranked
    pad = depth - ranked.shape[1]
    return np.pad(ranked, ((0, 0), (0, pad)), constant_values=-1)


# --------------------------------------------------------------- stages --

def _stage_gather(offsets, pdoc, pimp, pscore, qt, *, cap: int,
                  block_p: int, n_docs: int):
    ds, im = jass.gather_streams(offsets, pdoc, pimp, qt, cap=cap)
    # per-posting-block min/max doc id for the impact_scan skips
    seg_lo, seg_hi = block_doc_bounds(ds, block_p=block_p, n_docs=n_docs)
    sdocs, s3 = jass.gather_score_streams(offsets, pdoc, pscore, qt, cap=cap)
    return ds, im, seg_lo, seg_hi, sdocs, s3


def _stage1_rho(ds, im, seg_lo, seg_hi, rho_vec, *, n_docs: int, depth: int,
                block_p: int, block_d: int):
    acc = jass.saat_scores_masked(ds, im, rho_vec, n_docs, use_kernel=True,
                                  seg_bounds=(seg_lo, seg_hi),
                                  block_p=block_p, block_d=block_d)
    return topk_lib.select_pool(acc, depth, use_kernel=True)


def _stage1_k(ds, im, seg_lo, seg_hi, k_vec, *, n_docs: int, max_k: int,
              block_p: int, block_d: int):
    # exhaustive stage-1 scores (rho = P), one shared max-k selection; the
    # per-query pool width masks the shared pool
    full = torch.full(ds.shape[:1], ds.shape[-1], dtype=torch.int32,
                      device=ds.device)
    acc = jass.saat_scores_masked(ds, im, full, n_docs, use_kernel=True,
                                  seg_bounds=(seg_lo, seg_hi),
                                  block_p=block_p, block_d=block_d)
    pool = topk_lib.select_pool(acc, max_k, use_kernel=True)
    return _depth_mask(pool, k_vec)


def _stage2(sdocs, s3, doc_len, qids, *, n_docs: int, n_terms: int):
    a_bm25, a_lm, a_tfidf = jass.scorer_accumulators(sdocs, s3, n_docs,
                                                     n_terms=n_terms)
    return gold.second_stage_scores(a_bm25, a_lm, a_tfidf, doc_len, qids)


def _stage_rerank(stage2, pool, *, depth: int):
    return gold.rerank_pool(stage2, pool, depth)


def _depth_mask(pool, width_vec):
    """Keep each query's first ``width_vec[q]`` pool entries.  The pool is
    rank-ordered, so a prefix mask is both the k knob's pool width and
    the depth knob's scored depth; at the static width it is a no-op."""
    pos = torch.arange(pool.shape[-1], device=pool.device)
    keep = pos[None, :] < width_vec[:, None]
    return torch.where(keep, pool, torch.full_like(pool, -1))


def _stage_rerank_dyn(stage2, pool, depth_vec, *, depth: int):
    """``_stage_rerank`` with a per-query reranking depth (third knob)."""
    return gold.rerank_pool(stage2, _depth_mask(pool, depth_vec), depth)


# ----------------------------------------------------- scheduler stages --
# The continuous scheduler's four stage functions.  Static geometry
# (chunk and bounds block sizes, doc counts) comes in by keyword; every
# per-slot quantity -- stream positions, remaining rho, slot indices,
# qids -- is a tensor, so the slot table churns through any admit/retire
# pattern at the same shapes.

def _sched_gather(offsets, pdoc, pimp, pscore, qt, *, cap: int,
                  bounds_p: int, n_docs: int):
    """Per-request slot rows: posting/score streams, segment bounds at the
    chunk granularity, and the true stream length (the scheduler's
    ragged-tail retirement bound)."""
    ds, im, seg_lo, seg_hi, sdocs, s3 = _stage_gather(
        offsets, pdoc, pimp, pscore, qt, cap=cap, block_p=bounds_p,
        n_docs=n_docs)
    slen = (ds >= 0).sum(dim=-1).to(torch.int32)
    return ds, im, seg_lo, seg_hi, sdocs, s3, slen


def _sched_refill(ds_b, im_b, lo_b, hi_b, sd_b, s3_b, acc, slot_idx,
                  ds, im, lo, hi, sd, s3):
    """Install a refill group's gathered rows into its slots and zero
    their accumulator rows, out of place: the old state stays whole if
    any copy raises.  ``slot_idx`` holds only real slots (the caller
    drops the group's padding on the host)."""
    return (ds_b.index_copy(0, slot_idx, ds),
            im_b.index_copy(0, slot_idx, im),
            lo_b.index_copy(0, slot_idx, lo),
            hi_b.index_copy(0, slot_idx, hi),
            sd_b.index_copy(0, slot_idx, sd),
            s3_b.index_copy(0, slot_idx, s3),
            acc.index_fill(0, slot_idx, 0.0))


def _sched_chunk(ds_b, im_b, lo_b, hi_b, acc, pos, end, *, chunk_p: int,
                 bounds_p: int, n_docs: int, block_d: int):
    """One resumable stage-1 step over the whole slot table: accumulate
    each slot's next ``chunk_p`` postings, masked to its remaining budget
    ``end - pos`` (idle slots carry rho 0 and add exact zeros).

    The chunked partial sums equal the batch-once accumulator bit for
    bit: impacts are integer-valued float32 and the sums stay below
    2^24, so every add is exact and the split into chunks cannot change
    the total.
    """
    p = ds_b.shape[-1]
    pos = pos.long()
    ar = torch.arange(chunk_p, dtype=torch.int64, device=ds_b.device)
    idx = (pos[:, None] + ar[None, :]).clamp(max=p - 1)   # idle slots:
    ds = ds_b.gather(1, idx)                              # rho-masked
    im = im_b.gather(1, idx)
    rho_rem = (end.long() - pos).clamp(0, chunk_p).to(torch.int32)
    nb = chunk_p // bounds_p
    bidx = (pos[:, None] // bounds_p
            + torch.arange(nb, dtype=torch.int64, device=ds_b.device)[None])
    bidx = bidx.clamp(max=lo_b.shape[-1] - 1)
    seg = (lo_b.gather(1, bidx), hi_b.gather(1, bidx))
    inc = jass.saat_scores_masked(ds, im, rho_rem, n_docs, use_kernel=True,
                                  seg_bounds=seg, block_p=bounds_p,
                                  block_d=block_d)
    return acc + inc


def _sched_finalize_rho(acc, sd_b, s3_b, slot_idx, dvec, qids, doc_len, *,
                        depth: int, n_docs: int, n_terms: int):
    """Stages 1b-3 for a retiring group: pool selection over the finished
    accumulator rows, then stage 2 and the rerank as the batch path
    (qids are the requests' arrival index).  ``dvec`` is the per-slot
    reranking depth; without a depth knob it is the static pool width,
    a no-op mask."""
    pool = topk_lib.select_pool(acc.index_select(0, slot_idx), depth,
                                use_kernel=True)
    stage2 = _stage2(sd_b.index_select(0, slot_idx),
                     s3_b.index_select(0, slot_idx), doc_len, qids,
                     n_docs=n_docs, n_terms=n_terms)
    return gold.rerank_pool(stage2, _depth_mask(pool, dvec), depth)


def _sched_finalize_k(acc, sd_b, s3_b, slot_idx, k_vec, dvec, qids, doc_len,
                      *, depth: int, max_k: int, n_docs: int, n_terms: int):
    pool = topk_lib.select_pool(acc.index_select(0, slot_idx), max_k,
                                use_kernel=True)
    pool = _depth_mask(pool, k_vec)
    stage2 = _stage2(sd_b.index_select(0, slot_idx),
                     s3_b.index_select(0, slot_idx), doc_len, qids,
                     n_docs=n_docs, n_terms=n_terms)
    return gold.rerank_pool(stage2, _depth_mask(pool, dvec), depth)


class ServingEngine:
    """The staged batch-once pipeline on one device.

    ``serve(query_terms, param_vec)`` runs the four stages over the whole
    (padded) batch and returns (ranked, per-stage timings in ms).
    """

    def __init__(self, index, cfg, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_p = cfg.kernel_block_p
        self.block_d = cfg.kernel_block_d
        index = index.to(self.device)
        self.offsets = index.offsets
        self.pdoc = index.postings_doc
        self.pimp = index.postings_impact.to(torch.float32)
        self.pscore = index.postings_score
        self.doc_len = index.doc_len
        self.n_docs = index.n_docs
        self.max_k = int(max(cfg.cutoffs))
        self.batch_multiple = cfg.pad_multiple
        # eager torch: no program cache, nothing is ever compiled
        self.n_compiles = 0
        # observability: spans around stage boundaries + deterministic
        # dispatch/compile counters (NULL until bind_obs)
        self.trace = obs_lib.NULL_TRACE
        self._m_dispatch = obs_lib.NULL_METRIC
        self._m_compile = obs_lib.NULL_METRIC

    def bind_obs(self, obs) -> None:
        """Attach an observability handle: per-stage spans in ``serve``,
        plus the dispatch and compile counters."""
        self.trace = obs.trace
        self._m_dispatch = obs.metrics.counter("engine.dispatches")
        self._m_compile = obs.metrics.counter("engine.compiles")

    def padded_batch(self, n: int) -> int:
        return bucketing.pad_length(n, self.batch_multiple)

    def _to_device(self, rows: np.ndarray, fill: int) -> torch.Tensor:
        padded = bucketing.pad_rows(rows, self.batch_multiple, fill=fill)
        return torch.from_numpy(padded.astype(np.int32)).to(self.device)

    def _timed(self, timings: dict, label: str, name: str, fn, *args,
               **kwargs):
        """Run one stage in its ``engine.<name>`` span, the device fence
        inside it; ``timings[label]`` is the span's ms."""
        fence(self.device)
        self._m_dispatch.inc()
        with self.trace.span("engine." + name) as sp:
            out = fn(*args, **kwargs)
            fence(self.device)
        timings[label] = sp.dur_ms
        return out

    def _stage1(self, ds, im, seg_lo, seg_hi, pv, pool_width: int):
        kern = dict(block_p=self.block_p, block_d=self.block_d)
        if self.cfg.knob == "rho":
            return _stage1_rho(ds, im, seg_lo, seg_hi, pv, n_docs=self.n_docs,
                               depth=self.cfg.rerank_depth, **kern)
        return _stage1_k(ds, im, seg_lo, seg_hi, pv, n_docs=self.n_docs,
                         max_k=pool_width, **kern)

    # --------------------------------------------------------- serving --
    def serve(self, query_terms: np.ndarray, param_vec: np.ndarray,
              pool_width: int | None = None,
              depth_vec: np.ndarray | None = None):
        """Batch-once pipeline.  param_vec: (n,) predicted k or rho.

        ``pool_width`` (k knob only) overrides the shared pool's static
        width, for ``serve_fixed`` params beyond the cutoff grid.
        ``depth_vec`` is a per-query reranking depth (a prefix mask over
        the rank-ordered pool before the rerank); None skips the mask.

        Returns (ranked (n, rerank_depth) np.ndarray, timings dict in ms).
        """
        n = query_terms.shape[0]
        qt = self._to_device(query_terms, fill=-1)
        pv = self._to_device(param_vec, fill=1)
        dv = None if depth_vec is None else self._to_device(depth_vec, fill=1)
        qids = torch.arange(qt.shape[0], dtype=torch.int32,
                            device=self.device)
        timings = {}
        width = int(pool_width or self.max_k)
        s1_name = "stage1" if self.cfg.knob == "rho" else f"stage1:{width}"
        ds, im, seg_lo, seg_hi, sdocs, s3 = self._timed(
            timings, "gather_ms", "gather", _stage_gather, self.offsets,
            self.pdoc, self.pimp, self.pscore, qt, cap=self.cfg.stream_cap,
            block_p=self.block_p, n_docs=self.n_docs)
        pool = self._timed(timings, "stage1_ms", s1_name, self._stage1, ds,
                           im, seg_lo, seg_hi, pv, width)
        stage2 = self._timed(timings, "stage2_ms", "stage2", _stage2, sdocs,
                             s3, self.doc_len, qids, n_docs=self.n_docs,
                             n_terms=qt.shape[1])
        if dv is None:
            ranked = self._timed(timings, "rerank_ms", "rerank",
                                 _stage_rerank, stage2, pool,
                                 depth=self.cfg.rerank_depth)
        else:
            ranked = self._timed(timings, "rerank_ms", "rerank_dyn",
                                 _stage_rerank_dyn, stage2, pool, dv,
                                 depth=self.cfg.rerank_depth)
        ranked = ranked[:n].cpu().numpy()
        return _pad_ranked(ranked, self.cfg.rerank_depth), timings

    def warmup_shape(self, batch_size: int, query_len: int, *,
                     with_depth: bool = False) -> int:
        """Run the pipeline once at one padded batch size (first-call
        allocations, kernel builds).  Returns the programs compiled: 0,
        since nothing is compiled per shape."""
        b = self.padded_batch(int(batch_size))
        qt = np.full((b, query_len), -1, np.int32)
        pv = np.ones(b, np.int32)
        self.serve(qt, pv)
        if with_depth:
            self.serve(qt, pv, depth_vec=np.ones(b, np.int32))
        return 0

    def warmup(self, batch_sizes, query_len: int, *,
               with_depth: bool = False) -> int:
        """``warmup_shape`` for each padded batch size; returns 0."""
        for b in sorted({self.padded_batch(int(b)) for b in batch_sizes}):
            self.warmup_shape(b, query_len, with_depth=with_depth)
        return 0

    # ----------------------------------------------- continuous serving --
    @property
    def supports_continuous(self) -> bool:
        """Whether ``SchedPrograms``/``ContinuousBackend`` can drive this
        engine (a capability check, as in the JAX package)."""
        return True

    @property
    def continuous_unsupported_reason(self) -> str | None:
        return None


# ------------------------------------------------- scheduler programs --

def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``.  On a card it goes through
    pinned memory without waiting on the stream (a blocking copy from
    pageable memory would sync the stream, and with it every chunk
    step); the pinned block is not reused before the copy ends."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass(frozen=True)
class SchedState:
    """The slot table's device residency: per-slot posting/score streams,
    segment bounds, and the resumable stage-1 accumulator.  Treated as
    an immutable value: every stage returns new tensors, so a failed
    dispatch never leaves half-updated rows behind."""

    ds: torch.Tensor      # (S, P) int32 posting doc ids, -1 padded
    im: torch.Tensor      # (S, P) float32 impacts, -1 padded
    seg_lo: torch.Tensor  # (S, n_blocks) int32 per-block min doc id
    seg_hi: torch.Tensor  # (S, n_blocks) int32 per-block max doc id
    sdocs: torch.Tensor   # (S, L*P) int32 stage-2 score-stream doc ids
    s3: torch.Tensor      # (S, L*P, 3) float32 stage-2 scorer features
    acc: torch.Tensor     # (S, n_docs) float32 resumable stage-1 scores


def _default_chunk_p(p: int) -> int:
    """Largest divisor of the stream cap that is <= cap/8: enough chunk
    positions for early retirement to matter, without a degenerate grid."""
    c = max(p // 8, 1)
    while p % c:
        c -= 1
    return c


class SchedPrograms:
    """The continuous scheduler's execution surface over ``ServingEngine``.

    Four stages -- ``sgather``, ``refill``, ``chunk``, ``finalize`` --
    cover the whole slot lifecycle at shapes fixed at construction
    (group width = the scheduler's refill grain, chunk span = the whole
    slot table).  Per-slot stream positions and remaining budgets go in
    as tensors; the host keeps the only authoritative copy, so no stage
    reads device state back mid-flight.  The device-to-host points are
    the admission-time stream lengths and the finalize result.  Each
    stage counts one engine dispatch and runs in a ``sched.<name>`` span
    that covers the dispatch only (no fence).
    """

    @classmethod
    def for_engine(cls, engine: ServingEngine, *, grain: int,
                   chunk_p: int | None = None) -> "SchedPrograms":
        """The program set matching the engine's layout (the port has
        the unsharded engine only)."""
        return cls(engine, grain=grain, chunk_p=chunk_p)

    def __init__(self, engine: ServingEngine, *, grain: int,
                 chunk_p: int | None = None):
        self.engine = engine
        p = engine.cfg.stream_cap
        self.grain = int(grain)
        self.slot_cap = p
        self.chunk_p = int(chunk_p) if chunk_p else _default_chunk_p(p)
        if p % self.chunk_p:
            raise ValueError(
                f"chunk_p={self.chunk_p} must divide the per-slot stream "
                f"width {p} so chunk windows tile the posting streams "
                "exactly")
        # segment bounds at the coarsest granularity that still tiles the
        # chunk window, so a chunk's bounds are a contiguous gather
        self.bounds_p = (engine.block_p
                         if self.chunk_p % engine.block_p == 0
                         else self.chunk_p)
        self.n_chunks = p // self.chunk_p

    def _run(self, name: str, fn, *args, **kwargs):
        self.engine._m_dispatch.inc()
        with self.engine.trace.span("sched." + name):
            return fn(*args, **kwargs)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return _h2d(a, self.engine.device)

    def init_state(self, slots: int, query_len: int) -> SchedState:
        """Fresh (empty) slot table.  Segment bounds start at the empty
        interval (n_docs, -1), so unoccupied slots never run."""
        e = self.engine
        p = e.cfg.stream_cap
        nb = p // self.bounds_p
        lp = query_len * p
        dev = e.device
        return SchedState(
            ds=torch.full((slots, p), -1, dtype=torch.int32, device=dev),
            im=torch.full((slots, p), -1.0, dtype=torch.float32, device=dev),
            seg_lo=torch.full((slots, nb), e.n_docs, dtype=torch.int32,
                              device=dev),
            seg_hi=torch.full((slots, nb), -1, dtype=torch.int32,
                              device=dev),
            sdocs=torch.full((slots, lp), -1, dtype=torch.int32, device=dev),
            s3=torch.zeros((slots, lp, 3), dtype=e.pscore.dtype, device=dev),
            acc=torch.zeros((slots, e.n_docs), dtype=torch.float32,
                            device=dev),
        )

    def gather(self, qt: np.ndarray):
        """Gather one refill group's slot rows.  qt: (grain, L) int32, -1
        padded.  Returns (device row tuple, host stream lengths)."""
        e = self.engine
        *rows, slen = self._run("sgather", _sched_gather, e.offsets, e.pdoc,
                                e.pimp, e.pscore, self._dev(qt),
                                cap=e.cfg.stream_cap, bounds_p=self.bounds_p,
                                n_docs=e.n_docs)
        return tuple(rows), slen.cpu().numpy()

    def refill(self, state: SchedState, slot_idx: np.ndarray,
               rows) -> SchedState:
        """Install gathered rows at ``slot_idx`` and zero their
        accumulator rows.  Entries equal to the table's capacity are the
        group's padding; they trail the real ones and are sliced off on
        the host (an out-of-range index would be an error on the CPU and
        a device-side assert on the card)."""
        n = int((slot_idx < state.acc.shape[0]).sum())
        if (slot_idx[n:] < state.acc.shape[0]).any():
            raise ValueError("refill padding must trail the real slots")
        idx = self._dev(slot_idx[:n].astype(np.int64))
        out = self._run("refill", _sched_refill, state.ds, state.im,
                        state.seg_lo, state.seg_hi, state.sdocs, state.s3,
                        state.acc, idx, *(r[:n] for r in rows))
        return SchedState(*out)

    def chunk(self, state: SchedState, pos: np.ndarray,
              end: np.ndarray) -> SchedState:
        """Advance every active slot by one chunk window."""
        e = self.engine
        acc = self._run("chunk", _sched_chunk, state.ds, state.im,
                        state.seg_lo, state.seg_hi, state.acc,
                        self._dev(pos), self._dev(end), chunk_p=self.chunk_p,
                        bounds_p=self.bounds_p, n_docs=e.n_docs,
                        block_d=e.block_d)
        return dataclasses.replace(state, acc=acc)

    def finalize(self, state: SchedState, slot_idx: np.ndarray,
                 pvec: np.ndarray, dvec: np.ndarray,
                 qids: np.ndarray) -> np.ndarray:
        """Stages 1b-3 for a retiring group; returns host ranked lists
        (grain, rerank_depth).  ``pvec`` is the pool-width vector (k knob;
        unused for rho, whose budget was applied in the chunks), ``dvec``
        the per-slot reranking depth."""
        e = self.engine
        cfg = e.cfg
        idx = self._dev(slot_idx.astype(np.int64))
        kw = dict(depth=cfg.rerank_depth, n_docs=e.n_docs,
                  n_terms=state.sdocs.shape[1] // cfg.stream_cap)
        if cfg.knob == "rho":
            r = self._run("finalize", _sched_finalize_rho, state.acc,
                          state.sdocs, state.s3, idx, self._dev(dvec),
                          self._dev(qids), e.doc_len, **kw)
        else:
            r = self._run("finalize", _sched_finalize_k, state.acc,
                          state.sdocs, state.s3, idx, self._dev(pvec),
                          self._dev(dvec), self._dev(qids), e.doc_len,
                          max_k=e.max_k, **kw)
        return _pad_ranked(r.cpu().numpy(), cfg.rerank_depth)

    def warmup(self, slots: int, query_len: int) -> int:
        """Run all four stages once on a scratch table (first-call
        allocations, kernel builds): the dummy refill is all padding and
        the dummy chunk runs at rho 0, and no live state is touched.
        Returns the programs compiled: 0, since nothing is compiled."""
        g = self.grain
        state = self.init_state(slots, query_len)
        rows, _ = self.gather(np.full((g, query_len), -1, np.int32))
        state = self.refill(state, np.full(g, slots, np.int32), rows)
        zeros = np.zeros(slots, np.int32)
        state = self.chunk(state, zeros, zeros)
        self.finalize(state, np.zeros(g, np.int32), np.ones(g, np.int32),
                      np.ones(g, np.int32), np.zeros(g, np.int32))
        return 0
