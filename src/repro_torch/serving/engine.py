"""Batch-once serving engine, unsharded and sharded over a device mesh.

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

Every stage runs through a shape-keyed program cache, the port of the
JAX engine's AOT executable cache (``_compiled``): the key is the stage's
name and its tensor arguments' shapes and dtypes, static configuration
goes by keyword, and the predicted parameters are tensors, so a padded
batch shape builds each stage's program once whatever its mix of
classes.  On a CUDA device a program is a CUDA graph captured once and
replayed (``serving/programs.py``'s ``ProgramCache``, a cache of the
engine's own: the server's predicts have another); on the CPU it is the
stage function itself.  ``n_compiles`` (and the ``engine.compiles``
counter) counts the programs built, the JAX engine's count on the same
calls, and
``warmup``/``warmup_shape`` build the pad grid ahead of traffic.  Each
stage runs inside an ``engine.<name>`` span (``bind_obs``; the JAX
engine's names) and counts one dispatch; its timing is the span's,
fenced inside the span on the calling thread's current CUDA stream, so a
stage of one service thread does not wait for another thread's work; a
build runs before the span, as the JAX engine compiles outside it.  The
ranked lists leave the device once, through ``.cpu().numpy()``.
Stage-2 noise qids are the query's batch position, as in the JAX engine.

``ShardedServingEngine`` runs the same stages over a ``DeviceMesh``:
docs split in equal ranges over the ``model`` axis, request rows over
the data axes, and each shard runs ``impact_scan`` and ``topk`` on its
own doc-range partition of the streams.  One process drives every
shard, as the JAX engine's single controller drives its mesh.  Its six
stages go through the same program cache, as the JAX engine compiles
them: a stage takes a flat tuple of every position's tensors and its
shard geometry by keyword, so its ``n_compiles`` is the JAX engine's.

``SchedPrograms`` is the continuous scheduler's execution surface over
the same engine (``serving/sched``): four stage functions -- gather,
refill, chunk, finalize -- whose shapes are fixed by the slot table, so
any admit/retire churn runs the same kernels at the same shapes.  The
chunk runs ``impact_scan`` on a (slots, chunk_p) window of the table;
the finalize runs ``topk`` on a group of ``grain`` finished rows.  The
four go through the engine's program cache.  ``ShardedSchedPrograms``
is its form over the sharded engine, its four stages through the
sharded engine's cache.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.obs import device as obs_device
from repro_torch.device import device_scope, fence, resolve_device
from repro_torch.distrib import collectives
from repro_torch.distrib.sharding import MeshInfo
from repro_torch.kernels.impact_scan.ops import owned_prefix_len
from repro_torch.kernels.topk import ops as tk_ops
from repro_torch.retrieval import gold, jass
from repro_torch.retrieval import topk as topk_lib
from repro_torch.retrieval.index import (block_doc_bounds, partition_cap,
                                         partition_postings,
                                         partition_scored_postings)
from repro_torch.serving import bucketing
from repro_torch.serving.programs import ProgramCache

__all__ = ["SchedPrograms", "SchedState", "ServingEngine",
           "ShardedSchedPrograms", "ShardedServingEngine"]


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


def _install(bufs, acc, slot_idx, rows) -> tuple:
    """Install a refill group's gathered ``rows`` into the slot table's
    ``bufs`` at ``slot_idx`` and zero those slots' ``acc`` rows, out of
    place: the old state stays whole if any copy raises.  Entries of
    ``slot_idx`` equal to the table's capacity are the group's padding,
    whose rows are dropped (the JAX engine's ``mode="drop"``), so a
    group has one shape whatever its fill: each slot takes the row whose
    index names it, or keeps its own."""
    slots = acc.shape[0]
    dev = acc.device
    src = torch.full((slots + 1,), -1, dtype=torch.int64, device=dev)
    src = src.index_put((slot_idx,), torch.arange(
        slot_idx.shape[0], dtype=torch.int64, device=dev))[:slots]
    hit = src >= 0
    take = src.clamp(min=0)

    def put(buf, new):
        keep = hit.view((-1,) + (1,) * (buf.dim() - 1))
        return torch.where(keep, new.index_select(0, take), buf)

    return (tuple(put(b, r) for b, r in zip(bufs, rows))
            + (acc.masked_fill(hit[:, None], 0.0),))


def _sched_refill(ds_b, im_b, lo_b, hi_b, sd_b, s3_b, acc, slot_idx,
                  ds, im, lo, hi, sd, s3):
    """``_install`` of a refill group's rows (the slot table's six
    buffers)."""
    return _install((ds_b, im_b, lo_b, hi_b, sd_b, s3_b), acc, slot_idx,
                    (ds, im, lo, hi, sd, s3))


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
        # the stages' shape-keyed program cache; a captured program reads
        # the index tensors in place (never copied)
        self._programs = ProgramCache(
            self.device, consts=(self.offsets, self.pdoc, self.pimp,
                                 self.pscore, self.doc_len))
        # observability: spans around stage boundaries + deterministic
        # dispatch/compile counters (NULL until bind_obs)
        self.trace = obs_lib.NULL_TRACE
        self._dev = None               # the recorder's device timer
        self._m_dispatch = obs_lib.NULL_METRIC
        self._m_compile = obs_lib.NULL_METRIC

    def bind_obs(self, obs) -> None:
        """Attach an observability handle: per-stage spans in ``serve``
        (each with its program's device interval while the recorder is
        watched: ``obs/device.py``), plus the dispatch and compile
        counters."""
        self.trace = obs.trace
        self._dev = obs_device.timer(obs, self.device)
        self._m_dispatch = obs.metrics.counter("engine.dispatches")
        self._m_compile = obs.metrics.counter("engine.compiles")
        self._programs.metric = self._m_compile

    # ---------------------------------------------------- program cache --
    @property
    def n_compiles(self) -> int:
        """Programs the stage cache built (the JAX engine's count)."""
        return self._programs.built()

    def _compiled(self, name: str, fn, args, kwargs, consts=()):
        """Shape-keyed program cache lookup; builds on a miss
        (``ProgramCache.compiled``: the JAX engine's key, lock and
        pending marker; ``consts``: the program's own constants)."""
        return self._programs.compiled(name, fn, args, kwargs, consts)

    def program_stats(self) -> dict:
        """The stage cache: programs built, CUDA graphs among them, their
        replays and the bytes of static inputs and outputs they hold
        (the graph pools hold the captures' intermediates beside)."""
        return self._programs.stats()

    def padded_batch(self, n: int) -> int:
        return bucketing.pad_length(n, self.batch_multiple)

    def _to_device(self, rows: np.ndarray, fill: int) -> torch.Tensor:
        padded = bucketing.pad_rows(rows, self.batch_multiple, fill=fill)
        return _h2d(padded.astype(np.int32), self.device)

    def _fence(self) -> None:
        fence(self.device)

    def _spanned(self, timings: dict, label: str, name: str, fn, *args,
                 **kwargs):
        """Run ``fn`` in the ``engine.<name>`` span, the device fence
        inside it; ``timings[label]`` is the span's ms."""
        self._fence()
        self._m_dispatch.inc()
        with self.trace.span("engine." + name) as sp:
            if self._dev is None:
                out = fn(*args, **kwargs)
            else:
                out = self._dev.call(sp, fn, *args, **kwargs)
            self._fence()
        timings[label] = sp.dur_ms
        return out

    def _timed(self, timings: dict, label: str, name: str, fn, *args,
               **kwargs):
        """One stage through the program cache: the program is built
        (on a miss) before the span, and the span times its run."""
        prog = self._compiled(name, fn, args, kwargs)
        return self._spanned(timings, label, name, prog, *args)

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
        kern = dict(n_docs=self.n_docs, block_p=self.block_p,
                    block_d=self.block_d)
        ds, im, seg_lo, seg_hi, sdocs, s3 = self._timed(
            timings, "gather_ms", "gather", _stage_gather, self.offsets,
            self.pdoc, self.pimp, self.pscore, qt, cap=self.cfg.stream_cap,
            block_p=self.block_p, n_docs=self.n_docs)
        if self.cfg.knob == "rho":
            pool = self._timed(timings, "stage1_ms", "stage1", _stage1_rho,
                               ds, im, seg_lo, seg_hi, pv,
                               depth=self.cfg.rerank_depth, **kern)
        else:
            pool = self._timed(timings, "stage1_ms", f"stage1:{width}",
                               _stage1_k, ds, im, seg_lo, seg_hi, pv,
                               max_k=width, **kern)
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
        if self._dev is not None:      # the stream is idle after the copy
            self._dev.anchor()
        return _pad_ranked(ranked, self.cfg.rerank_depth), timings

    def warmup_shape(self, batch_size: int, query_len: int, *,
                     with_depth: bool = False) -> int:
        """Build the whole pipeline's programs for one padded batch size
        (the unit the learned warmup policy requests).  ``with_depth``
        also builds the dynamic-depth rerank (servers with a depth knob
        pass it, so the first depth-predicting batch finds it built).
        Returns the programs built (0 when the shape was already
        warm)."""
        before = self._programs.built()
        b = self.padded_batch(int(batch_size))
        qt = np.full((b, query_len), -1, np.int32)
        pv = np.ones(b, np.int32)
        self.serve(qt, pv)
        if with_depth:
            self.serve(qt, pv, depth_vec=np.ones(b, np.int32))
        return self._programs.built() - before

    def warmup(self, batch_sizes, query_len: int, *,
               with_depth: bool = False) -> int:
        """Build the pipeline's programs for each padded batch size in
        ``batch_sizes`` (the configured pad grid).  Returns the number
        of programs built."""
        before = self._programs.built()
        for b in sorted({self.padded_batch(int(b)) for b in batch_sizes}):
            self.warmup_shape(b, query_len, with_depth=with_depth)
        return self._programs.built() - before

    # ----------------------------------------------- continuous serving --
    @property
    def supports_continuous(self) -> bool:
        """Whether ``SchedPrograms``/``ContinuousBackend`` can drive this
        engine (a capability check, as in the JAX package)."""
        return True

    @property
    def continuous_unsupported_reason(self) -> str | None:
        return None


# ----------------------------------------------------- sharded stages --
# The sharded stages, the port of the JAX engine's shard_map bodies.  A
# stage runs over the whole mesh as one program: its positional
# arguments are flat, a fixed number of tensors a mesh position (data
# groups major, shards minor: ``_flat``), each on its position's device,
# and the shard geometry -- the data groups, each shard's first doc
# ``los``, the shard width, caps -- comes in by keyword, so the program
# cache keys a stage on its tensors' shapes as the JAX engine keys its
# executables.  Each data group's body (``_sh_*``) takes lists over the
# group's shards and runs every shard's share, with the collectives
# (``distrib.collectives``) between.  The streams are doc-range
# partitioned at gather time: each shard keeps the postings of the docs
# it owns, compacted into a ``shard_cap``-wide local stream in global
# order, and each posting's global stream position (``gpos``) carries the
# rho bookkeeping: ``count(gpos < rho)`` is the shard-local rho, so the
# same kernel runs on the local stream with no new mask.  Every (Q, docs)
# accumulator shrinks to (Q, shard_width), and only k-sized survivor
# lists cross between shards.  Each step keeps the unsharded engine's
# arithmetic: the compaction keeps the order of the adds, the survivor
# merge keeps the lowest doc id of a tie, and min, max and copies are
# exact, so the lists are the unsharded engine's bit for bit.

@dataclasses.dataclass(frozen=True)
class _Shard:
    """One mesh position: its device, the first doc it owns, and the
    tensors placed on it once (the postings replicated, ``doc_len`` its
    own range, padding docs at length 1): the sharded programs'
    constants."""

    device: torch.device
    lo: int
    offsets: torch.Tensor
    pdoc: torch.Tensor
    pimp: torch.Tensor
    pscore: torch.Tensor
    doc_len: torch.Tensor

    @property
    def index(self) -> tuple:
        return self.offsets, self.pdoc, self.pimp, self.pscore


def _flat(*cols) -> tuple:
    """A sharded stage's flat tensor arguments: for each mesh position
    (data groups major, shards minor), its entry of each column, a
    [group][shard] list of tensors or tuples of tensors."""
    out = []
    for g, group in enumerate(cols[0]):
        for s in range(len(group)):
            for col in cols:
                x = col[g][s]
                out.extend(x if isinstance(x, tuple) else (x,))
    return tuple(out)


def _nest(flat, groups: int, k: int) -> list:
    """``_flat``'s inverse: [group][shard] k-tuples of a flat tuple."""
    per = len(flat) // (groups * k)
    return [[tuple(flat[(g * per + s) * k:(g * per + s + 1) * k])
             for s in range(per)] for g in range(groups)]


def _sh_gather(pos, los, *, cap: int, shard_cap: int, block_p: int,
               width: int, slack: float):
    """Gather + doc-range partition over one data group: each shard's
    slice of the streams.  ``pos``: the shards' (offsets, pdoc, pimp,
    pscore, qt); ``los``: each shard's first doc.

    The global streams are gathered once a device, as on the unsharded
    path, then split by doc range.  Segment bounds are computed on the
    local stream in shard-local doc ids (posting blocks a shard does not
    own never enter its kernel grid); the score streams split the same
    way, each posting keeping its term (``sterm``) for stage 2.
    Returns (per-shard row tuples (ds, im, seg_lo, seg_hi, gpos, sd, s3,
    sterm), the per-query partition overflow (the max over shards, on
    each shard's device), the stream lengths (first shard's))."""
    n_shards = len(pos)
    devs = [p[4].device for p in pos]
    streams = collectives.per_device(devs, lambda i: (
        jass.gather_streams(*pos[i][:3], pos[i][4], cap=cap),
        jass.gather_score_streams(pos[i][0], pos[i][1], pos[i][3],
                                  pos[i][4], cap=cap)))
    rows, over = [], []
    for lo, dev, ((ds, im), (sdocs, s3)) in zip(los, devs, streams):
        with device_scope(dev):
            ds_l, im_l, gpos, novf = partition_postings(
                ds, im, lo, width=width, cap=shard_cap)
            seg_lo, seg_hi = block_doc_bounds(ds_l, block_p=block_p,
                                              n_docs=width)
            score_cap = partition_cap(sdocs.shape[-1], n_shards, slack)
            sd_l, s3_l, spos, sovf = partition_scored_postings(
                sdocs, s3, lo, width=width, cap=score_cap)
            rows.append((ds_l, im_l, seg_lo, seg_hi, gpos, sd_l, s3_l,
                         spos // cap))
            over.append(torch.maximum(novf, sovf))
    slen = (streams[0][0][0] >= 0).sum(dim=-1).to(torch.int32)
    return rows, collectives.pmax(over), slen


def _sh_survivors(accs, los, kl: int):
    """Each shard's top-``kl`` (values, global doc ids) of its local
    scores: the ``topk`` kernel for kl <= KP_MAX, else the plain stable
    sort, as on the unsharded path."""
    out = []
    for acc, lo in zip(accs, los):
        with device_scope(acc.device):
            v, i = tk_ops.topk_select(acc, kl)
            out.append((v, (i + lo).to(torch.int32)))
    return out


def _sh_stage1(pos, los, *, knob: str, width: int, kl: int, block_p: int,
               block_d: int):
    """Local stage 1 over one data group's partitions (``pos``: the
    shards' ds, im, seg_lo, seg_hi, gpos and parameter vector):
    rho-masked accumulation on the local stream (rho through
    ``owned_prefix_len``; the k knob accumulates the whole stream) and
    the shard's survivors.  No collective: the survivor merge comes
    after stage 2."""
    accs = []
    for i in range(len(pos)):
        ds_l, im_l, seg_lo, seg_hi, gpos, pv = pos[i]
        with device_scope(ds_l.device):
            if knob == "rho":
                rho_l = owned_prefix_len(gpos, pv)
            else:
                rho_l = torch.full(ds_l.shape[:1], ds_l.shape[-1],
                                   dtype=torch.int32, device=ds_l.device)
            accs.append(jass.saat_scores_masked(
                ds_l, im_l, rho_l, width, use_kernel=True,
                seg_bounds=(seg_lo, seg_hi), block_p=block_p,
                block_d=block_d))
    return _sh_survivors(accs, los, kl)


def _sh_merge(vflat, gflat, k_vecs, *, depth: int):
    """The arithmetic half of the pool merge: the gathered survivors
    down to the top-``depth`` pool on each shard (-1 where the score is
    not positive), masked to each query's pool width ``k_vecs`` (k knob;
    None under rho)."""
    def one(i):
        mv, mg = collectives.merge_gathered_topk(vflat[i], gflat[i], depth)
        pool = torch.where(mv > 0, mg, torch.full_like(mg, -1))
        return pool if k_vecs is None else _depth_mask(pool, k_vecs[i])
    return collectives.per_device([v.device for v in vflat], one)


def _sh_stage2(pos, los, *, width: int, n_docs: int, n_terms: int):
    """Doc-sharded stage 2 over one data group's partitioned score
    streams (``pos``: the shards' sd, s3, sterm, doc_len and qids):
    local scorer accumulators (term by term, so each cell sees the
    unsharded adds in the unsharded order), then the second-stage
    mixture with the per-query normalization bounds reduced over the
    shards (pmin/pmax of local min/max: exact; padding doc columns
    masked out)."""
    accs, lo_b, hi_b, gcols = [], [], [], []
    for (sd, s3, st, _, _), lo in zip(pos, los):
        with device_scope(sd.device):
            acc = torch.stack(jass.scorer_accumulators_by_term(
                sd, s3, st, width, n_terms=n_terms), dim=1)  # (Q, 3, W)
            cols = lo + torch.arange(width, device=sd.device)
            real = (cols < n_docs)[None, None, :]
            lo_b.append(torch.where(real, acc, float("inf")).amin(dim=-1))
            hi_b.append(torch.where(real, acc, float("-inf")).amax(dim=-1))
        accs.append(acc)
        gcols.append(cols)
    lo_b, hi_b = collectives.pmin(lo_b), collectives.pmax(hi_b)
    out = []
    for (sd, _, _, doc_len, qid), acc, lo, hi, cols in zip(
            pos, accs, lo_b, hi_b, gcols):
        with device_scope(sd.device):
            bounds = tuple((lo[:, j:j + 1], hi[:, j:j + 1]) for j in range(3))
            out.append(gold.second_stage_mix(
                acc[:, 0], acc[:, 1], acc[:, 2], bounds, doc_len, qid,
                cols))
    return out


def _sh_rerank(stage2, pools, d_vecs, los, *, width: int, depth: int):
    """The rerank over doc-sharded stage-2 scores: the owning shard gives
    each pool member's score, pmax assembles the (Q, pool) score matrix
    (the only stage-2 collective), and the first shard ranks it.
    ``d_vecs`` is the per-query reranking depth (None: no mask), applied
    to the replicated pool first."""
    if d_vecs is not None:
        pools = [_depth_mask(p, d) for p, d in zip(pools, d_vecs)]
    parts = []
    for s2, pool, lo in zip(stage2, pools, los):
        with device_scope(s2.device):
            own = (pool >= lo) & (pool < lo + width)
            local = (pool - lo).clamp(0, width - 1).long()
            parts.append(torch.where(
                own, s2.gather(1, local),
                torch.full(pool.shape, float("-inf"), device=s2.device)))
    s = collectives.pmax(parts)[0]
    with device_scope(pools[0].device):
        return gold.rank_pool_scores(s, pools[0], depth)


# The six programs of the sharded engine: each runs its ``_sh_*`` body
# over every data group of the flat arguments.

def _shs_gather(*flat, groups: int, los: tuple, cap: int, shard_cap: int,
                block_p: int, width: int, slack: float):
    """Per position: offsets, pdoc, pimp, pscore (constants) and the
    query rows -> the eight partitioned rows and the group's overflow."""
    out, nested = [], _nest(flat, groups, 5)
    for g in range(groups):
        rows, over, _ = _sh_gather(nested[g], los, cap=cap,
                                   shard_cap=shard_cap, block_p=block_p,
                                   width=width, slack=slack)
        out += [t for r, o in zip(rows, over) for t in r + (o,)]
    return tuple(out)


def _shs_stage1(*flat, groups: int, los: tuple, knob: str, width: int,
                kl: int, block_p: int, block_d: int):
    """Per position: ds, im, seg_lo, seg_hi, gpos, the parameter vector
    -> the shard's survivors (values, global ids)."""
    nested = _nest(flat, groups, 6)
    return tuple(t for g in range(groups)
                 for surv in _sh_stage1(nested[g], los, knob=knob,
                                        width=width, kl=kl, block_p=block_p,
                                        block_d=block_d)
                 for t in surv)


def _shs_allgather(*flat, groups: int):
    """Per position: the survivors -> every shard's survivors of the
    group, gathered (B, S*kl) on each shard's device."""
    out, nested = [], _nest(flat, groups, 2)
    for g in range(groups):
        vflat, gflat = collectives.gather_local_topk(*zip(*nested[g]))
        out += [t for pair in zip(vflat, gflat) for t in pair]
    return tuple(out)


def _shs_stage2(*flat, groups: int, los: tuple, width: int, n_docs: int,
                n_terms: int):
    """Per position: sd, s3, sterm, doc_len (a constant) and qids -> the
    shard's (Q, shard_width) stage-2 scores."""
    nested = _nest(flat, groups, 5)
    return tuple(t for g in range(groups)
                 for t in _sh_stage2(nested[g], los, width=width,
                                     n_docs=n_docs, n_terms=n_terms))


def _shs_merge(*flat, groups: int, depth: int, masked: bool):
    """Per position: the gathered survivors (and the pool width vector
    when ``masked``, the k knob) -> the merged pool."""
    out, nested = [], _nest(flat, groups, 3 if masked else 2)
    for g in range(groups):
        cols = list(zip(*nested[g]))
        out += _sh_merge(cols[0], cols[1], cols[2] if masked else None,
                         depth=depth)
    return tuple(out)


def _shs_rerank(*flat, groups: int, los: tuple, width: int, depth: int,
                dyn: bool):
    """Per position: the stage-2 scores and the pool (and the reranking
    depth vector when ``dyn``) -> the group's ranked lists, one tensor a
    data group."""
    out, nested = [], _nest(flat, groups, 3 if dyn else 2)
    for g in range(groups):
        cols = list(zip(*nested[g]))
        out.append(_sh_rerank(cols[0], cols[1], cols[2] if dyn else None,
                              los, width=width, depth=depth))
    return tuple(out)


class ShardedServingEngine(ServingEngine):
    """The batch-once engine over a ``DeviceMesh``.

    Layout: the doc dimension of every stage-1/stage-2 accumulator
    shards over ``axis`` ('model'); request rows split over the
    data-parallel axes ('pod', 'data') into data groups of equal size.
    ``n_docs`` is padded up to a multiple of the shard count with inert
    columns, so uneven shards need no special case and global doc ids
    are true column offsets.  Each shard holds a ``shard_cap``-wide
    compacted stream of the postings it owns (``shard_cap ~= slack * cap
    / n_shards``, ``ServingConfig.partition_slack``); a shard that owns
    more raises ``RuntimeError`` naming the knob.  Outputs are the
    unsharded engine's bit for bit (the JAX package's promise).

    ``serve`` runs six dispatches a batch, as the JAX engine: gather,
    stage 1 (local, ending at each shard's survivors), the survivors'
    all-gather, stage 2, the merge, the rerank.  Each goes through the
    engine's program cache, as the JAX engine compiles the six (one
    program a stage and padded shape, over every position: a CUDA graph
    on the card; the placed index tensors and ``doc_len`` slices are its
    constants), so ``n_compiles`` is the JAX engine's count.  The
    all-gather runs inside stage 2's span (the JAX engine overlaps it
    with stage 2, and its ``stage2_ms`` holds what stage 2 did not
    hide); ``merge_ms`` is the merge's span.  Kernel routing is the
    unsharded engine's, per shard: ``impact_scan`` on the local stream
    (local doc ids, local segment bounds, rho through
    ``owned_prefix_len``) and ``topk_select`` at ``kl = min(pool depth,
    shard_width)``; their launches are captured in stage 1 and count at
    each replay.

    A program is captured on one device, so the positions of a mesh
    must lie on one device (on the card, ``launch.mesh.
    force_host_device_count`` lays them all on it): over several devices
    a stage raises when it is built, naming the layout, and nothing runs
    eagerly in its place.
    """

    def __init__(self, index, cfg, mesh, *, axis: str = "model"):
        self.n_shards = collectives.require_axis(
            mesh, axis, what="ShardedServingEngine")
        info = MeshInfo(mesh)
        stray = [a for a in mesh.axis_names if a != axis and a not in info.dp]
        if stray:
            raise ValueError(f"ShardedServingEngine: mesh axes {stray} are "
                             f"neither data axes nor the shard axis {axis!r}")
        grid = mesh.grid(axis)
        super().__init__(index, cfg, device=grid[0][0])
        self.mesh = mesh
        self.axis = axis
        self.dp = info.dp
        self.dp_size = info.dp_size
        self.batch_multiple = math.lcm(cfg.pad_multiple, self.dp_size)
        self.doc_pad = bucketing.pad_length(self.n_docs, self.n_shards)
        self.shard_width = self.doc_pad // self.n_shards
        self.shard_cap = partition_cap(cfg.stream_cap, self.n_shards,
                                       cfg.partition_slack)
        dl = torch.nn.functional.pad(self.doc_len,
                                     (0, self.doc_pad - self.n_docs), value=1)
        placed = {}
        for row in grid:
            for dev in row:
                if dev not in placed:
                    placed[dev] = tuple(t.to(dev) for t in (
                        self.offsets, self.pdoc, self.pimp, self.pscore))
        w = self.shard_width
        #: [data group][shard] mesh positions
        self.groups = [[_Shard(dev, s * w, *placed[dev],
                               dl[s * w:(s + 1) * w].to(dev))
                        for s, dev in enumerate(row)] for row in grid]
        self._devices = tuple(placed)
        self._los = tuple(sh.lo for sh in self.groups[0])
        # the stages' programs read every position's placed tensors in
        # place
        self._programs = ProgramCache(self.device, consts=tuple(
            t for group in self.groups for sh in group
            for t in sh.index + (sh.doc_len,)))
        self._budget_grids: dict = {}    # length -> (widths, per shard)

    def _fence(self) -> None:
        for dev in self._devices:
            fence(dev)

    def _compiled(self, name: str, fn, args, kwargs, consts=()):
        """``ServingEngine._compiled``, for positions on one device: a
        program is captured on one device's stream, so a mesh over
        several devices raises here, naming its layout."""
        if len(self._devices) > 1:
            raise RuntimeError(
                f"ShardedServingEngine: stage {name!r} cannot be built: "
                f"the mesh {dict(self.mesh.shape)} lays its positions over "
                f"{len(self._devices)} devices {list(map(str, self._devices))}"
                ", and a program is captured on one device (lay the "
                "positions on one device with launch.mesh."
                "force_host_device_count)")
        return super()._compiled(name, fn, args, kwargs, consts)

    def budget_grid(self, widths: tuple) -> list:
        """The sharded scheduler's budget grid on each shard's device,
        made once an engine: its gather program reads the grid in place,
        so every scheduler on this engine shares the tensors.  A grid of
        the same length with other budgets would replay the program of
        the first, and raises."""
        widths = tuple(int(w) for w in widths)
        got = self._budget_grids.get(len(widths))
        if got is None:
            grid = torch.tensor(widths, dtype=torch.int32)
            got = self._budget_grids.setdefault(len(widths), (
                widths, collectives.per_device(
                    [sh.device for sh in self.groups[0]],
                    lambda i: grid.to(self.groups[0][i].device))))
        if got[0] != widths:
            raise ValueError(
                f"ShardedServingEngine: a scheduler's budget grid {widths} "
                f"has the length of the grid {got[0]} its gather program "
                "was built on; schedulers of one engine share that "
                "program (use one set of extra widths per engine)")
        return got[1]

    def _column(self, attr: str) -> list:
        """[group][shard] of a placed attribute of each position."""
        return [[getattr(sh, attr) for sh in group] for group in self.groups]

    # ----------------------------------------------- continuous serving --
    @property
    def supports_continuous(self) -> bool:
        """The sharded continuous scheduler keeps one slot table: a
        data-parallel mesh would split the slot rows over data groups,
        and the host's slot bookkeeping does not span them."""
        return self.dp_size == 1

    @property
    def continuous_unsupported_reason(self) -> str | None:
        if self.supports_continuous:
            return None
        return (f"the mesh has data-parallel axes {self.dp} (dp_size="
                f"{self.dp_size}); the sharded continuous scheduler "
                "needs a model-only mesh — use ShardedEngineBackend's "
                "batch-once path for data-parallel serving")

    def _split(self, rows: np.ndarray, fill: int) -> list:
        """Host rows padded to the batch grid, split over the data
        groups, on each shard's device: [group][shard] tensors."""
        padded = bucketing.pad_rows(rows, self.batch_multiple,
                                    fill=fill).astype(np.int32)
        per = padded.shape[0] // self.dp_size
        out = []
        for g, group in enumerate(self.groups):
            host = padded[g * per:(g + 1) * per]
            out.append(collectives.per_device(
                [sh.device for sh in group],
                lambda i: _h2d(host, group[i].device)))
        return out

    def check_overflow(self, worst: int) -> None:
        """Raise when a shard owned ``worst`` > 0 postings more than its
        stream slot holds (they would be dropped, the lists wrong)."""
        if worst > 0:
            raise RuntimeError(
                f"partition overflow: a shard owned {worst} more postings "
                f"than its stream slot (shard_cap={self.shard_cap}, "
                f"stream_cap={self.cfg.stream_cap}, n_shards="
                f"{self.n_shards}); raise ServingConfig.partition_slack")

    def serve(self, query_terms: np.ndarray, param_vec: np.ndarray,
              pool_width: int | None = None,
              depth_vec: np.ndarray | None = None):
        """The sharded pipeline: gather (+ partition) -> local stage 1
        -> the survivors' all-gather and stage 2 -> the pool merge ->
        the rerank.  Arguments and result as ``ServingEngine.serve``;
        ``timings`` also holds ``merge_ms``.  Stage-2 noise keys on each
        query's position in the whole padded batch, whatever data group
        serves it."""
        n = query_terms.shape[0]
        qt = self._split(query_terms, fill=-1)
        pv = self._split(param_vec, fill=1)
        dv = (None if depth_vec is None else self._split(depth_vec, fill=1))
        per = qt[0][0].shape[0]
        qids = self._split(np.arange(per * self.dp_size), fill=0)
        cfg = self.cfg
        width = int(pool_width or self.max_k)
        rho = cfg.knob == "rho"
        kl = min(cfg.rerank_depth if rho else width, self.shard_width)
        suffix = "" if rho or width == self.max_k else f":{width}"
        groups = self.dp_size
        geo = dict(groups=groups, los=self._los, width=self.shard_width)
        timings = {}

        rows = _nest(self._timed(
            timings, "gather_ms", "gather", _shs_gather,
            *_flat(self._column("index"), qt), cap=cfg.stream_cap,
            shard_cap=self.shard_cap, block_p=self.block_p,
            slack=cfg.partition_slack, **geo), groups, 9)
        surv = self._timed(
            timings, "stage1_ms", "stage1" + suffix, _shs_stage1,
            *_flat([[r[:5] for r in g] for g in rows], pv), knob=cfg.knob,
            kl=kl, block_p=self.block_p, block_d=self.block_d, **geo)
        # the all-gather is its own program, dispatched inside stage 2's
        # span just before stage 2 (the JAX engine issues it, then
        # stage 2, and times both in stage 2's span)
        gather_prog = self._compiled("allgather", _shs_allgather, surv,
                                     dict(groups=groups))
        s2_args = _flat([[r[5:8] for r in g] for g in rows],
                        self._column("doc_len"), qids)
        s2_kw = dict(n_docs=self.n_docs, n_terms=query_terms.shape[1],
                     **geo)
        s2_prog = self._compiled("stage2", _shs_stage2, s2_args, s2_kw)
        self._m_dispatch.inc()         # the all-gather's dispatch
        gathered, stage2 = self._spanned(
            timings, "stage2_ms", "stage2",
            lambda: (gather_prog(*surv), s2_prog(*s2_args)))
        gathered = _nest(gathered, groups, 2)
        pools = self._timed(
            timings, "merge_ms", "merge" + suffix, _shs_merge,
            *(_flat(gathered) if rho else _flat(gathered, pv)),
            groups=groups, depth=cfg.rerank_depth if rho else width,
            masked=not rho)
        s2_pool = _flat(_nest(stage2, groups, 1), _nest(pools, groups, 1))
        ranked = self._timed(
            timings, "rerank_ms", "rerank" if dv is None else "rerank_dyn",
            _shs_rerank, *(s2_pool if dv is None else _flat(
                _nest(s2_pool, groups, 2), dv)),
            depth=cfg.rerank_depth, dyn=dv is not None, **geo)
        overs = [g[0][8] for g in rows]
        self.check_overflow(int(torch.stack(
            [o.to(self.device).amax() for o in overs]).amax().cpu().numpy()))
        ranked = torch.cat([r.to(self.device) for r in ranked])
        return _pad_ranked(ranked[:n].cpu().numpy(), cfg.rerank_depth), timings


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
    # sharded programs only: the global stream position of each posting
    # of the partitioned local streams (the rho bookkeeping), and each
    # score-stream posting's term; every field is then a tuple over the
    # shards, each element on its shard's device
    gpos: torch.Tensor | None = None
    sterm: torch.Tensor | None = None


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
    stage runs through the engine's program cache (a CUDA graph per
    stage on the card, built once, as the JAX engine compiles the four
    programs once), counts one engine dispatch and runs in a
    ``sched.<name>`` span that covers the dispatch only (no fence).
    """

    #: the scheduler's branch: sharded programs advance per-slot local
    #: stream cursors (``Slot.lpos``/``lend``), these the global ones
    sharded = False

    @classmethod
    def for_engine(cls, engine: ServingEngine, *, grain: int,
                   chunk_p: int | None = None,
                   extra_widths=()) -> "SchedPrograms":
        """The program set matching the engine's layout."""
        if isinstance(engine, ShardedServingEngine):
            return ShardedSchedPrograms(engine, grain=grain,
                                        chunk_p=chunk_p,
                                        extra_widths=extra_widths)
        return SchedPrograms(engine, grain=grain, chunk_p=chunk_p)

    def __init__(self, engine: ServingEngine, *, grain: int,
                 chunk_p: int | None = None):
        if (isinstance(engine, ShardedServingEngine)
                and not isinstance(self, ShardedSchedPrograms)):
            raise TypeError(
                "SchedPrograms' slot table assumes unsharded stage "
                "tensors; build via SchedPrograms.for_engine (or "
                "ShardedSchedPrograms) for a mesh engine")
        self.engine = engine
        p = self._slot_cap(engine)
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

    def _slot_cap(self, engine: ServingEngine) -> int:
        """Per-slot posting-stream width the chunk windows tile."""
        return engine.cfg.stream_cap

    def _run(self, name: str, fn, *args, consts=(), **kwargs):
        """One stage through the engine's program cache (built on a miss
        before the span; ``consts``: tensors among ``args`` the program
        reads in place); the span covers the dispatch window only."""
        e = self.engine
        prog = e._compiled(name, fn, args, kwargs, consts)
        e._m_dispatch.inc()
        with e.trace.span("sched." + name):
            return prog(*args)

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
        padded.  Returns (device row tuple, host stream lengths, host
        local-end matrix: None here; the sharded programs fill it)."""
        e = self.engine
        *rows, slen = self._run("sgather", _sched_gather, e.offsets, e.pdoc,
                                e.pimp, e.pscore, self._dev(qt),
                                cap=e.cfg.stream_cap, bounds_p=self.bounds_p,
                                n_docs=e.n_docs)
        return tuple(rows), slen.cpu().numpy(), None

    @staticmethod
    def _n_real(slot_idx: np.ndarray, slots: int) -> int:
        """The refill group's real slots: entries equal to the table's
        capacity are its padding, which must trail the real ones."""
        n = int((slot_idx < slots).sum())
        if (slot_idx[n:] < slots).any():
            raise ValueError("refill padding must trail the real slots")
        return n

    def refill(self, state: SchedState, slot_idx: np.ndarray,
               rows) -> SchedState:
        """Install gathered rows at ``slot_idx`` and zero their
        accumulator rows.  Entries equal to the table's capacity are the
        group's padding; they trail the real ones (checked here) and
        their rows are dropped on the device, so every refill has the
        group's shapes."""
        self._n_real(slot_idx, state.acc.shape[0])
        idx = self._dev(slot_idx.astype(np.int64))
        out = self._run("refill", _sched_refill, state.ds, state.im,
                        state.seg_lo, state.seg_hi, state.sdocs, state.s3,
                        state.acc, idx, *rows)
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
        """Build all four programs.  Safe mid-flight: they run on a
        scratch table, the dummy refill is all padding and the dummy
        chunk runs at rho 0, and a program hands back copies of its
        outputs, so no live state is touched.  Returns the programs
        built."""
        e = self.engine
        before = e._programs.built()
        g = self.grain
        state = self.init_state(slots, query_len)
        rows, _, _ = self.gather(np.full((g, query_len), -1, np.int32))
        state = self.refill(state, np.full(g, slots, np.int32), rows)
        zeros = np.zeros(slots, np.int32)
        state = self.chunk(state, zeros, zeros)
        self.finalize(state, np.zeros(g, np.int32), np.ones(g, np.int32),
                      np.ones(g, np.int32), np.zeros(g, np.int32))
        return e._programs.built() - before


# --------------------------------------- sharded scheduler stage bodies --
# The four programs of ``ShardedSchedPrograms``: the slot table over the
# doc-range-partitioned streams.  Each slot's posting stream is the
# ``shard_cap``-wide local stream of ``partition_postings``; a chunk
# window advances a local cursor, and the global rho budget applies
# through the stored global stream positions, as on the batch-once
# sharded path.  As the sharded engine's stages, each takes a flat
# tuple of tensors, a fixed number a shard (one data group: the
# scheduler runs on a model-only mesh), and its geometry by keyword.

def _ssched_gather(*flat, los: tuple, cap: int, shard_cap: int,
                   block_p: int, width: int, slack: float):
    """Per shard: offsets, pdoc, pimp, pscore, the refill group's query
    rows and the budget grid (the index and the grid are the program's
    constants) -> the eight partitioned slot rows, then one host
    metadata matrix (one read):
    column 0 the global stream length, column 1 the partition overflow
    (max over shards), columns 2.. the worst shard's local stream end
    ``max_s count(gpos_s < min(w, slen))`` for every budget ``w`` of the
    static grid."""
    pos = _nest(flat, 1, 6)[0]
    rows, over, slen = _sh_gather([p[:5] for p in pos], los, cap=cap,
                                  shard_cap=shard_cap, block_p=block_p,
                                  width=width, slack=slack)
    lend = []
    for r, p in zip(rows, pos):
        wvec = p[5]
        with device_scope(wvec.device):
            endw = torch.minimum(wvec[None, :],
                                 slen.to(wvec.device)[:, None])
            lend.append((r[4][:, None, :] < endw[:, :, None]).sum(dim=-1)
                        .to(torch.int32))
    meta = torch.cat([slen[:, None], over[0][:, None],
                      collectives.pmax(lend)[0]], dim=1)
    return tuple(t for r in rows for t in r) + (meta,)


def _ssched_refill(*flat):
    """Per shard: the nine slot-table buffers (ds, im, seg_lo, seg_hi,
    gpos, sdocs, s3, sterm, acc), the slot indices and the eight gathered
    rows -> the nine new buffers (``_install``: padding entries
    dropped)."""
    out, shards = [], _nest(flat, 1, 18)[0]
    for i in range(len(shards)):
        p = shards[i]
        with device_scope(p[0].device):
            out += _install(p[:8], p[8], p[9], p[10:])
    return tuple(out)


def _ssched_chunk(ds_b, im_b, lo_b, hi_b, gp_b, acc, pos, end, *,
                  chunk_p: int, bounds_p: int, width: int, block_d: int):
    """One resumable stage-1 step over one shard's partitioned slot table.

    ``pos`` is the per-slot local chunk cursor (multiples of
    ``chunk_p``), ``end`` the per-slot global rho budget.  The window's
    admitted postings are those with ``gpos < end``, a prefix of the
    window since gpos increases along the local stream, so their count
    is the window's rho.  A shard whose local stream ended before
    ``pos`` counts 0 and adds exact zeros, so slots retire at the worst
    shard's end."""
    lc = ds_b.shape[-1]
    pos = pos.long()
    ar = torch.arange(chunk_p, dtype=torch.int64, device=ds_b.device)
    idx = (pos[:, None] + ar[None, :]).clamp(max=lc - 1)
    ds, im, gp = ds_b.gather(1, idx), im_b.gather(1, idx), gp_b.gather(1, idx)
    rho_rem = (gp < end[:, None]).sum(dim=-1).to(torch.int32)
    nb = chunk_p // bounds_p
    bidx = (pos[:, None] // bounds_p
            + torch.arange(nb, dtype=torch.int64, device=ds_b.device)[None])
    bidx = bidx.clamp(max=lo_b.shape[-1] - 1)
    seg = (lo_b.gather(1, bidx), hi_b.gather(1, bidx))
    inc = jass.saat_scores_masked(ds, im, rho_rem, width, use_kernel=True,
                                  seg_bounds=seg, block_p=bounds_p,
                                  block_d=block_d)
    return acc + inc


def _ssched_chunks(*flat, chunk_p: int, bounds_p: int, width: int,
                   block_d: int):
    """Per shard: ds, im, seg_lo, seg_hi, gpos, acc, the local cursors
    and the global budgets -> the shard's new accumulator."""
    out, shards = [], _nest(flat, 1, 8)[0]
    for i in range(len(shards)):
        with device_scope(shards[i][0].device):
            out.append(_ssched_chunk(*shards[i], chunk_p=chunk_p,
                                     bounds_p=bounds_p, width=width,
                                     block_d=block_d))
    return tuple(out)


def _ssched_finalize(*flat, los: tuple, width: int, n_docs: int,
                     n_terms: int, depth: int, pool_depth: int,
                     masked: bool):
    """The batch-once sharded tail on a retiring group's slot rows.  Per
    shard: acc, sdocs, s3, sterm, the slot indices, the reranking depth
    vector, qids, doc_len (a constant) and, when ``masked`` (the k
    knob), the pool width vector -> (the group's ranked lists,): each
    shard's survivors, the merge, stage 2 on the partitioned score rows,
    the rerank."""
    pos = _nest(flat, 1, 9 if masked else 8)[0]

    def rows(j):
        return [p[j].index_select(0, p[4]) for p in pos]

    surv = _sh_survivors(rows(0), los, min(pool_depth, width))
    vflat, gflat = collectives.gather_local_topk(*zip(*surv))
    pools = _sh_merge(vflat, gflat, [p[8] for p in pos] if masked else None,
                      depth=pool_depth)
    stage2 = _sh_stage2([(sd, s3, st, p[7], p[6]) for sd, s3, st, p in zip(
        rows(1), rows(2), rows(3), pos)], los, width=width, n_docs=n_docs,
        n_terms=n_terms)
    return (_sh_rerank(stage2, pools, [p[5] for p in pos], los, width=width,
                       depth=depth),)


class ShardedSchedPrograms(SchedPrograms):
    """``SchedPrograms`` over a ``ShardedServingEngine``'s partitioned
    streams: the same four stages through the engine's program cache
    (as the JAX scheduler compiles its four shard_map programs), every
    ``SchedState`` field a tuple over the shards, chunk windows
    advancing over the ``shard_cap``-wide local streams (a chunk reads
    ~1/n_shards of the postings).  The shards' index tensors, their
    ``doc_len`` slices and the budget grids are the programs'
    constants.

    Retirement needs one more host fact: the worst shard's local stream
    end for the slot's budget.  The gather computes it for every budget
    of a static grid (``widths``: the cutoffs, the stream cap, and any
    ``extra_widths`` such as the fixed arm's) and ships it with the
    stream lengths in one host read; ``lend_col`` indexes it.

    Bit-identity: each slot's accumulator rows get the batch-once
    sharded engine's adds (the same partitioned streams, window masks
    that sum to the same admitted postings), and finalize runs the
    batch-once sharded tail on the slot rows.  Only a model-only mesh
    (one data group) is supported.
    """

    sharded = True

    def __init__(self, engine: ServingEngine, *, grain: int,
                 chunk_p: int | None = None, extra_widths=()):
        if not isinstance(engine, ShardedServingEngine):
            raise TypeError("ShardedSchedPrograms needs a "
                            "ShardedServingEngine; use SchedPrograms "
                            "(or for_engine) for the unsharded engine")
        if not engine.supports_continuous:
            raise TypeError("ShardedSchedPrograms: "
                            + engine.continuous_unsupported_reason)
        super().__init__(engine, grain=grain, chunk_p=chunk_p)
        cap = engine.cfg.stream_cap
        ws = {min(int(c), cap) for c in engine.cfg.cutoffs} | {cap}
        ws |= {min(int(w), cap) for w in extra_widths}
        self.widths = tuple(sorted(ws))
        self.width_col = {w: i for i, w in enumerate(self.widths)}
        self.shards = engine.groups[0]
        self._wvecs = engine.budget_grid(self.widths)
        self._n_terms = 0              # the query width, set by init_state

    def _slot_cap(self, engine: ServingEngine) -> int:
        return engine.shard_cap

    def lend_col(self, width: int) -> int:
        """Column of the gather's local-end matrix for a slot whose
        global budget is ``min(width, stream length)``."""
        return self.width_col[min(int(width), self.engine.cfg.stream_cap)]

    def _devs(self, a: np.ndarray) -> list[torch.Tensor]:
        """A small host array on each shard's device."""
        return collectives.per_device(
            [sh.device for sh in self.shards],
            lambda i: _h2d(a, self.shards[i].device))

    def init_state(self, slots: int, query_len: int) -> SchedState:
        """Fresh slot table over the partitioned layout, one tensor a
        shard in every field: gpos padded at the stream-cap sentinel
        (never below a budget), local segment bounds at the local empty
        interval (shard_width, -1)."""
        e = self.engine
        lc, w = e.shard_cap, e.shard_width
        nb = lc // self.bounds_p
        lp = partition_cap(query_len * e.cfg.stream_cap, e.n_shards,
                           e.cfg.partition_slack)
        self._n_terms = query_len
        cols = {k: [] for k in ("ds", "im", "seg_lo", "seg_hi", "sdocs",
                                "s3", "acc", "gpos", "sterm")}
        for sh in self.shards:
            d = sh.device

            def full(shape, v, dt=torch.int32, d=d):
                return torch.full(shape, v, dtype=dt, device=d)

            cols["ds"].append(full((slots, lc), -1))
            cols["im"].append(full((slots, lc), -1.0, torch.float32))
            cols["seg_lo"].append(full((slots, nb), w))
            cols["seg_hi"].append(full((slots, nb), -1))
            cols["sdocs"].append(full((slots, lp), -1))
            cols["s3"].append(full((slots, lp, 3), 0.0, e.pscore.dtype))
            cols["acc"].append(full((slots, w), 0.0, torch.float32))
            cols["gpos"].append(full((slots, lc), e.cfg.stream_cap))
            cols["sterm"].append(full((slots, lp), query_len))
        return SchedState(**{k: tuple(v) for k, v in cols.items()})

    def gather(self, qt: np.ndarray):
        """Partitioned slot rows and the one host read of the metadata:
        returns (per-shard row tuples, global stream lengths, (G, W)
        local-end matrix indexed by ``lend_col``).  Raises on partition
        overflow."""
        e = self.engine
        *rows, meta = self._run(
            "sgather", _ssched_gather, *_flat(
                [[sh.index for sh in self.shards]], [self._devs(qt)],
                [self._wvecs]),
            consts=tuple(self._wvecs), los=e._los, cap=e.cfg.stream_cap,
            shard_cap=e.shard_cap, block_p=self.bounds_p,
            width=e.shard_width, slack=e.cfg.partition_slack)
        m = meta.cpu().numpy()
        e.check_overflow(int(m[:, 1].max()))
        return [r for r in _nest(tuple(rows), 1, 8)[0]], m[:, 0], m[:, 2:]

    def refill(self, state: SchedState, slot_idx: np.ndarray,
               rows) -> SchedState:
        """``SchedPrograms.refill`` on every shard, the group's whole
        slot index at one shape (rows in the gather's order: ds, im,
        seg_lo, seg_hi, gpos, sdocs, s3, sterm)."""
        self._n_real(slot_idx, state.acc[0].shape[0])
        names = ("ds", "im", "seg_lo", "seg_hi", "gpos", "sdocs", "s3",
                 "sterm", "acc")
        bufs = [tuple(getattr(state, k)[i] for k in names)
                for i in range(len(self.shards))]
        out = self._run("refill", _ssched_refill, *_flat(
            [bufs], [self._devs(slot_idx.astype(np.int64))], [list(rows)]))
        cols = zip(*_nest(out, 1, 9)[0])
        return SchedState(**dict(zip(names, cols)))

    def chunk(self, state: SchedState, pos: np.ndarray,
              end: np.ndarray) -> SchedState:
        """Advance every active slot by one local chunk window (``pos``
        the local cursor, ``end`` the global rho budget)."""
        e = self.engine
        bufs = list(zip(state.ds, state.im, state.seg_lo, state.seg_hi,
                        state.gpos, state.acc))
        acc = self._run("chunk", _ssched_chunks, *_flat(
            [bufs], [self._devs(pos)], [self._devs(end)]),
            chunk_p=self.chunk_p, bounds_p=self.bounds_p,
            width=e.shard_width, block_d=e.block_d)
        return dataclasses.replace(state, acc=tuple(acc))

    def finalize(self, state: SchedState, slot_idx: np.ndarray,
                 pvec: np.ndarray, dvec: np.ndarray,
                 qids: np.ndarray) -> np.ndarray:
        """The batch-once sharded tail on a retiring group's slot rows.
        Returns host ranked lists (grain, rerank_depth)."""
        e = self.engine
        cfg = e.cfg
        rho = cfg.knob == "rho"
        cols = [list(zip(state.acc, state.sdocs, state.s3, state.sterm)),
                self._devs(slot_idx.astype(np.int64)), self._devs(dvec),
                self._devs(qids), [sh.doc_len for sh in self.shards]]
        if not rho:
            cols.append(self._devs(pvec))
        r = self._run("finalize", _ssched_finalize,
                      *_flat(*([c] for c in cols)), los=e._los,
                      width=e.shard_width, n_docs=e.n_docs,
                      n_terms=self._n_terms, depth=cfg.rerank_depth,
                      pool_depth=cfg.rerank_depth if rho else e.max_k,
                      masked=not rho)[0]
        return _pad_ranked(r.cpu().numpy(), cfg.rerank_depth)
