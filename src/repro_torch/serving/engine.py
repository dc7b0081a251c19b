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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.device import fence, resolve_device
from repro_torch.retrieval import gold, jass
from repro_torch.retrieval import topk as topk_lib
from repro_torch.retrieval.index import block_doc_bounds
from repro_torch.serving import bucketing

__all__ = ["ServingEngine"]


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
