"""Score-at-a-time anytime evaluation (JASS; Lin & Trotman 2015).

  1. ``gather_streams``   -- the top-impact prefix of each query term's
     postings merged into one impact-descending stream per query,
  2. ``saat_scores``      -- accumulate the first rho stream entries into
     a dense document accumulator (``saat_scores_masked(use_kernel=True)``
     routes to the ``impact_scan`` kernel with a per-query rho),
  3. ``rank_from_scores`` -- deterministic ranking (ties by doc id).

Every ``clamp(min=0)`` before a gather ports a ``jnp.clip(x, 0)`` of the
reference: in torch, -1 would index the last element.
"""

from __future__ import annotations

import torch

__all__ = ["gather_streams", "saat_scores", "saat_scores_masked",
           "rank_from_scores", "saat_rank", "gather_score_streams",
           "scorer_accumulators", "scorer_accumulators_by_term"]


def _term_postings(offsets, query_terms, cap: int, nnz: int):
    """(Q, L, cap) posting positions of each query term's prefix, their
    validity, with the reference's clips."""
    q = query_terms.clamp(min=0).long()
    start = offsets[q]                                   # (Q, L)
    end = offsets[(query_terms + 1).clamp(min=0).long()]
    end = torch.where(query_terms >= 0, end, start)
    ar = torch.arange(cap, dtype=start.dtype, device=start.device)
    idx = start[..., None] + ar                          # (Q, L, P)
    valid = idx < end[..., None]
    return idx.clamp(0, nnz - 1), valid


def gather_streams(offsets: torch.Tensor, postings_doc: torch.Tensor,
                   postings_impact: torch.Tensor, query_terms: torch.Tensor,
                   cap: int):
    """Per-query impact-descending posting streams.

    offsets: (V+1,) int64 CSR offsets (impact-ordered within term);
    query_terms: (Q, L) int32, -1 padded; cap: stream length P.
    Returns (doc_stream (Q, P) int32, impact_stream (Q, P) f32), padded
    with doc -1 / impact -1 where the stream is exhausted.

    ``jax.lax.top_k`` breaks ties toward the lower position, and that
    order decides which postings fall inside rho: a stable descending
    sort reproduces it (``torch.topk`` does not promise a tie order).
    """
    idx, valid = _term_postings(offsets, query_terms, cap,
                                postings_doc.shape[0])
    docs = torch.where(valid, postings_doc[idx].to(torch.int32),
                       torch.full_like(idx, -1, dtype=torch.int32))
    imps = torch.where(valid, postings_impact[idx].to(torch.float32),
                       torch.full_like(idx, -1.0, dtype=torch.float32))
    qn, ln = query_terms.shape
    docs = docs.reshape(qn, ln * cap)
    imps = imps.reshape(qn, ln * cap)
    top_imps, top_idx = torch.sort(imps, dim=1, descending=True, stable=True)
    top_imps, top_idx = top_imps[:, :cap], top_idx[:, :cap]
    return docs.gather(1, top_idx), top_imps


def _masked_scatter(doc_stream, contrib, n_docs: int) -> torch.Tensor:
    acc = torch.zeros((doc_stream.shape[0], n_docs), dtype=torch.float32,
                      device=doc_stream.device)
    return acc.scatter_add_(1, doc_stream.clamp(min=0).long(), contrib)


def saat_scores(doc_stream: torch.Tensor, impact_stream: torch.Tensor,
                n_docs: int, rho: int) -> torch.Tensor:
    """Accumulate the first ``rho`` postings of each stream: (Q, n_docs)."""
    pos = torch.arange(doc_stream.shape[-1], device=doc_stream.device)
    mask = (pos[None, :] < rho) & (doc_stream >= 0)
    contrib = torch.where(mask, impact_stream, torch.zeros_like(impact_stream))
    return _masked_scatter(doc_stream, contrib, n_docs)


def saat_scores_masked(doc_stream: torch.Tensor, impact_stream: torch.Tensor,
                       rho_vec: torch.Tensor, n_docs: int, *,
                       use_kernel: bool = False, seg_bounds=None,
                       block_p: int = 512, block_d: int = 2048):
    """Accumulate the first ``rho_vec[q]`` postings of each stream.

    ``use_kernel`` routes through ``kernels.impact_scan`` with rho as a
    per-query operand (plus, with ``seg_bounds`` from
    ``index.block_doc_bounds`` at ``block_p``, the segment skips); it
    launches the CUDA kernel on a CUDA tensor.  Otherwise this is plain
    torch, as the JAX package runs jnp here.
    """
    if use_kernel:
        from repro_torch.kernels.impact_scan import ops as is_ops
        return is_ops.saat_accumulate(
            doc_stream, impact_stream, n_docs=n_docs, rho=rho_vec,
            seg_bounds=seg_bounds, block_p=block_p, block_d=block_d)
    pos = torch.arange(doc_stream.shape[-1], device=doc_stream.device)
    mask = (pos[None, :] < rho_vec[:, None]) & (doc_stream >= 0)
    contrib = torch.where(mask, impact_stream, torch.zeros_like(impact_stream))
    return _masked_scatter(doc_stream, contrib, n_docs)


def rank_from_scores(scores: torch.Tensor, depth: int) -> torch.Tensor:
    """Top-``depth`` doc ids, ties broken by ascending doc id; docs with
    a score that is not positive are -1.  ``jnp.lexsort((arange, -s))``
    is one stable sort of ``-s``."""
    top = torch.sort(-scores, dim=1, stable=True).indices[:, :depth]
    keep = scores.gather(1, top) > 0
    return torch.where(keep, top, torch.full_like(top, -1)).to(torch.int32)


def saat_rank(doc_stream, impact_stream, n_docs: int, rho: int,
              depth: int) -> torch.Tensor:
    """Anytime ranking at rho, evaluated to ``depth``."""
    return rank_from_scores(
        saat_scores(doc_stream, impact_stream, n_docs, rho), depth)


def gather_score_streams(offsets: torch.Tensor, postings_doc: torch.Tensor,
                         postings_score: torch.Tensor,
                         query_terms: torch.Tensor, cap: int):
    """Each query's postings with their (bm25, lm, tfidf) scores, in term
    order (unsorted; exhaustive use only).

    Returns (docs (Q, L*cap) int32 -1-padded, scores (Q, L*cap, 3))."""
    idx, valid = _term_postings(offsets, query_terms, cap,
                                postings_doc.shape[0])
    docs = torch.where(valid, postings_doc[idx].to(torch.int32),
                       torch.full_like(idx, -1, dtype=torch.int32))
    scores = torch.where(valid[..., None], postings_score[idx],
                         torch.zeros((), dtype=postings_score.dtype,
                                     device=postings_score.device))
    qn, ln = query_terms.shape
    return docs.reshape(qn, ln * cap), scores.reshape(qn, ln * cap, 3)


def scorer_accumulators(docs: torch.Tensor, scores3: torch.Tensor,
                        n_docs: int, *, n_terms: int):
    """Dense per-scorer accumulators (Q, n_docs) x3 from gathered postings.

    ``docs`` holds ``n_terms`` consecutive per-term segments (the layout
    of ``gather_score_streams``, ``n_terms`` = L).  A doc appears at most
    once in a term's postings, and the reference's scatter adds the terms
    in order, so one scatter per term (no collisions inside a pass) gives
    the reference's float32 sums on the CPU and the same deterministic
    sums on the card, where one scatter would add in atomic order.
    """
    qn, width = docs.shape
    seg = width // n_terms
    w = torch.where((docs >= 0)[..., None], scores3,
                    torch.zeros((), dtype=scores3.dtype,
                                device=scores3.device))
    safe = docs.clamp(min=0).long()
    acc = torch.zeros((qn, n_docs, 3), dtype=torch.float32,
                      device=docs.device)
    for t in range(n_terms):
        cols = slice(t * seg, (t + 1) * seg)
        idx = safe[:, cols, None].expand(-1, -1, 3)
        acc.scatter_add_(1, idx, w[:, cols].to(torch.float32))
    return acc[..., 0], acc[..., 1], acc[..., 2]


def scorer_accumulators_by_term(docs: torch.Tensor, scores3: torch.Tensor,
                                term: torch.Tensor, n_docs: int, *,
                                n_terms: int):
    """``scorer_accumulators`` over a compacted score stream, whose
    postings carry their term index ``term`` (Q, W) instead of sitting in
    fixed per-term segments (``index.partition_scored_postings``).

    One scatter per term, every other term's posting and the padding
    masked to +0.0: no two real adds of one pass meet in one cell, and
    adding +0.0 leaves a cell as it is, so the sums are
    ``scorer_accumulators``' bit for bit on the CPU and on the card.
    """
    qn = docs.shape[0]
    live = docs >= 0
    idx = docs.clamp(min=0).long()[..., None].expand(-1, -1, 3)
    w = scores3.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=docs.device)
    acc = torch.zeros((qn, n_docs, 3), dtype=torch.float32,
                      device=docs.device)
    for t in range(n_terms):
        sel = (live & (term == t))[..., None]
        acc.scatter_add_(1, idx, torch.where(sel, w, zero))
    return acc[..., 0], acc[..., 1], acc[..., 2]
