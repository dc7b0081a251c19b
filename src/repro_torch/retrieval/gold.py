"""Gold-standard runs: the training signal that replaces judgments.

  * k: a seeded multi-signal second-stage reranker over a deep pool
    (``second_stage_scores``); the candidate run at cutoff k is the same
    reranker restricted to the stage-1 top-k pool.
  * rho: exhaustive score-at-a-time evaluation; the candidate run is the
    anytime ranking at rho.
"""

from __future__ import annotations

import torch

from repro_torch.retrieval import jass

__all__ = [
    "second_stage_scores",
    "second_stage_mix",
    "rerank_pool",
    "rank_pool_scores",
    "gold_run_k",
    "candidate_run_k",
    "gold_run_rho",
    "candidate_run_rho",
]

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for 0 <= a, c < 2^32 in int64, split in 16-bit
    halves so no intermediate product leaves the int64 range."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_noise(doc_ids: torch.Tensor, qid: torch.Tensor,
                seed: int) -> torch.Tensor:
    """Deterministic per-(query, doc) pseudo-feature in [0, 1).

    The reference multiplies and xor-shifts in uint32 and relies on
    wrap-around; here the arithmetic is int64 with every product and xor
    masked to 32 bits.  ``doc_ids`` and ``qid`` broadcast."""
    d = doc_ids.to(torch.int64) & _M32
    q = qid.to(torch.int64) & _M32
    h = (_mul32(d, 2654435761) ^ _mul32(q, 40503)) ^ (seed & _M32)
    h = _mul32(h ^ (h >> 15), 2246822519)
    h = h ^ (h >> 13)
    return (h & 0xFFFF).to(torch.float32) / 65536.0


def second_stage_mix(acc_bm25: torch.Tensor, acc_lm: torch.Tensor,
                     acc_tfidf: torch.Tensor, bounds, doc_len: torch.Tensor,
                     qids: torch.Tensor, doc_ids: torch.Tensor, *,
                     seed: int = 11,
                     noise_weight: float = 0.35) -> torch.Tensor:
    """The second-stage mixture with explicit normalization bounds.

    ``bounds`` is ((lo, hi), ...) per accumulator, each (Q, 1): the
    per-query min/max over the full doc axis.  ``doc_ids`` are the ids of
    the columns (the noise hash keys on them).
    """

    def norm(x, lo, hi):
        return (x - lo) / torch.clamp(hi - lo, min=1e-9)

    (b_lo, b_hi), (l_lo, l_hi), (t_lo, t_hi) = bounds
    prior = 1.0 / torch.log(2.0 + doc_len.to(torch.float32))
    noise = _hash_noise(doc_ids[None, :], qids[:, None], seed)
    return (0.45 * norm(acc_bm25, b_lo, b_hi)
            + 0.25 * norm(acc_lm, l_lo, l_hi)
            + 0.15 * norm(acc_tfidf, t_lo, t_hi)
            + 0.05 * prior[None, :] + noise_weight * noise)


def second_stage_scores(acc_bm25: torch.Tensor, acc_lm: torch.Tensor,
                        acc_tfidf: torch.Tensor, doc_len: torch.Tensor,
                        qids: torch.Tensor, *, seed: int = 11,
                        noise_weight: float = 0.35) -> torch.Tensor:
    """Dense second-stage scores for all docs of a query batch.

    acc_*: (Q, n_docs) per-scorer stage-1 accumulators; doc_len: (n_docs,).
    """
    n_docs = acc_bm25.shape[-1]

    def bound(x):
        return (x.amin(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True))

    return second_stage_mix(
        acc_bm25, acc_lm, acc_tfidf,
        (bound(acc_bm25), bound(acc_lm), bound(acc_tfidf)),
        doc_len, qids, torch.arange(n_docs, device=acc_bm25.device),
        seed=seed, noise_weight=noise_weight)


def rerank_pool(stage2: torch.Tensor, pool: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Rank the docs of ``pool`` (Q, P; -1 padded) by second-stage score:
    (Q, min(depth, P)) doc ids, -1 where the pool is exhausted.

    ``jnp.lexsort((p, -s))``: a stable sort on ``p``, then a stable sort
    on ``-s``."""
    valid = pool >= 0
    s = torch.where(valid, stage2.gather(1, pool.clamp(min=0).long()),
                    torch.full(pool.shape, float("-inf"),
                               device=pool.device))
    return rank_pool_scores(s, pool, depth)


def rank_pool_scores(s: torch.Tensor, pool: torch.Tensor,
                     depth: int) -> torch.Tensor:
    """``rerank_pool`` given each pool member's score ``s`` (Q, P; -inf
    where the pool is exhausted): (Q, min(depth, P)) doc ids by score
    descending, ties to the lower doc id, -1 past the live members."""
    by_doc = torch.sort(pool, dim=1, stable=True).indices
    s1, p1 = s.gather(1, by_doc), pool.gather(1, by_doc)
    top = torch.sort(-s1, dim=1, stable=True).indices[:, :depth]
    keep = s1.gather(1, top) > float("-inf")
    return torch.where(keep, p1.gather(1, top),
                       torch.full_like(top, -1)).to(torch.int32)


def gold_run_k(stage2, deep_pool, depth: int) -> torch.Tensor:
    """A = second stage over the deep pool."""
    return rerank_pool(stage2, deep_pool, depth)


def candidate_run_k(stage2, deep_pool, k: int, depth: int) -> torch.Tensor:
    """B_k = second stage over the stage-1 top-k prefix of the pool."""
    pos = torch.arange(deep_pool.shape[-1], device=deep_pool.device)
    prefix = torch.where(pos[None, :] < k, deep_pool,
                         torch.full_like(deep_pool, -1))
    return rerank_pool(stage2, prefix, depth)


def gold_run_rho(doc_stream, impact_stream, n_docs: int, depth: int):
    """Exhaustive score-at-a-time ranking (the exact stage-1 ranking)."""
    return jass.saat_rank(doc_stream, impact_stream, n_docs,
                          doc_stream.shape[-1], depth)


def candidate_run_rho(doc_stream, impact_stream, n_docs: int, rho: int,
                      depth: int):
    """Anytime ranking after processing only the first rho postings."""
    return jass.saat_rank(doc_stream, impact_stream, n_docs, rho, depth)
