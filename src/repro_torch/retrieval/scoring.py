"""Similarity scorers (paper Section 3) in float32.

BM25 (k1 = 0.9, b = 0.4), Dirichlet-smoothed query likelihood (mu =
2500) and the paper's TF x IDF.  ``index.build_index`` hands these
float64 numpy arrays, exactly as the JAX package does; JAX runs with x64
off, so each operand is rounded to float32 where it enters a jnp
operation.
``_f32`` marks those points, so the operation order and the rounding
points are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["CollectionStats", "bm25", "dirichlet_lm", "tfidf", "SCORERS"]


@dataclass(frozen=True)
class CollectionStats:
    """Global statistics needed by the scorers."""

    n_docs: int          # N
    total_terms: float   # |C|
    avg_doc_len: float   # l_avg


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def bm25(tf, df, doc_len, stats: CollectionStats, *, k1: float = 0.9,
         b: float = 0.4) -> torch.Tensor:
    """BM25 = log((N - f_t + .5)/(f_t + .5)) * TF_BM25."""
    idf = torch.log(_f32((stats.n_docs - df + 0.5) / (df + 0.5)))
    denom = tf + k1 * ((1.0 - b) + b * doc_len / stats.avg_doc_len)
    return idf * _f32(tf * (k1 + 1.0)) / _f32(denom)


def dirichlet_lm(tf, ctf, doc_len, stats: CollectionStats, *,
                 mu: float = 2500.0) -> torch.Tensor:
    """log((f_td + mu * C_t/|C|) / (l_d + mu))."""
    prior = ctf / stats.total_terms
    return torch.log(_f32((tf + mu * prior) / (doc_len + mu)))


def tfidf(tf, df, doc_len, stats: CollectionStats) -> torch.Tensor:
    """(1/l_d) * (1 + log f_td) * log(1 + N/f_t)."""
    return (_f32(1.0 / doc_len) * (1.0 + torch.log(_f32(tf)))
            * torch.log(_f32(1.0 + stats.n_docs / df)))


SCORERS = ("bm25", "lm", "tfidf")
