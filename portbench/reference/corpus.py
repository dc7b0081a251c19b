"""Synthetic corpus and query log, made from a seed.

Zipf term frequencies, log-normal document lengths, queries of 1-5
terms drawn from the mid-frequency band (a frozen copy of the recipe of
``src/repro_torch/retrieval/corpus.py``).  Host NumPy throughout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Corpus:
    """Bag-of-words corpus in doc-major sorted COO form."""

    n_docs: int
    vocab: int
    doc_ids: np.ndarray    # (nnz,) int32, sorted
    term_ids: np.ndarray   # (nnz,) int32
    counts: np.ndarray     # (nnz,) int32
    doc_len: np.ndarray    # (n_docs,) int32, tokens with repeats


def make_corpus(n_docs: int, vocab: int, *, mean_doc_len: float,
                sigma_doc_len: float, zipf_s: float, seed) -> Corpus:
    rng = np.random.default_rng(seed)
    mu = np.log(mean_doc_len) - 0.5 * sigma_doc_len ** 2
    doc_len = np.maximum(
        rng.lognormal(mu, sigma_doc_len, n_docs).astype(np.int64), 8)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_s)
    probs /= probs.sum()
    tokens = rng.choice(vocab, size=int(doc_len.sum()), p=probs)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), doc_len)
    uniq, counts = np.unique(doc_of * vocab + tokens, return_counts=True)
    return Corpus(n_docs=n_docs, vocab=vocab,
                  doc_ids=(uniq // vocab).astype(np.int32),
                  term_ids=(uniq % vocab).astype(np.int32),
                  counts=counts.astype(np.int32),
                  doc_len=doc_len.astype(np.int32))


def make_queries(corpus: Corpus, n_queries: int, *, max_len: int,
                 seed) -> np.ndarray:
    """(n_queries, max_len) int32 query terms, -1 padded.  Terms are drawn
    with weight df^0.35 from the terms present, the most frequent 0.5%
    (the stop-word band) left out; a query's length is geometric."""
    rng = np.random.default_rng(seed)
    df = np.bincount(corpus.term_ids, minlength=corpus.vocab)
    present = np.flatnonzero(df > 0)
    order = np.argsort(-df[present])
    band = present[order[max(1, len(present) // 200):]]
    w = df[band].astype(np.float64) ** 0.35
    w /= w.sum()
    lengths = np.clip(rng.geometric(0.45, n_queries), 1, max_len)
    terms = np.full((n_queries, max_len), -1, dtype=np.int32)
    flat = rng.choice(band, size=int(lengths.sum()), p=w).astype(np.int32)
    pos = 0
    for i, n in enumerate(lengths):
        u = np.unique(flat[pos:pos + n])
        terms[i, :len(u)] = u
        pos += n
    return terms
