"""Synthetic corpus + query log (numpy copy of ``repro.retrieval.corpus``).

Host numpy throughout, so the same seed gives byte-identical arrays to
the JAX package's generator: Zipf term frequencies, log-normal document
lengths, queries of 1-5 terms from the mid-frequency band.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CorpusConfig", "Corpus", "QueryLog", "make_corpus", "make_queries"]


@dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 50_000
    vocab: int = 60_000
    mean_doc_len: float = 220.0
    sigma_doc_len: float = 0.6
    zipf_s: float = 1.07
    seed: int = 1742


@dataclass
class Corpus:
    """Bag-of-words corpus in sorted COO form (doc-major)."""

    config: CorpusConfig
    doc_ids: np.ndarray    # (nnz,) int32, sorted
    term_ids: np.ndarray   # (nnz,) int32
    counts: np.ndarray     # (nnz,) int32
    doc_len: np.ndarray    # (n_docs,) int32  (token counts incl. repeats)

    @property
    def n_docs(self) -> int:
        return self.config.n_docs

    @property
    def total_terms(self) -> float:
        return float(self.doc_len.sum())


@dataclass
class QueryLog:
    """Padded query-term matrix: (n_queries, max_len) int32, -1 padded."""

    terms: np.ndarray
    lengths: np.ndarray
    seed: int = 0

    @property
    def n_queries(self) -> int:
        return self.terms.shape[0]

    @property
    def max_len(self) -> int:
        return self.terms.shape[1]


def _zipf_probs(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def make_corpus(config: CorpusConfig = CorpusConfig()) -> Corpus:
    rng = np.random.default_rng(config.seed)
    mu = np.log(config.mean_doc_len) - 0.5 * config.sigma_doc_len**2
    doc_len = np.maximum(
        rng.lognormal(mu, config.sigma_doc_len, config.n_docs).astype(np.int64), 8
    )
    total = int(doc_len.sum())
    # one Zipf draw for the whole token stream, then split by doc
    probs = _zipf_probs(config.vocab, config.zipf_s)
    tokens = rng.choice(config.vocab, size=total, p=probs).astype(np.int64)
    doc_of_token = np.repeat(np.arange(config.n_docs, dtype=np.int64), doc_len)
    key = doc_of_token * config.vocab + tokens
    uniq, counts = np.unique(key, return_counts=True)
    return Corpus(
        config=config,
        doc_ids=(uniq // config.vocab).astype(np.int32),
        term_ids=(uniq % config.vocab).astype(np.int32),
        counts=counts.astype(np.int32),
        doc_len=doc_len.astype(np.int32),
    )


def make_queries(corpus: Corpus, n_queries: int = 40_000, max_len: int = 5,
                 seed: int = 97) -> QueryLog:
    """Draw query terms from the mid-frequency Zipf band actually present."""
    rng = np.random.default_rng(seed)
    vocab = corpus.config.vocab
    df = np.bincount(corpus.term_ids, minlength=vocab)
    present = np.flatnonzero(df > 0)
    # weight ~ df^0.35, the most frequent 0.5% (stopword band) cut away
    order = np.argsort(-df[present])
    band = present[order[max(1, len(present) // 200):]]
    w = df[band].astype(np.float64) ** 0.35
    w /= w.sum()
    lengths = np.clip(rng.geometric(0.45, n_queries), 1, max_len)
    terms = np.full((n_queries, max_len), -1, dtype=np.int32)
    flat = rng.choice(band, size=int(lengths.sum()), p=w).astype(np.int32)
    pos = 0
    for i, L in enumerate(lengths):
        u = np.unique(flat[pos:pos + L])   # may dedupe to fewer than L
        terms[i, :len(u)] = u
        lengths[i] = np.count_nonzero(terms[i] >= 0)
        pos += L
    return QueryLog(terms=terms, lengths=lengths.astype(np.int32), seed=seed)
