"""The impact-ordered inverted index, built on the host.

Per posting the three scorers' float32 scores (BM25 k1 0.9 b 0.4,
Dirichlet LM mu 2500, the paper's TF x IDF), a BM25 impact quantized to
8 bits over the collection's range, and postings sorted by (term,
impact descending, doc); per term the 9 statistics of each scorer's
scores (Table 1) and the collection and document frequencies.  The
scorers round to float32 where the recipe does and take their
logarithms from CPU PyTorch, so the quantized impacts are the recipe's
to the bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.corpus import Corpus


@dataclass
class Index:
    offsets: np.ndarray    # (vocab + 1,) int64 CSR offsets
    doc: np.ndarray        # (nnz,) int32, impact-descending within a term
    impact: np.ndarray     # (nnz,) uint8
    score: np.ndarray      # (nnz, 3) float32: bm25, lm, tfidf
    stats: np.ndarray      # (vocab, 3, 9) float32
    ctf: np.ndarray        # (vocab,) float32
    df: np.ndarray         # (vocab,) float32
    doc_len: np.ndarray    # (n_docs,) int32

    @property
    def n_docs(self) -> int:
        return self.doc_len.shape[0]

    def stream_len(self, terms: np.ndarray, cap: int) -> np.ndarray:
        """Postings each query's merged stream holds: min(cap, sum of the
        terms' postings, each term's capped at cap)."""
        df = np.diff(self.offsets)
        per = np.where(terms >= 0, np.minimum(df[np.maximum(terms, 0)], cap),
                       0)
        return np.minimum(per.sum(axis=1), cap)

    def tensors(self, device) -> dict:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return dict(offsets=put(self.offsets), doc=put(self.doc),
                    impact=put(self.impact.astype(np.float32)),
                    score=put(self.score), stats=put(self.stats),
                    ctf=put(self.ctf), df=put(self.df),
                    doc_len=put(self.doc_len))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _scores(tf, df, ctf, dlen, n_docs, total, avg, k1=0.9, b=0.4,
            mu=2500.0):
    bm25 = (torch.log(_f32((n_docs - df + 0.5) / (df + 0.5)))
            * _f32(tf * (k1 + 1.0))
            / _f32(tf + k1 * ((1.0 - b) + b * dlen / avg)))
    lm = torch.log(_f32((tf + mu * (ctf / total)) / (dlen + mu)))
    tfidf = (_f32(1.0 / dlen) * (1.0 + torch.log(_f32(tf)))
             * torch.log(_f32(1.0 + n_docs / df)))
    return np.stack([bm25.numpy(), lm.numpy(), tfidf.numpy()], axis=-1)


def _quantile(s, offsets, q):
    lens = np.diff(offsets)
    idx = offsets[:-1] + np.floor(q * np.maximum(lens - 1, 0)).astype(
        np.int64)
    idx = np.minimum(idx, np.maximum(offsets[1:] - 1, 0))
    out = s[np.minimum(idx, len(s) - 1)]
    return np.where(lens > 0, out, 0.0).astype(np.float32)


def _term_stats(scores, term_of, vocab):
    """max, q1, q3, min, mean, harmonic mean, median, variance, IQR of one
    scorer's scores per term (float64 sums, float32 result)."""
    order = np.lexsort((scores, term_of))
    s = scores[order].astype(np.float64)
    t = term_of[order]
    counts = np.bincount(t, minlength=vocab).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n = np.maximum(counts, 1)
    mean = np.bincount(t, weights=s, minlength=vocab) / n
    var = np.maximum(np.bincount(t, weights=s * s, minlength=vocab) / n
                     - mean ** 2, 0.0)
    shift = 1.0 - s.min()
    inv = np.bincount(t, weights=1.0 / (s + shift), minlength=vocab)
    hmean = n / np.maximum(inv, 1e-12) - shift
    q = {v: _quantile(s, offsets, v) for v in (1.0, 0.25, 0.75, 0.0, 0.5)}
    out = np.stack([q[1.0], q[0.25], q[0.75], q[0.0], mean, hmean, q[0.5],
                    var, q[0.75] - q[0.25]], axis=-1).astype(np.float32)
    out[counts == 0] = 0.0
    return out


def build_index(corpus: Corpus) -> Index:
    vocab = corpus.vocab
    term_of = corpus.term_ids.astype(np.int64)
    tf = corpus.counts.astype(np.float64)
    dlen = corpus.doc_len[corpus.doc_ids].astype(np.float64)
    df_all = np.bincount(term_of, minlength=vocab).astype(np.float64)
    ctf_all = np.bincount(term_of, weights=tf, minlength=vocab)
    scores = _scores(tf, df_all[term_of], ctf_all[term_of], dlen,
                     corpus.n_docs, float(corpus.doc_len.sum()),
                     float(corpus.doc_len.mean()))
    stats = np.stack([_term_stats(scores[:, i], term_of, vocab)
                      for i in range(3)], axis=1)
    bm25 = scores[:, 0]
    lo, hi = float(bm25.min()), float(bm25.max())
    impact = np.round((bm25 - lo) / max(hi - lo, 1e-9) * 255).astype(
        np.uint8)
    order = np.lexsort((corpus.doc_ids, -impact.astype(np.int32), term_of))
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(term_of, minlength=vocab))]).astype(
            np.int64)
    return Index(offsets=offsets, doc=corpus.doc_ids[order],
                 impact=impact[order], score=scores[order], stats=stats,
                 ctf=ctf_all.astype(np.float32),
                 df=df_all.astype(np.float32), doc_len=corpus.doc_len)
