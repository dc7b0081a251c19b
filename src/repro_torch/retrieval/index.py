"""Inverted index build: postings, per-term score statistics, impacts.

The build is host numpy (the offline indexer), as in the JAX package; the
returned ``InvertedIndex`` holds torch tensors on the requested device.
``block_doc_bounds`` produces the per-posting-block min/max doc ids that
the ``impact_scan`` kernel uses to skip (posting, doc)-block cells.  The
doc-range ``partition_*`` functions split each query's streams by the
docs a shard owns, for the sharded serving engine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.impact_scan.kernel import posting_blocks
from repro_torch.retrieval import scoring
from repro_torch.retrieval.corpus import Corpus

__all__ = ["InvertedIndex", "TermStats", "build_index", "block_doc_bounds",
           "partition_cap", "partition_postings",
           "partition_scored_postings", "STAT_NAMES"]

#: order of the 9 per-term score statistics (Table 1, items 3-11)
STAT_NAMES = ("max", "q1", "q3", "min", "amean", "hmean", "median", "var", "iqr")


@dataclass
class TermStats:
    """Per-term statistics: stats (vocab, 3, 9) f32 in STAT_NAMES order,
    ctf (vocab,) collection term frequency, df (vocab,) document
    frequency."""

    stats: torch.Tensor
    ctf: torch.Tensor
    df: torch.Tensor


@dataclass
class InvertedIndex:
    """Term-major impact-ordered postings on one device.

    ``doc_len`` and ``n_docs`` live on the index itself (the JAX package
    reads them through ``index.corpus``), so an index carried across
    from numpy arrays (``convert.index_from_numpy``) needs no corpus.
    """

    offsets: torch.Tensor          # (vocab+1,) int64 CSR offsets
    postings_doc: torch.Tensor     # (nnz,) int32, impact-desc within term
    postings_score: torch.Tensor   # (nnz, 3) f32 (bm25, lm, tfidf)
    postings_impact: torch.Tensor  # (nnz,) uint8 quantized bm25 impact
    term_stats: TermStats
    doc_len: torch.Tensor          # (n_docs,) int32
    postings_tf: torch.Tensor | None = None
    impact_scale: tuple[float, float] | None = None
    collection: scoring.CollectionStats | None = None
    corpus: Corpus | None = None

    @property
    def vocab(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.postings_doc.shape[0]

    @property
    def n_docs(self) -> int:
        return self.doc_len.shape[0]

    @property
    def device(self) -> torch.device:
        return self.postings_doc.device

    def postings_of(self, term: int) -> slice:
        """The term's postings as a slice of the CSR arrays (one host
        read of the two offsets)."""
        lo, hi = self.offsets[term:term + 2].tolist()
        return slice(lo, hi)

    def to(self, device) -> "InvertedIndex":
        """A copy of every tensor on ``device``."""
        dev = resolve_device(device)

        def mv(t):
            return None if t is None else t.to(dev)

        return InvertedIndex(
            offsets=mv(self.offsets), postings_doc=mv(self.postings_doc),
            postings_score=mv(self.postings_score),
            postings_impact=mv(self.postings_impact),
            term_stats=TermStats(mv(self.term_stats.stats),
                                 mv(self.term_stats.ctf),
                                 mv(self.term_stats.df)),
            doc_len=mv(self.doc_len), postings_tf=mv(self.postings_tf),
            impact_scale=self.impact_scale, collection=self.collection,
            corpus=self.corpus)


def block_doc_bounds(doc_stream: torch.Tensor, *, block_p: int,
                     n_docs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-posting-block min/max doc id: the impact_scan segment skips.

    doc_stream: (Q, P) int32 impact-ordered doc ids, -1 padded.  Blocks
    follow the kernel's grid (``posting_blocks``).  Blocks that are pure
    padding carry the empty interval ``(n_docs, -1)`` and never run.
    """
    qn, p = doc_stream.shape
    bp, n_p = posting_blocks(p, block_p)
    d = doc_stream
    if n_p * bp != p:
        d = torch.nn.functional.pad(d, (0, n_p * bp - p), value=-1)
    d = d.reshape(qn, n_p, bp)
    lo = torch.where(d >= 0, d, torch.full_like(d, n_docs)).amin(dim=-1)
    hi = d.amax(dim=-1)                 # padding is -1: empty block -> -1
    return lo.to(torch.int32), hi.to(torch.int32)


def partition_cap(cap: int, n_shards: int, slack: float,
                  multiple: int = 8) -> int:
    """Per-shard stream length for a doc-range partition of a ``cap``-long
    stream over ``n_shards`` shards: ``slack * cap / n_shards`` (``slack``
    is the headroom for skew: doc ids are not uniform in an
    impact-ordered stream), aligned up to ``multiple``, never more than
    ``cap`` (one shard is the identity partition).  Overflow past it is
    counted by ``partition_postings`` and raised by the engine."""
    if n_shards <= 1:
        return cap
    raw = int(math.ceil(slack * cap / n_shards))
    raw = -(-max(raw, 1) // multiple) * multiple
    return min(cap, raw)


def _compact(stream: torch.Tensor, lo: int, width: int, cap: int):
    """The order-preserving compaction both partitions share: the j-th
    local column takes the j-th owned entry, found by binary search over
    the running owned count (``searchsorted(cumsum(own), j + 1)``), with
    no sort or scatter.  Returns (source column (Q, cap) int64, P on
    padding; source column clamped for gathers; validity; overflow (Q,)
    int32)."""
    qn, p = stream.shape
    own = (stream >= lo) & (stream < lo + width)
    csum = own.cumsum(dim=-1, dtype=torch.int32)
    j = torch.arange(1, cap + 1, dtype=torch.int32, device=stream.device)
    src = torch.searchsorted(csum, j.expand(qn, cap).contiguous(),
                             side="left")
    valid = j[None, :] <= csum[:, -1:]
    overflow = (csum[:, -1] - cap).clamp(min=0).to(torch.int32)
    return src, src.clamp(max=p - 1), valid, overflow


def partition_postings(doc_stream: torch.Tensor,
                       impact_stream: torch.Tensor, lo: int, *, width: int,
                       cap: int):
    """Doc-range partition of impact-ordered streams: each query's
    postings whose doc lies in ``[lo, lo + width)``, compacted into the
    leading columns of a ``cap``-wide shard-local stream in global
    stream order.

    Returns
      ds_loc: (Q, cap) int32 shard-local doc ids (``doc - lo``), -1 padded
      im_loc: (Q, cap) float32 impacts, -1 padded
      gpos:   (Q, cap) int32 global stream position of each kept posting,
              P on padding: increasing over the kept prefix, so
              ``count(gpos < rho)`` is the shard-local rho
      overflow: (Q,) int32 owned postings dropped past ``cap``
    """
    src, src_c, valid, overflow = _compact(doc_stream, lo, width, cap)
    ds_loc = torch.where(valid, doc_stream.gather(1, src_c) - lo,
                         torch.full_like(src_c, -1, dtype=torch.int32))
    im_loc = torch.where(valid, impact_stream.gather(1, src_c),
                         torch.full_like(src_c, -1.0, dtype=torch.float32))
    gpos = torch.where(valid, src, doc_stream.shape[1]).to(torch.int32)
    return ds_loc.to(torch.int32), im_loc, gpos, overflow


def partition_scored_postings(sdocs: torch.Tensor, s3: torch.Tensor,
                              lo: int, *, width: int, cap: int):
    """Doc-range partition of the stage-2 score streams, by the same
    compaction as ``partition_postings``.

    Returns (sd_loc (Q, cap) int32 local ids -1 padded, s3_loc (Q, cap, 3)
    zero padded, spos (Q, cap) int32 source column, L*P on padding,
    overflow (Q,) int32).  ``spos // P`` is each kept posting's term:
    the stage-2 scatter adds the terms one at a time, so that on the card
    no two adds of one pass meet in one cell (a doc appears at most once
    in a term's postings).  The JAX package returns no ``spos``.
    """
    src, src_c, valid, overflow = _compact(sdocs, lo, width, cap)
    sd_loc = torch.where(valid, sdocs.gather(1, src_c) - lo,
                         torch.full_like(src_c, -1, dtype=torch.int32))
    s3_loc = torch.where(valid[..., None],
                         s3.gather(1, src_c[..., None].expand(-1, -1, 3)),
                         torch.zeros((), dtype=s3.dtype, device=s3.device))
    spos = torch.where(valid, src, sdocs.shape[1]).to(torch.int32)
    return sd_loc.to(torch.int32), s3_loc, spos, overflow


def _segment_quantiles(sorted_vals: np.ndarray, offsets: np.ndarray,
                       q: float) -> np.ndarray:
    """Per-segment quantile over values sorted ascending within segments."""
    lens = np.diff(offsets)
    idx = offsets[:-1] + np.floor(q * np.maximum(lens - 1, 0)).astype(np.int64)
    idx = np.minimum(idx, np.maximum(offsets[1:] - 1, 0))
    out = (sorted_vals[np.minimum(idx, len(sorted_vals) - 1)]
           if len(sorted_vals) else np.zeros_like(lens, dtype=np.float32))
    return np.where(lens > 0, out, 0.0).astype(np.float32)


def _term_statistics(scores: np.ndarray, term_of: np.ndarray,
                     vocab: int) -> np.ndarray:
    """9 stats per term for one scorer's posting scores. O(nnz log nnz)."""
    order = np.lexsort((scores, term_of))
    s = scores[order].astype(np.float64)
    t = term_of[order]
    counts = np.bincount(t, minlength=vocab).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    lens = np.maximum(counts, 1)

    sums = np.bincount(t, weights=s, minlength=vocab)
    sq = np.bincount(t, weights=s * s, minlength=vocab)
    amean = sums / lens
    var = np.maximum(sq / lens - amean**2, 0.0)
    # harmonic mean over (s - global_min + 1): LM scores are negative
    shift = 1.0 - s.min() if len(s) else 1.0
    inv = np.bincount(t, weights=1.0 / (s + shift), minlength=vocab)
    hmean = lens / np.maximum(inv, 1e-12) - shift

    smax = _segment_quantiles(s, offsets, 1.0)
    smin = _segment_quantiles(s, offsets, 0.0)
    q1 = _segment_quantiles(s, offsets, 0.25)
    q3 = _segment_quantiles(s, offsets, 0.75)
    med = _segment_quantiles(s, offsets, 0.5)

    out = np.stack(
        [smax, q1, q3, smin, amean, hmean, med, var, q3 - q1], axis=-1
    ).astype(np.float32)
    out[counts == 0] = 0.0
    return out


def build_index(corpus: Corpus, impact_bits: int = 8, *,
                device=None) -> InvertedIndex:
    """Impact-ordered index of ``corpus``, its tensors on ``device``."""
    dev = resolve_device(device)
    vocab = corpus.config.vocab
    col = scoring.CollectionStats(
        n_docs=corpus.n_docs,
        total_terms=corpus.total_terms,
        avg_doc_len=float(corpus.doc_len.mean()),
    )
    term_of = corpus.term_ids.astype(np.int64)
    tf = corpus.counts.astype(np.float64)
    dlen = corpus.doc_len[corpus.doc_ids].astype(np.float64)
    df_all = np.bincount(term_of, minlength=vocab).astype(np.float64)
    ctf_all = np.bincount(term_of, weights=tf, minlength=vocab)
    df = df_all[term_of]
    ctf = ctf_all[term_of]

    s_bm25 = scoring.bm25(tf, df, dlen, col).numpy()
    s_lm = scoring.dirichlet_lm(tf, ctf, dlen, col).numpy()
    s_tfidf = scoring.tfidf(tf, df, dlen, col).numpy()
    scores = np.stack([s_bm25, s_lm, s_tfidf], axis=-1)

    stats = np.stack(
        [_term_statistics(scores[:, i], term_of, vocab) for i in range(3)],
        axis=1,
    )  # (vocab, 3, 9)

    # impact quantization (JASS): global linear quantizer over bm25 scores
    lo, hi = float(s_bm25.min()), float(s_bm25.max())
    levels = (1 << impact_bits) - 1
    impact = np.round((s_bm25 - lo) / max(hi - lo, 1e-9) * levels)
    impact = impact.astype(np.uint8 if impact_bits <= 8 else np.uint16)

    # impact-ordered layout: sort postings by (term, -impact, doc)
    order = np.lexsort((corpus.doc_ids, -impact.astype(np.int32), term_of))
    counts = np.bincount(term_of, minlength=vocab).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return InvertedIndex(
        offsets=put(offsets),
        postings_doc=put(corpus.doc_ids[order]),
        postings_score=put(scores[order]),
        postings_impact=put(impact[order]),
        term_stats=TermStats(stats=put(stats),
                             ctf=put(ctf_all.astype(np.float32)),
                             df=put(df_all.astype(np.float32))),
        doc_len=put(corpus.doc_len),
        postings_tf=put(corpus.counts[order]),
        impact_scale=(lo, hi),
        collection=col,
        corpus=corpus,
    )
