"""Static pre-retrieval query features (paper Tables 1 and 2): 70 total.

Computable at query-parse time from index-time term statistics, no
postings traversed.  Layout:

    0      query length
    1      arithmetic mean of C_t over query terms
    2..3   min / max of f_t over query terms
    4..69  per scorer in (bm25, lm, tfidf), 22 features each:
             min over query terms of the 9 Table-1 score stats   (9)
             max over query terms of the 9 Table-1 score stats   (9)
             arithmetic mean of per-term max scores              (1)
             harmonic   mean of per-term max scores              (1)
             arithmetic mean of per-term median scores           (1)
             arithmetic mean of per-term mean scores             (1)

Masked sums run term by term in query order, so the card and the CPU add
in the same order and predict the same classes.
"""

from __future__ import annotations

import torch

__all__ = ["query_features", "N_FEATURES", "feature_names"]

N_FEATURES = 70
_STAT_NAMES = ("max", "q1", "q3", "min", "amean", "hmean", "median", "var", "iqr")
_SCORERS = ("bm25", "lm", "tfidf")

_BIG = 1e9


def feature_names() -> list[str]:
    names = ["query_len", "amean_ctf", "min_df", "max_df"]
    for s in _SCORERS:
        names += [f"{s}/min_{st}" for st in _STAT_NAMES]
        names += [f"{s}/max_{st}" for st in _STAT_NAMES]
        names += [f"{s}/amean_max", f"{s}/hmean_max", f"{s}/amean_median",
                  f"{s}/amean_mean"]
    if len(names) != N_FEATURES:
        raise AssertionError(f"{len(names)} feature names")
    return names


def _expand(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _masked_min(x, mask):
    return torch.where(_expand(mask, x), x,
                       torch.full_like(x, _BIG)).amin(dim=1)


def _masked_max(x, mask):
    return torch.where(_expand(mask, x), x,
                       torch.full_like(x, -_BIG)).amax(dim=1)


def _masked_mean(x, mask):
    """Mean over the term axis (1) of the masked entries."""
    n = mask.sum(dim=1).clamp(min=1)
    w = torch.where(_expand(mask, x), x, torch.zeros_like(x))
    s = w[:, 0]
    for t in range(1, w.shape[1]):
        s = s + w[:, t]
    return s / _expand(n, s)


def query_features(query_terms: torch.Tensor, stats: torch.Tensor,
                   ctf: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """The 70 features for a batch of queries.

    query_terms: (Q, L) int32, -1 padded; stats: (vocab, 3, 9) f32;
    ctf, df: (vocab,) f32.  Returns (Q, 70) f32 on the stats' device.
    """
    q = query_terms.to(stats.device)
    mask = q >= 0                                   # (Q, L)
    safe = q.clamp(min=0).long()
    qlen = mask.sum(dim=1).to(torch.float32)

    t_stats = stats[safe]                           # (Q, L, 3, 9)
    t_ctf = ctf[safe]                               # (Q, L)
    t_df = df[safe]

    cols = [qlen[:, None],
            _masked_mean(t_ctf, mask)[:, None],
            _masked_min(t_df, mask)[:, None],
            _masked_max(t_df, mask)[:, None]]
    for si in range(3):
        blk = t_stats[:, :, si, :]                  # (Q, L, 9)
        cols.append(_masked_min(blk, mask))
        cols.append(_masked_max(blk, mask))
        smax = blk[:, :, 0]
        smedian = blk[:, :, 6]
        smean = blk[:, :, 4]
        # harmonic mean of max scores, shifted positive by a constant of
        # the (fixed) stats table, as the indexer does
        shift = 1.0 - stats[:, si, 0].amin()
        inv = _masked_mean(1.0 / (smax + shift), mask)
        hmean = 1.0 / torch.clamp(inv, min=1e-12) - shift
        cols.append(_masked_mean(smax, mask)[:, None])
        cols.append(hmean[:, None])
        cols.append(_masked_mean(smedian, mask)[:, None])
        cols.append(_masked_mean(smean, mask)[:, None])
    return torch.cat(cols, dim=1).to(torch.float32)
