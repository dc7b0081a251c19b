"""The 70 static pre-retrieval features (paper Tables 1 and 2).

Columns: query length; mean collection frequency of the terms; min and
max document frequency; then per scorer (bm25, lm, tfidf) the min and
the max over the terms of each of the 9 score statistics, the mean and
the harmonic mean of the terms' max scores, and the means of their
median and mean scores.  Means add the terms one at a time in query
order.  Any precision: the lower-precision control runs it in bfloat16.
"""

from __future__ import annotations

import torch

N_FEATURES = 70
_BIG = 1e9


def _mean(x, mask):
    w = torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 2)), x,
                    torch.zeros_like(x))
    s = w[:, 0]
    for t in range(1, w.shape[1]):
        s = s + w[:, t]
    n = mask.sum(dim=1).clamp(min=1).to(x.dtype)
    return s / n.reshape(n.shape + (1,) * (s.dim() - 1))


def _min(x, mask):
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    return torch.where(m, x, torch.full_like(x, _BIG)).amin(dim=1)


def _max(x, mask):
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    return torch.where(m, x, torch.full_like(x, -_BIG)).amax(dim=1)


def features(terms: torch.Tensor, stats: torch.Tensor, ctf: torch.Tensor,
             df: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """terms (Q, L) -1 padded; stats (vocab, 3, 9); ctf, df (vocab,).
    Returns (Q, 70) in ``dtype``."""
    stats, ctf, df = stats.to(dtype), ctf.to(dtype), df.to(dtype)
    mask = terms >= 0
    safe = terms.clamp(min=0).long()
    cols = [mask.sum(dim=1).to(dtype)[:, None],
            _mean(ctf[safe], mask)[:, None],
            _min(df[safe], mask)[:, None],
            _max(df[safe], mask)[:, None]]
    for si in range(3):
        st = stats[safe][:, :, si, :]              # (Q, L, 9)
        smax, smean, smedian = st[..., 0], st[..., 4], st[..., 6]
        shift = 1.0 - stats[:, si, 0].amin()
        inv = _mean(1.0 / (smax + shift), mask)
        cols += [_min(st, mask), _max(st, mask),
                 _mean(smax, mask)[:, None],
                 (1.0 / torch.clamp(inv, min=1e-12) - shift)[:, None],
                 _mean(smedian, mask)[:, None],
                 _mean(smean, mask)[:, None]]
    return torch.cat(cols, dim=1)
