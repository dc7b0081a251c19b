"""Maximized Effectiveness Difference (MED), Tan & Clarke (TKDE 2015).

MED_M(A, B) is the largest |M(A) - M(B)| over relevance assignments
consistent with the unjudged documents of two ranked lists.  Ranked
lists are int32 doc-id tensors padded with -1, batched over a leading
query axis.  For RBP and DCG (binary gains)

    MED = max( sum_d max(0, w_A(d) - w_B(d)),  sum_d max(0, w_B(d) - w_A(d)) )

and ERR and AP (``med_map``) use the diff-set greedy assignment, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rank_in", "med_rbp", "med_dcg", "med_err", "med_map",
           "med_all", "rbp_weights", "dcg_weights"]

PAD = -1


def rank_in(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each doc id in ``a`` its 0-based rank in ``b``, or -1.

    a: (Q, Da), b: (Q, Db), both -1 padded.  Sort + searchsorted."""
    db = b.shape[-1]
    b_sorted, order = torch.sort(b, dim=-1, stable=True)
    pos = torch.searchsorted(b_sorted.contiguous(), a.contiguous())
    pos = pos.clamp(0, db - 1)
    hit = (b_sorted.gather(-1, pos) == a) & (a != PAD)
    return torch.where(hit, order.gather(-1, pos), torch.full_like(pos, -1))


def rbp_weights(depth: int, p: float, device=None) -> torch.Tensor:
    """RBP positional weights (1-p) * p^i, computed in float64 on the
    host and cast once to float32: both lists' weight tables must be
    bit-identical prefixes of one series, or MED(A, A) = 0 breaks."""
    i = np.arange(depth, dtype=np.float64)
    w = ((1.0 - p) * np.power(p, i)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def dcg_weights(depth: int, eval_depth: int, device=None) -> torch.Tensor:
    """DCG positional weights 1/log2(i+2), zero past the evaluation depth
    (host float64, cast once to float32)."""
    i = np.arange(depth, dtype=np.float64)
    w = 1.0 / np.log2(i + 2.0)
    return torch.from_numpy(
        np.where(i < eval_depth, w, 0.0).astype(np.float32)).to(device)


def _one_sided(a, b, w_a, w_b) -> torch.Tensor:
    """sum over docs d in a of max(0, w_a(rank_a(d)) - w_b(rank_b(d)))."""
    rb = rank_in(a, b)
    wa = torch.where(a != PAD, w_a[None, :], torch.zeros((), device=a.device))
    wb = torch.where(rb >= 0, w_b[rb.clamp(min=0)],
                     torch.zeros((), device=a.device))
    return torch.clamp(wa - wb, min=0.0).sum(dim=-1)


def _med_separable(a, b, w_a, w_b) -> torch.Tensor:
    return torch.maximum(_one_sided(a, b, w_a, w_b),
                         _one_sided(b, a, w_b, w_a))


def med_rbp(a: torch.Tensor, b: torch.Tensor, p: float = 0.95) -> torch.Tensor:
    """MED under rank-biased precision.  a: (Q, Da), b: (Q, Db) -> (Q,)."""
    wa = rbp_weights(a.shape[-1], p, a.device)
    wb = rbp_weights(b.shape[-1], p, a.device)
    return _med_separable(a, b, wa, wb)


def med_dcg(a: torch.Tensor, b: torch.Tensor,
            eval_depth: int = 20) -> torch.Tensor:
    """MED under binary-gain DCG evaluated to a fixed depth."""
    wa = dcg_weights(a.shape[-1], eval_depth, a.device)
    wb = dcg_weights(b.shape[-1], eval_depth, a.device)
    return _med_separable(a, b, wa, wb)


def _err_gain(a, in_diff, eval_depth: int, r_max: float) -> torch.Tensor:
    """ERR of list ``a`` when exactly the ``in_diff`` docs have grade
    r_max; the cascade product telescopes over the running diff count."""
    depth = a.shape[-1]
    i = torch.arange(depth, dtype=torch.float32, device=a.device)[None, :]
    active = (in_diff & (a != PAD) & (i < eval_depth)).to(torch.float32)
    prev = torch.cumsum(active, dim=-1) - active
    contrib = (1.0 / (i + 1.0)) * r_max * torch.pow(1.0 - r_max, prev)
    return torch.where(active > 0, contrib,
                       torch.zeros((), device=a.device)).sum(dim=-1)


def med_err(a: torch.Tensor, b: torch.Tensor, eval_depth: int = 20,
            r_max: float = 0.5) -> torch.Tensor:
    """Greedy MED under ERR: grade r_max on the symmetric difference."""

    def one(x, y):
        diff = (rank_in(x, y) < 0) & (x != PAD)
        return _err_gain(x, diff, eval_depth, r_max)

    return torch.maximum(one(a, b), one(b, a))


def med_map(a: torch.Tensor, b: torch.Tensor, n_rel: int = 1) -> torch.Tensor:
    """Greedy MED under (binary) average precision with a fixed relevant-
    set size: the first ``n_rel`` symmetric-difference docs of the
    advantaged list are graded relevant.  Exact for disjoint lists with
    n_rel >= |A|."""

    def ap_gain(x, y):
        i = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
        diff = (rank_in(x, y) < 0) & (x != PAD)
        order = torch.cumsum(diff.to(torch.int32), dim=-1)
        active = diff & (order <= n_rel)
        hits = torch.cumsum(active.to(torch.float32), dim=-1)
        prec = torch.where(active, hits / (i + 1.0),
                           torch.zeros((), device=x.device))
        return prec.sum(dim=-1) / n_rel

    return torch.maximum(ap_gain(a, b), ap_gain(b, a))


def med_all(a: torch.Tensor, b: torch.Tensor, *, p: float = 0.95,
            eval_depth: int = 20) -> dict[str, torch.Tensor]:
    """The MED variants used by the paper, as a dict of (Q,) tensors."""
    return {
        "rbp": med_rbp(a, b, p=p),
        "dcg": med_dcg(a, b, eval_depth=eval_depth),
        "err": med_err(a, b, eval_depth=eval_depth),
        "map": med_map(a, b),
    }
