"""Plain-torch oracle: exact top-k with low-index tie-breaking."""

from __future__ import annotations

import torch

__all__ = ["topk_ref"]


def topk_ref(scores: torch.Tensor, k: int):
    """scores: (Q, N) -> (vals (Q, k), idxs (Q, k)), ties to lower index.

    ``jnp.lexsort((arange(n), -s))`` is one stable ascending sort of
    ``-s``.  ``torch.topk`` gives no tie order and is never used here.
    """
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return scores.gather(1, order), order.to(torch.int32)
