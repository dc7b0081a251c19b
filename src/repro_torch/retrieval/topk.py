"""Safe-to-k candidate generation: dense scoring plus exact top-k.

The WAND contract (an exact top-k of the stage-1 scorer) realized as
exhaustive quantized accumulation followed by a blocked top-k
(``kernels/topk``) on the serving path.
"""

from __future__ import annotations

import torch

from repro_torch.retrieval import jass

__all__ = ["candidates_topk", "exhaustive_scores", "select_pool"]


def exhaustive_scores(doc_stream, impact_stream, n_docs: int) -> torch.Tensor:
    """Dense stage-1 scores: accumulate the entire stream (rho = P)."""
    return jass.saat_scores(doc_stream, impact_stream, n_docs,
                            doc_stream.shape[-1])


def candidates_topk(doc_stream, impact_stream, n_docs: int,
                    k: int) -> torch.Tensor:
    """Exact top-k candidate pool of the stage-1 scorer: (Q, k) doc ids,
    -1 where fewer than k documents match any query term."""
    scores = exhaustive_scores(doc_stream, impact_stream, n_docs)
    return jass.rank_from_scores(scores, k)


def select_pool(scores: torch.Tensor, depth: int, *,
                use_kernel: bool = False) -> torch.Tensor:
    """Top-``depth`` doc ids of dense (Q, N) scores, -1 where the score is
    not positive: ``jass.rank_from_scores`` semantics, optionally routed
    through the blocked top-k (the CUDA kernel on a CUDA tensor for
    depth <= KP_MAX).  Both break ties toward the lower doc id."""
    if use_kernel:
        from repro_torch.kernels.topk import ops as tk_ops
        vals, idxs = tk_ops.topk_select(scores, depth)
        return torch.where(vals > 0, idxs,
                           torch.full_like(idxs, -1)).to(torch.int32)
    return jass.rank_from_scores(scores, depth)
