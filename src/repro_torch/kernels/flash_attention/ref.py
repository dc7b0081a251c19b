"""Plain-torch oracle for the flash-attention kernel."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "NEG_INF"]

#: the mask value of the JAX package's kernels (not -inf: a row with
#: every key masked stays finite)
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q, k, v: (BH, S, hd) -> (BH, S, hd); fp32 logits times hd**-0.5,
    masks at -1e30, fp32 softmax, output cast to q's dtype."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)
