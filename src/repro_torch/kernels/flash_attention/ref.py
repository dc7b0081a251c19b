"""Plain-torch oracle for the flash-attention kernel."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_ref_bshd", "NEG_INF"]

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


def _fold_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B*Hkv*g, S, hd), each KV head repeated for its
    g query heads (the JAX wrapper's ``broadcast_to`` + ``reshape``)."""
    b, s, hkv, hd = x.shape
    xf = x.transpose(1, 2)                            # (B, Hkv, S, hd)
    if g > 1:
        xf = xf[:, :, None].expand(b, hkv, g, s, hd)
    return xf.reshape(b * hkv * g, s, hd)


def attention_ref_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True,
                       window: int | None = None) -> torch.Tensor:
    """The model layout through the fold, as the JAX wrapper does it.
    q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> a contiguous
    (B, S, Hq, hd)."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    of = attention_ref(q.transpose(1, 2).reshape(b * hq, s, hd),
                       _fold_kv(k, g), _fold_kv(v, g), causal=causal,
                       window=window)
    return of.reshape(b, hq, s, hd).transpose(1, 2).contiguous()
