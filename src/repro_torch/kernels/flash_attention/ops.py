"""Model-layout wrapper for the flash-attention kernel, differentiable.

Takes (B, S, H, hd) tensors with GQA (Hkv dividing Hq) and routes to the
kernel, which reads them in place through their strides (query head h
reads key/value head h // g, the JAX wrapper's fold without its copies),
or to the oracle, which folds (B, H) into BH as the JAX wrapper does.
Either way the output is a contiguous (B, S, Hq, hd).

Where autograd needs a gradient (grad mode on and an input requiring
grad), the kernel route runs through ``FlashAttention``, a
``torch.autograd.Function``: its forward is the same single kernel
launch, and its backward is ``flash_attention_bwd``, explicit torch ops
from the saved q, k, v and output.  The TPU kernel has no backward
either: the JAX package differentiates its jnp ``chunked_attention``,
whose blocks are checkpointed, so the probabilities are recomputed
there too.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel_mod
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_ref_bshd)

__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttention"]


def _heads_first(x: torch.Tensor, g: int = 1) -> torch.Tensor:
    """(B, S, H, hd) -> float32 (B, H*g, S, hd), head h read by query
    heads h*g .. h*g + g - 1."""
    x = x.to(torch.float32).transpose(1, 2)
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def _group_sum(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, Hq, S, hd) -> (B, Hq/g, S, hd): the g query heads that read one
    key/value head summed back onto it."""
    if g == 1:
        return x
    b, hq, s, hd = x.shape
    return x.reshape(b, hq // g, g, s, hd).sum(dim=2)


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int | None = None):
    """Gradients of ``flash_attention`` at (q, k, v) with output ``o``
    and output gradient ``do``, in float32: P recomputed with the
    forward's masks (-1e30) and scale, ``dV = P^T dO``, ``dS = P * (dO
    V^T - rowsum(dO * O))``, ``dQ = dS K * scale``, ``dK = dS^T Q *
    scale``, each GQA group summed back onto its key/value head.
    Returns dq, dk, dv in the layouts and dtypes of q, k, v."""
    s, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    g = hq // k.shape[2]
    scale = hd ** -0.5
    qf, kf, vf = _heads_first(q), _heads_first(k, g), _heads_first(v, g)
    of, dof = _heads_first(o), _heads_first(do)
    logits = (qf @ kf.transpose(-1, -2)) * scale          # (B, Hq, S, S)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale

    def back(x, like):
        return x.transpose(1, 2).to(like.dtype)

    return (back(dq, q), back(_group_sum(dk, g), k),
            back(_group_sum(dv, g), v))


class FlashAttention(torch.autograd.Function):
    """The kernel's forward (one launch on a CUDA tensor, the plain
    version on a CPU tensor) with ``flash_attention_bwd`` as backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = _kernel_mod.flash_attention_bshd(q, k, v, causal=causal,
                                             window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd).

    ``use_kernel=False`` runs the oracle (differentiable by autograd),
    for the tests; the kernel route launches the CUDA kernel on a CUDA
    tensor and its plain version on a CPU tensor, through
    ``FlashAttention`` where a gradient is needed."""
    if use_kernel:                   # checks the shapes itself
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return _kernel_mod.flash_attention_bshd(q, k, v, causal=causal,
                                                window=window)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv != 0 or v.shape[2] != hkv:
        raise ValueError(f"query heads {hq} must be a multiple of the "
                         f"key/value heads {hkv}, {v.shape[2]}")
    return attention_ref_bshd(q, k, v, causal=causal, window=window)
