"""Model-layout wrapper for the flash-attention kernel.

Takes (B, S, H, hd) tensors with GQA (Hkv dividing Hq), folds (B, H)
into the kernel's BH axis as the JAX wrapper does (K/V broadcast over
each query group), and routes to the kernel or to the oracle.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel_mod
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def _fold_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B*Hkv*g, S, hd), each KV head repeated for its
    g query heads."""
    b, s, hkv, hd = x.shape
    xf = x.transpose(1, 2)                            # (B, Hkv, S, hd)
    if g > 1:
        xf = xf[:, :, None].expand(b, hkv, g, s, hd)
    return xf.reshape(b * hkv * g, s, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd).

    ``use_kernel=False`` runs the oracle, for the tests; the kernel route
    launches the CUDA kernel on a CUDA tensor and its plain version on a
    CPU tensor."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if hq % hkv != 0 or v.shape[2] != hkv:
        raise ValueError(f"query heads {hq} must be a multiple of the "
                         f"key/value heads {hkv}, {v.shape[2]}")
    g = hq // hkv
    qf = q.transpose(1, 2).reshape(b * hq, s, hd)
    kf, vf = _fold_kv(k, g), _fold_kv(v, g)
    if use_kernel:
        of = _kernel_mod.flash_attention_fwd(qf, kf, vf, causal=causal,
                                             window=window)
    else:
        of = attention_ref(qf, kf, vf, causal=causal, window=window)
    return of.reshape(b, hq, s, hd).transpose(1, 2)
