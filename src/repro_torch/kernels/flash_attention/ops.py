"""Model-layout wrapper for the flash-attention kernel.

Takes (B, S, H, hd) tensors with GQA (Hkv dividing Hq) and routes to the
kernel, which reads them in place through their strides (query head h
reads key/value head h // g, the JAX wrapper's fold without its copies),
or to the oracle, which folds (B, H) into BH as the JAX wrapper does.
Either way the output is a contiguous (B, S, Hq, hd).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel_mod
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd).

    ``use_kernel=False`` runs the oracle, for the tests; the kernel route
    launches the CUDA kernel on a CUDA tensor and its plain version on a
    CPU tensor."""
    if use_kernel:                   # checks the shapes itself
        return _kernel_mod.flash_attention_bshd(q, k, v, causal=causal,
                                                window=window)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv != 0 or v.shape[2] != hkv:
        raise ValueError(f"query heads {hq} must be a multiple of the "
                         f"key/value heads {hkv}, {v.shape[2]}")
    return attention_ref_bshd(q, k, v, causal=causal, window=window)
