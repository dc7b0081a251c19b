"""Attention core of the port: ``chunked_attention`` through the
flash-attention kernel, and ``repeat_kv``.

The JAX package's ``models/attention.py:chunked_attention`` is the oracle
of its Pallas ``flash_attention`` kernel: it tiles the same masked
softmax attention three ways, to bound the live score buffer.

* window branch: each query block sees a static slice of W + block_q
  keys, masked by 0 <= q - k < window.  The mask is causal whatever
  ``causal`` says.
* unrolled causal branch: query block i sees keys [0, (i+1) block_q),
  masked by k <= q.
* plain branch: every query block sees every key, masked by k <= q when
  ``causal``.

Here each branch is one call of the port's ``flash_attention`` with that
branch's masks: the kernel tiles the keys itself and never loads a tile
no query of its block can reach, which is what the slicing and the block
skipping do on the TPU.  On a CUDA tensor the CUDA kernel runs, on a CPU
tensor its plain version (``attention_ref``).  Under autograd the call
goes through ``ops.FlashAttention``: the same kernel forward, and a
backward of explicit torch ops that recomputes the probabilities, as the
JAX package's checkpointed blocks do.  ``use_kernel=False`` runs the
plain oracle under autograd instead (the reference of the tests and of
the card's gradient check).  ``decode_attention`` and value heads wider
than the query heads (MLA) are not ported.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

__all__ = ["chunked_attention", "repeat_kv"]


def repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd)."""
    if groups == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, groups, d) \
        .reshape(b, s, h * groups, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      use_kernel: bool = True) -> torch.Tensor:
    """Grouped attention.  q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) with
    Hq % Hkv == 0.  Returns (B, S, Hq, hd)."""
    if v.shape[-1] != q.shape[-1]:
        raise ValueError(f"value head dim {v.shape[-1]} differs from the "
                         f"query head dim {q.shape[-1]}; the kernel takes "
                         "one head dim")
    if window is not None:
        return fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                      use_kernel=use_kernel)
    return fa_ops.flash_attention(q, k, v, causal=causal,
                                  use_kernel=use_kernel)
