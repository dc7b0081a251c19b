"""Attention cores of the port: ``chunked_attention`` through the
flash-attention kernel, ``decode_attention`` in plain torch ops, and
``repeat_kv``.

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
the card's gradient check).  Value heads wider than the query heads
(MLA) are not ported.

``decode_attention`` is one query token against a KV cache.  The JAX
package writes it in jnp (no Pallas kernel), so the port writes it in
torch ops: a grouped product per key/value head, its G query heads
against that head's (B, S, hd) slice of the (B, S, Hkv, hd) cache, read
in place through its strides (a batched product over (B, Hkv) at once
would need the cache copied into (B, Hkv, S, hd) order, a copy of the
whole cache on every step).  The reference's rounding points stay:
scores in the cache dtype, then float32 times hd ** -0.5, the -1e30
mask, a float32 softmax, the probabilities cast to the cache dtype, the
product with V in that dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF

__all__ = ["chunked_attention", "decode_attention", "repeat_kv"]


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One-token grouped attention against a KV cache.

    q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd); valid: (B, S) bool mask
    of the populated cache slots (ring-buffer caches included).  Returns
    (B, 1, Hq, hd_v) in the cache dtype."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    hd_v = v_cache.shape[-1]
    qg = q.reshape(b, hkv, g, hd)
    s = torch.stack([torch.bmm(qg[:, h], k_cache[:, :, h].transpose(1, 2))
                     for h in range(hkv)], dim=1)        # (B, Hkv, G, S)
    s = s.to(torch.float32) * hd ** -0.5
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.stack([torch.bmm(p[:, h], v_cache[:, :, h])
                     for h in range(hkv)], dim=1)        # (B, Hkv, G, hd_v)
    return o.reshape(b, 1, hq, hd_v)
