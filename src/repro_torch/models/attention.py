"""Attention cores of the port: ``chunked_attention`` through the
flash-attention kernel (or, for MLA's value heads, plain torch ops by
query block), ``decode_attention`` in plain torch ops, and
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
backward of explicit torch ops that recomputes the probabilities one
block of ``block_q`` query rows at a time, as the JAX package's
checkpointed blocks do.  ``use_kernel=False`` runs the plain oracle
under autograd instead (the reference of the tests and of the card's
gradient check).

A value head dim other than the query head dim (MLA: 192 against 128,
smoke 24 against 16) takes a plain torch path, since the kernel has one
head dim (as the Pallas kernel has; the reference's model path is jnp
there too).  It keeps the reference's rounding points
(``_attend_block``): scores in the input dtype, then float32 times the
scale, the -1e30 bias, a float32 softmax, P cast to V's dtype, then the
product.  It works one query block at a time over the keys that block
can reach (``ops.block_key_range``), so it never holds (B, H, S, S);
under autograd each block is checkpointed, as the reference's are.  In
a layer checkpointed under ``remat="full"`` this costs a third run of
each block, and it is kept: the layer's recompute runs the path under
grad, and without the block checkpoints would save every block's
float32 P, (B, H, S, S) / 2 in all.  On the dry run's DTensors both
paths run on each device's sequence shard of q against whole keys
(``ops._sharded``).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.device import is_dtensor
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


def _attend_block(qb, kb, vb, ok, scale):
    """qb: (B, Hkv, G, bq, hd); kb, vb: (B, Hkv, K, hd/hd_v); ok: (bq, K)
    the live keys, or None.  The reference's rounding points."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb).to(torch.float32) * scale
    if ok is not None:
        s = s + torch.where(ok, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vb.dtype)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, vb)


def _plain_blocked(q, k, v, *, causal: bool, window: int | None,
                   block_q: int, q_offset: int = 0) -> torch.Tensor:
    """Grouped attention of q (B, S, Hq, hd), k (B, Sk, Hkv, hd) and v
    (B, Sk, Hkv, hd_v) by query blocks: (B, S, Hq, hd_v).  q's rows sit
    at positions ``q_offset ..`` of the keys' sequence (Sk = S and 0
    but in the dry run's sequence-parallel shards)."""
    b, s, hq, hd = q.shape
    sk = k.shape[1]
    hkv, hd_v = k.shape[2], v.shape[-1]
    g = hq // hkv
    bq = min(block_q, s)
    scale = hd ** -0.5
    qT = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    grad = torch.is_grad_enabled()
    outs = []
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        k0, k1 = fa_ops.block_key_range(q0 + q_offset, q1 + q_offset, sk,
                                        causal, window)
        ok = fa_ops.block_mask(q0 + q_offset, q1 + q_offset, k0, k1, causal,
                               window, q.device)
        args = (qT[:, :, :, q0:q1], kT[:, :, k0:k1], vT[:, :, k0:k1], ok,
                scale)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if grad else _attend_block(*args))
    out = torch.cat(outs, dim=3)                      # (B, Hkv, G, S, hd_v)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd_v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      block_q: int = 512,
                      use_kernel: bool = True) -> torch.Tensor:
    """Grouped attention.  q: (B, S, Hq, hd); k: (B, S, Hkv, hd); v:
    (B, S, Hkv, hd_v) with Hq % Hkv == 0.  Returns (B, S, Hq, hd_v).  A
    window makes it causal, as the reference's window branch is;
    ``block_q`` is the query block of the backward (and of the plain
    path, taken where hd_v != hd)."""
    if window is not None:
        causal = True
    if v.shape[-1] != q.shape[-1]:
        if is_dtensor(q):
            return fa_ops._sharded(
                q, k, v, causal, window, block_q,
                local=lambda ql, kl, vl, off: _plain_blocked(
                    ql, kl, vl, causal=causal, window=window,
                    block_q=block_q, q_offset=off))
        return _plain_blocked(q, k, v, causal=causal, window=window,
                              block_q=block_q)
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  use_kernel=use_kernel, block_q=block_q)


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
