"""Model-layout wrapper for the flash-attention kernel, differentiable.

Takes (B, S, H, hd) tensors with GQA (Hkv dividing Hq) and routes to the
kernel, which reads them in place through their strides (query head h
reads key/value head h // g, the JAX wrapper's fold without its copies),
or to the oracle, which folds (B, H) into BH as the JAX wrapper does.
Either way the output is a contiguous (B, S, Hq, hd).

Where autograd needs a gradient (grad mode on and an input requiring
grad), the kernel route runs through ``FlashAttention``, a
``torch.autograd.Function``: its forward is the same single kernel
launch, and its backward is ``flash_attention_bwd_blocked``, explicit
torch ops from the saved q, k, v and output that recompute the
probabilities one block of ``block_q`` query rows at a time, from the
keys that block can reach (``block_key_range``: ``[0, q_end)`` when
causal, the window's slice when windowed).  Its live scores are at most
(B, Hq, block_q, S) in float32, never (B, Hq, S, S): at tinyllama's
training shape (B 8, Hq 32, S 4096) one whole-matrix float32 tensor is
17.2 GB.  ``flash_attention_bwd`` keeps the whole-matrix form as the
plain version the tests and the card's check hold the blocked one
against.  The TPU kernel has no backward either: the JAX package
differentiates its jnp ``chunked_attention``, whose query blocks are
checkpointed, so the probabilities are recomputed by block there too.

On DTensors (the dry run's) ``flash_attention`` runs the same route on
each device's shards (``_sharded``): sequence-parallel queries against
whole keys, as the reference lays its attention over a mesh, with the
queries placed by the ``attn_q`` hint where it is installed.
"""

from __future__ import annotations

import torch

from repro_torch.device import is_dtensor
from repro_torch.distrib import hints as H
from repro_torch.kernels.flash_attention import kernel as _kernel_mod
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_ref_bshd)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_blocked", "block_key_range", "block_mask",
           "FlashAttention", "backward_events"]


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


def block_key_range(q0: int, q1: int, s: int, causal: bool,
                    window: int | None) -> tuple[int, int]:
    """The keys [k0, k1) that query rows [q0, q1) of S can reach: up to
    the block's last row when causal, from its first row's window
    start when windowed (mask k <= q, q - k < window)."""
    k1 = min(q1, s) if causal else s
    k0 = max(0, q0 - window + 1) if window is not None else 0
    return k0, k1


def block_mask(q0: int, q1: int, k0: int, k1: int, causal: bool,
               window: int | None, device) -> torch.Tensor | None:
    """The live (query, key) pairs of rows [q0, q1) and keys [k0, k1):
    a (q1 - q0, k1 - k0) bool mask, or None where every pair is live (no
    causal mask, no window)."""
    if not causal and window is None:
        return None
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    return ok


def flash_attention_bwd_blocked(q, k, v, o, do, *, causal: bool = True,
                                window: int | None = None,
                                block_q: int = 512, q_offset: int = 0):
    """``flash_attention_bwd``'s gradients, recomputed one block of
    ``block_q`` query rows at a time.  Block i reads only the keys
    ``block_key_range`` gives it, and holds float32 scores of (B, Hkv,
    G * block_q, k1 - k0): the g query heads of a key/value head are
    rows of one product, so dK and dV come out summed over the group.
    The arithmetic is ``flash_attention_bwd``'s (P with the forward's
    -1e30 masks and scale, ``dV = P^T dO``, ``dS = P * (dO V^T -
    rowsum(dO * O))``, dQ and dK scaled); only the order of the sums
    differs.  Returns dq, dk, dv in the layouts and dtypes of q, k, v.

    ``q_offset`` places q's rows at positions ``q_offset ..`` of the
    keys' sequence (one sequence shard of q against every key, the dry
    run's sequence-parallel attention); dk and dv are then this shard's
    part of the sums."""
    b, s, hq, hd = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    bq = min(block_q, s)
    f32 = torch.float32

    def grouped(x):                      # (B, S, Hq, hd) -> (B, Hkv, G, S, hd)
        return x.to(f32).reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)

    qg, dog = grouped(q), grouped(do)
    delta = (dog * grouped(o)).sum(dim=-1)                  # (B, Hkv, G, S)
    kf, vf = k.to(f32).transpose(1, 2), v.to(f32).transpose(1, 2)
    dq = torch.empty((b, hkv, g, s, hd), dtype=f32, device=q.device)
    # one block (BST's S 21): its dK and dV are the gradients; a zero
    # fill and an add there cost 0.5 of 12.6 ms on an H100 (phase 12 of
    # chip_smoke.py)
    one_block = bq == s and sk == s and q_offset == 0
    if not one_block:
        dk = torch.zeros((b, hkv, sk, hd), dtype=f32, device=q.device)
        dv = torch.zeros_like(dk)
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        n = q1 - q0
        k0, k1 = block_key_range(q0 + q_offset, q1 + q_offset, sk, causal,
                                 window)
        qb = qg[:, :, :, q0:q1].reshape(b, hkv, g * n, hd)
        dob = dog[:, :, :, q0:q1].reshape(b, hkv, g * n, hd)
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        logits = torch.matmul(qb, kb.transpose(-1, -2)).mul_(scale)
        ok = block_mask(q0 + q_offset, q1 + q_offset, k0, k1, causal,
                        window, q.device)
        if ok is not None:
            logits.view(b, hkv, g, n, k1 - k0).masked_fill_(~ok, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        del logits
        dvb = torch.matmul(p.transpose(-1, -2), dob)
        ds = torch.matmul(dob, vb.transpose(-1, -2))
        ds.sub_(delta[:, :, :, q0:q1].reshape(b, hkv, g * n, 1)).mul_(p)
        del p
        dq[:, :, :, q0:q1] = torch.matmul(ds, kb).mul_(scale).view(
            b, hkv, g, n, hd)
        dkb = torch.matmul(ds.transpose(-1, -2), qb).mul_(scale)
        del ds
        if one_block:
            dk, dv = dkb, dvb
        else:
            dk[:, :, k0:k1] += dkb
            dv[:, :, k0:k1] += dvb
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


#: None, or a list to which ``FlashAttention.backward`` appends a
#: (start, end) pair of CUDA events around each backward on the card:
#: the training CLI sums them a step (two event records a call)
backward_events: list | None = None


class FlashAttention(torch.autograd.Function):
    """The kernel's forward (one launch on a CUDA tensor, the plain
    version on a CPU tensor) with ``flash_attention_bwd_blocked`` as
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, q_offset=0):
        o = _kernel_mod.flash_attention_shard(q, k, v, causal=causal,
                                              window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.block_q = causal, window, block_q
        ctx.q_offset = q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        events = backward_events if do.is_cuda else None
        if events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        dq, dk, dv = flash_attention_bwd_blocked(
            q, k, v, o, do, causal=ctx.causal, window=ctx.window,
            block_q=ctx.block_q, q_offset=ctx.q_offset)
        if events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
        return dq, dk, dv, None, None, None, None


def _layout(q, k, mesh):
    """q's placements for the sharded attention.  Where the ``attn_q``
    hint is installed (prefill and training on a mesh whose ``model``
    dim divides the sequence), the hint's: the reference pins its
    grouped queries (B, Hkv, G, S, hd) to ``P(batch, None, None, seq,
    None)``, which in the port's (B, S, Hq, hd) layout is the batch dim
    and the query rows.  Without it (decode, the smoke mesh), a batch
    shard stays; on every other mesh dim the heads split where both head
    counts divide, else the query rows where the sequence divides (GQA's
    4 or 8 key/value heads over 16), else the dim is whole."""
    from torch.distributed.tensor import Replicate, Shard
    pinned = H.get("attn_q")
    if pinned is not None:
        # (B, Hkv, G, S, hd) dims -> (B, S, Hq, hd) dims
        dims = {0: 0, 3: 1}
        return tuple(Shard(dims[p.dim]) if isinstance(p, Shard)
                     else Replicate() for p in pinned.placements)
    out, used = [], set()
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            out.append(p)
        elif (2 not in used and q.shape[2] % n == 0
              and k.shape[2] % n == 0):
            out.append(Shard(2))
            used.add(2)
        elif 1 not in used and q.shape[1] % n == 0 and q.shape[1] >= n:
            out.append(Shard(1))
            used.add(1)
        else:
            out.append(Replicate())
    return tuple(out)


def _sharded(q, k, v, causal, window, block_q, local=None):
    """DTensor q (B, S, Hq, hd), k, v (the dry run's): the kernel on each
    device's shards (``local(q, k, v, q_offset)``, where given, runs
    instead of the kernel: the plain path of ``models.attention``).  q
    is laid out by ``_layout``; k and v take q's placements with the
    whole sequence.  A device's q rows are one sequence shard: the
    backward recomputes them as the last shard (``q_offset``), the one
    that reaches every key, and its dK and dV are partial sums over the
    sequence shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    q_pl = _layout(q, k, mesh)
    kv_pl = tuple(Replicate() if p == Shard(1) else p for p in q_pl)
    kv_grad = tuple(Partial() if p == Shard(1) else p for p in q_pl)
    n_seq = 1
    for i, p in enumerate(q_pl):
        if p == Shard(1):
            n_seq *= mesh.size(i)
    q = q.redistribute(mesh, q_pl)
    ql = q.to_local()
    kl = k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    offset = (n_seq - 1) * ql.shape[1]
    if local is not None:
        # laid out as the kernel's output is (the plain path's comes
        # permuted; the model's next reshape would copy it all the same)
        ol = local(ql, kl, vl, offset).contiguous()
    elif torch.is_grad_enabled() and (ql.requires_grad or kl.requires_grad
                                      or vl.requires_grad):
        ol = FlashAttention.apply(ql, kl, vl, causal, window, block_q,
                                  offset)
    else:
        ol = _kernel_mod.flash_attention_shard(ql, kl, vl, causal=causal,
                                               window=window)
    b, s, h = q.shape[:3]
    d = v.shape[3]
    return type(q).from_local(ol, mesh, q_pl, run_check=False,
                              shape=(b, s, h, d), stride=(s * h * d, h * d,
                                                          d, 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    use_kernel: bool = True,
                    block_q: int = 512) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd).

    ``use_kernel=False`` runs the oracle (differentiable by autograd),
    for the tests; the kernel route launches the CUDA kernel on a CUDA
    tensor and its plain version on a CPU tensor, through
    ``FlashAttention`` where a gradient is needed (``block_q``: the
    query rows its backward recomputes at a time)."""
    if use_kernel and is_dtensor(q):
        return _sharded(q, k, v, causal, window, block_q)
    if use_kernel:                   # checks the shapes itself
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, block_q)
        return _kernel_mod.flash_attention_bshd(q, k, v, causal=causal,
                                                window=window)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv != 0 or v.shape[2] != hkv:
        raise ValueError(f"query heads {hq} must be a multiple of the "
                         f"key/value heads {hkv}, {v.shape[2]}")
    return attention_ref_bshd(q, k, v, causal=causal, window=window)
