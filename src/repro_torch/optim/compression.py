"""Gradient compression: an int8 quantized all-reduce with error feedback
(the port of the JAX package's ``optim/compression.py``).

At 1000+ card scale the data-parallel gradient all-reduce is the largest
recurring collective; 8-bit quantization cuts it 4x (from float32) with
error feedback (the residual carried to the next step) keeping
convergence intact: the EF-SGD recipe.  A library, as in the reference:
the training CLI has no flag for it.

``compressed_psum_tree`` is the reference's shard_map body over a list
of per-replica gradient trees (replica order): per-tensor absmax scales
agreed by a max over the replicas, the payload summed as int32 (int8
values, summed exactly), and the dequantization error returned for
feedback.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
``compressed_allreduce`` takes the reference's stacked layout: every
leaf carries a leading per-replica dim of ``mesh.shape[axis]``, replica
r placed on the r-th position of ``axis``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distrib import collectives as C
from repro_torch.tree import leaves, unflatten

__all__ = ["quantize", "dequantize", "compressed_psum_tree",
           "compressed_allreduce"]


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_tree(grads: list, errors: list):
    """Quantized mean over the replicas with error feedback.  ``grads``
    and ``errors`` are lists of per-replica trees (one structure, each
    replica's tensors on its device).  Returns (mean_grads, new_errors),
    lists of trees in the same layout."""
    n = len(grads)
    flat_g = [leaves(g) for g in grads]
    flat_e = [leaves(e) for e in errors]
    means = [[] for _ in range(n)]
    errs = [[] for _ in range(n)]
    for i in range(len(flat_g[0])):
        g32 = [flat_g[r][i].to(torch.float32) + flat_e[r][i]
               for r in range(n)]
        amax = C.pmax([torch.max(torch.abs(g)) for g in g32])
        scales = [torch.clamp(a, min=1e-12) / 127.0 for a in amax]
        qs = [quantize(g, s) for g, s in zip(g32, scales)]
        total = C.psum([q.to(torch.int32) for q in qs])
        for r in range(n):
            errs[r].append(g32[r] - dequantize(qs[r], scales[r]))   # local
            means[r].append((total[r].to(torch.float32) * scales[r] / n)
                            .to(flat_g[r][i].dtype))
    return ([unflatten(grads[r], means[r]) for r in range(n)],
            [unflatten(grads[r], errs[r]) for r in range(n)])


def compressed_allreduce(mesh, grads: Any, errors: Any, axis: str = "data"):
    """The quantized all-reduce over ``axis`` of ``mesh`` in the stacked
    layout: leaf[r] is replica r's, computed on the r-th position of
    ``axis``.  Returns the (replica-mean, new-error) pair stacked the
    same way, on the inputs' device."""
    n = C.require_axis(mesh, axis, "compressed_allreduce")
    devs = mesh.grid(axis)[0]
    g_flat, e_flat = leaves(grads), leaves(errors)

    def replica(flat, r):
        return [leaf[r].to(devs[r]) for leaf in flat]

    mean, new_e = compressed_psum_tree(
        [replica(g_flat, r) for r in range(n)],
        [replica(e_flat, r) for r in range(n)])

    def stack(per_replica, like):
        return unflatten(like, [
            torch.stack([per_replica[r][i].to(leaf.device)
                         for r in range(n)])
            for i, leaf in enumerate(leaves(like))])

    return stack(mean, grads), stack(new_e, errors)
