"""Two-stage top-k: the blocked kernel, then a stable-sort merge."""

from __future__ import annotations

import torch

from repro_torch.kernels.topk import kernel as _kernel_mod
from repro_torch.kernels.topk.kernel import KP_MAX
from repro_torch.kernels.topk.ref import topk_ref

__all__ = ["topk_select"]


def topk_select(scores: torch.Tensor, k: int, *, block_n: int = 4096,
                use_kernel: bool = True):
    """Exact top-k of (Q, N) scores; ties broken toward lower index.

    The kernel covers k <= KP_MAX.  Wider k runs ``topk_ref``, a plain
    stable sort: that is the JAX package's contract
    (``kernels/topk/ops.py`` sends k > 128 to its jnp oracle), not a
    fallback from a failed kernel.
    """
    if not use_kernel or k > KP_MAX:
        return topk_ref(scores, k)
    vals, idxs = _kernel_mod.block_topk(scores, kp=k, block_n=block_n)
    # merge the per-block survivors: lexsort((idx, -val)) is a stable
    # sort on idx, then a stable sort on -val.  The blocks already come
    # in index order: within a block equal values ascend by index, blocks
    # ascend, and repeated (-inf, base) pairs are identical.  So the
    # stable sort on -val alone gives the lexsort.
    order = torch.sort(-vals, dim=1, stable=True).indices[:, :k]
    return vals.gather(1, order), idxs.gather(1, order)
