"""Wrapper for impact_scan: kernel/oracle dispatch and validation.

``rho`` may be a static Python int (a static rho of 0 returns zeros with
no kernel launch) or a (Q,) integer tensor (the serving engine's
per-query predicted rho).  Segment bounds turn the kernel's dense
(posting-block, doc-block) grid sparse; when absent, full-range bounds
are synthesized and only the rho skip applies.  ``use_kernel`` routes
through ``kernel.impact_scan`` (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); otherwise the oracle in ``ref`` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.impact_scan import kernel as _kernel_mod
from repro_torch.kernels.impact_scan.kernel import live_cells, posting_blocks
from repro_torch.kernels.impact_scan.ref import (impact_scan_masked_ref,
                                                 impact_scan_ref)

__all__ = ["saat_accumulate", "owned_prefix_len"]


def owned_prefix_len(gpos: torch.Tensor, rho) -> torch.Tensor:
    """Shard-local rho of a doc-range-partitioned stream.

    ``gpos`` (Q, cap) is ``partition_postings``' global stream position
    column: increasing over each query's kept prefix, P on padding.  The
    owned postings a global budget ``rho`` admits are a prefix of the
    local stream, of length ``count(gpos < rho)``: a rho vector for
    ``saat_accumulate`` on the local stream, with no new masking."""
    rho_vec = torch.as_tensor(rho, device=gpos.device)
    if rho_vec.ndim == 0:
        rho_vec = rho_vec[None]
    return (gpos < rho_vec[:, None]).sum(dim=-1).to(torch.int32)


def _full_bounds(qn: int, p: int, n_docs: int, block_p: int, device):
    _, n_p = posting_blocks(p, block_p)
    return (torch.zeros((qn, n_p), dtype=torch.int32, device=device),
            torch.full((qn, n_p), n_docs - 1, dtype=torch.int32,
                       device=device))


def _oracle_stats(rho_vec, seg_bounds, *, qn: int, p: int, n_docs: int,
                  block_p: int, block_d: int) -> torch.Tensor:
    """Analytic (Q, n_doc_blocks) executed-cell counts for the oracle:
    the kernel's live predicate, summed over the posting blocks."""
    if seg_bounds is None:
        seg_lo, seg_hi = _full_bounds(qn, p, n_docs, block_p, rho_vec.device)
    else:
        seg_lo, seg_hi = seg_bounds
    live = live_cells(rho_vec, seg_lo, seg_hi, p=p, n_docs=n_docs,
                      block_p=block_p, block_d=block_d)
    return live.sum(dim=2).to(torch.int32)


def saat_accumulate(doc_stream: torch.Tensor, impact_stream: torch.Tensor, *,
                    n_docs: int, rho, use_kernel: bool = True,
                    block_p: int = 512, block_d: int = 2048,
                    seg_bounds=None, with_stats: bool = False):
    """Score-at-a-time accumulation of the first ``rho`` postings.

    rho: static int or (Q,) integer tensor.  seg_bounds: optional
    (seg_lo, seg_hi), each (Q, n_posting_blocks) int32 at ``block_p``.
    with_stats: also return the executed-cell counts (measured by the
    kernel, computed from the same predicate on the oracle path).
    """
    qn, p = doc_stream.shape
    dev = doc_stream.device
    static_rho = None
    if isinstance(rho, (int, np.integer)):
        if rho < 0:
            raise ValueError(f"rho must be >= 0, got {rho}")
        static_rho = int(rho)
        rho_vec = torch.full((qn,), min(static_rho, p), dtype=torch.int32,
                             device=dev)
    else:
        rho_vec = torch.as_tensor(rho, device=dev)
        if rho_vec.dtype.is_floating_point or rho_vec.dtype == torch.bool:
            raise ValueError(
                f"rho_vec must have an integer dtype, got {rho_vec.dtype} "
                "(per-query rho is a posting count, not a score)")
        if tuple(rho_vec.shape) != (qn,):
            raise ValueError(f"rho_vec must be shaped ({qn},), got "
                             f"{tuple(rho_vec.shape)}")
        rho_vec = rho_vec.to(torch.int32)

    if not use_kernel:
        if static_rho is not None:
            acc = impact_scan_ref(doc_stream, impact_stream, n_docs=n_docs,
                                  rho=static_rho)
        else:
            acc = impact_scan_masked_ref(doc_stream, impact_stream, rho_vec,
                                         n_docs=n_docs)
        if with_stats:
            return acc, _oracle_stats(rho_vec, seg_bounds, qn=qn, p=p,
                                      n_docs=n_docs, block_p=block_p,
                                      block_d=block_d)
        return acc

    if static_rho == 0:           # nothing to score: no kernel launch
        zeros = torch.zeros((qn, n_docs), dtype=torch.float32, device=dev)
        if with_stats:
            _, n_d = _kernel_mod.doc_blocks(n_docs, block_d)
            return zeros, torch.zeros((qn, n_d), dtype=torch.int32,
                                      device=dev)
        return zeros

    if seg_bounds is None:        # full-range bounds: only the rho skip fires
        seg_lo, seg_hi = _full_bounds(qn, p, n_docs, block_p, dev)
    else:
        seg_lo, seg_hi = seg_bounds
    return _kernel_mod.impact_scan(doc_stream, impact_stream, rho_vec, seg_lo,
                                   seg_hi, n_docs=n_docs, block_p=block_p,
                                   block_d=block_d, with_stats=with_stats)
