"""JASS score-at-a-time impact accumulation: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``impact_scan`` of
``src/repro/kernels/impact_scan/kernel.py``; the CUDA source is
``src/repro_torch/csrc/impact_scan.cu``, whose header gives the design
(one thread block owns a query's whole doc range in shared memory, up to
56 K docs a block, reads its stream once and writes each output element
once) and the bound (bytes: the dense (Q, n_docs) accumulator write is
the floor).

``block_p`` and ``block_d`` keep the TPU grid's meaning: the posting
blocks that ``seg_lo``/``seg_hi`` describe, and the doc tile per which
``with_stats`` counts the live posting blocks.  Neither shapes the CUDA
kernel's work.

``impact_scan`` launches the kernel on a CUDA tensor and runs the plain
version (``impact_scan_plain``) on a CPU tensor; there is no fallback
from one to the other.  ``n_launches`` counts kernel launches (a
captured program's at each replay: ``_build.counted_in_capture``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.impact_scan.ref import impact_scan_masked_ref

__all__ = ["doc_blocks", "impact_scan", "impact_scan_plain",
           "live_cell_count", "live_cells", "posting_blocks", "n_launches"]

#: kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before the main path and reads it after)
n_launches = 0


def posting_blocks(p: int, block_p: int) -> tuple[int, int]:
    """(clamped block size, block count) for a stream of length ``p``,
    shared by the kernel and every producer of segment metadata."""
    bp = min(block_p, p)
    return bp, -(-p // bp)


def doc_blocks(n_docs: int, block_d: int) -> tuple[int, int]:
    """(clamped doc-tile size, tile count) for ``n_docs`` documents."""
    bd = min(block_d, n_docs)
    return bd, -(-n_docs // bd)


def live_cells(rho_vec, seg_lo, seg_hi, *, p: int, n_docs: int,
               block_p: int, block_d: int) -> torch.Tensor:
    """(Q, n_doc_blocks, n_posting_blocks) bool: the kernel's live
    predicate -- a cell runs when its posting block starts below
    ``rho[q]`` and its doc-id range meets the doc tile."""
    bp, n_p = posting_blocks(p, block_p)
    bd, n_d = doc_blocks(n_docs, block_d)
    dev = rho_vec.device
    pb = torch.arange(n_p, dtype=torch.int64, device=dev)
    base = torch.arange(n_d, dtype=torch.int64, device=dev) * bd
    return ((pb[None, None, :] * bp < rho_vec[:, None, None])
            & (seg_lo[:, None, :] < base[None, :, None] + bd)
            & (seg_hi[:, None, :] >= base[None, :, None]))


def live_cell_count(rho_vec, seg_lo, seg_hi, *, p: int, n_docs: int,
                    block_p: int = 512, block_d: int = 2048) -> torch.Tensor:
    """Grid cells the kernel executes, summed (the dense kernel would run
    ``Q * n_doc_blocks * n_posting_blocks``)."""
    return live_cells(rho_vec, seg_lo, seg_hi, p=p, n_docs=n_docs,
                      block_p=block_p, block_d=block_d).sum()


def _validate(doc_stream, rho_vec, seg_lo, seg_hi, block_p):
    qn, p = doc_stream.shape
    _, n_p = posting_blocks(p, block_p)
    if tuple(rho_vec.shape) != (qn,):
        raise ValueError(f"rho_vec must be shaped ({qn},), got "
                         f"{tuple(rho_vec.shape)}")
    if (tuple(seg_lo.shape) != (qn, n_p)
            or tuple(seg_hi.shape) != (qn, n_p)):
        raise ValueError(
            f"segment bounds must be shaped ({qn}, {n_p}) for block_p="
            f"{block_p} (got {tuple(seg_lo.shape)} / "
            f"{tuple(seg_hi.shape)}); compute them with "
            "retrieval.index.block_doc_bounds at the same block size")


def impact_scan_plain(doc_stream, impact_stream, rho_vec, seg_lo, seg_hi, *,
                      n_docs: int, block_p: int = 512, block_d: int = 2048,
                      with_stats: bool = False):
    """The kernel's function in plain torch: the masked scatter, plus the
    executed-cell counts computed from the live predicate."""
    _validate(doc_stream, rho_vec, seg_lo, seg_hi, block_p)
    acc = impact_scan_masked_ref(doc_stream, impact_stream, rho_vec,
                                 n_docs=n_docs)
    if not with_stats:
        return acc
    live = live_cells(rho_vec, seg_lo, seg_hi, p=doc_stream.shape[1],
                      n_docs=n_docs, block_p=block_p, block_d=block_d)
    return acc, live.sum(dim=2).to(torch.int32)


def impact_scan(doc_stream: torch.Tensor, impact_stream: torch.Tensor,
                rho_vec: torch.Tensor, seg_lo: torch.Tensor,
                seg_hi: torch.Tensor, *, n_docs: int, block_p: int = 512,
                block_d: int = 2048, with_stats: bool = False):
    """Accumulate the first ``rho_vec[q]`` postings of each stream.

    doc_stream: (Q, P) int32 (-1 padded), impact_stream: (Q, P) f32,
    both impact-descending.  rho_vec: (Q,) int32.  seg_lo/seg_hi:
    (Q, n_posting_blocks) int32 per-block min/max doc id.  Returns the
    (Q, n_docs) f32 accumulators and, with ``with_stats``, the (Q,
    n_doc_blocks) int32 count of cells executed.
    """
    global n_launches
    _build.check_no_grad("impact_scan", impact_stream)
    dev = doc_stream.device
    if dev.type == "cpu":
        return impact_scan_plain(doc_stream, impact_stream, rho_vec, seg_lo,
                                 seg_hi, n_docs=n_docs, block_p=block_p,
                                 block_d=block_d, with_stats=with_stats)
    if dev.type != "cuda":
        raise ValueError(f"impact_scan runs on cuda or cpu, not {dev}")
    _validate(doc_stream, rho_vec, seg_lo, seg_hi, block_p)
    if not 1 <= n_docs < 2 ** 31:
        raise ValueError(f"impact_scan takes 1 <= n_docs < 2**31 (doc ids "
                         f"are int32), got {n_docs}")
    qn, p = doc_stream.shape
    bp, n_p = posting_blocks(p, block_p)
    bd, n_d = doc_blocks(n_docs, block_d)
    if any(t.device != dev for t in (impact_stream, rho_vec, seg_lo,
                                     seg_hi)):
        raise ValueError("impact_scan operands must share one device")
    docs = _build.operand(doc_stream, torch.int32)
    imps = _build.operand(impact_stream, torch.float32)
    rho, lo, hi = (_build.operand(t, torch.int32)
                   for t in (rho_vec, seg_lo, seg_hi))
    out = torch.empty((qn, n_docs), dtype=torch.float32, device=dev)
    stats = (torch.empty((qn, n_d), dtype=torch.int32, device=dev)
             if with_stats else None)
    launch = _build.library("impact_scan")
    err = launch(docs.data_ptr(), imps.data_ptr(), rho.data_ptr(),
                 lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 qn, p, n_docs, bp, n_p, bd, n_d,
                 _build.stream(dev))
    _build.check(err, "impact_scan")
    if not _build.counted_in_capture(__name__):
        n_launches += 1
    return (out, stats) if with_stats else out
