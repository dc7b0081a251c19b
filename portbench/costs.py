"""The roofline yardstick: the H100's published peaks and the bytes and
operations each hand-written kernel of the serving path needs a call.

Counts follow the shapes of the work asked for, each input byte read
once and each output byte written once: the caller passes a batch's real
rows, not the rows that pad it to the program grid, and an
``impact_scan`` call's postings are those it actually accumulates.
The figures are frozen here so that a change to a kernel cannot change
the yardstick it is measured by.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


def bound_s(n_bytes: float, n_ops: float, ops_s: float = FP32_OPS_S):
    """The least seconds a call that moves ``n_bytes`` and does ``n_ops``
    float32 operations can take, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "ops")


def posting_blocks(p: int, block_p: int) -> int:
    bp = min(block_p, p)
    return -(-p // bp)


def impact_scan_cost(q: int, p: int, n_docs: int, live: int,
                     block_p: int = 512):
    """``impact_scan`` over a (q, p) stream batch: each of the ``live``
    accumulated postings' doc id and impact read (8 bytes), the per-query
    rho (4), the per-block doc bounds (2 x 4 a block), and the dense
    (q, n_docs) float32 accumulator written once.  One add a posting.
    Returns (bytes, ops)."""
    n_p = posting_blocks(p, block_p)
    n_bytes = live * 8 + q * 4 + 2 * q * n_p * 4 + q * n_docs * 4
    return n_bytes, live


def topk_cost(q: int, n: int, kp: int, block_n: int = 4096):
    """``block_topk`` over (q, n) scores: the scores read once and each
    block's kp (value, index) pairs written.  One compare a score.
    Returns (bytes, ops)."""
    n_b = -(-n // min(block_n, n))
    return q * n * 4 + q * n_b * kp * 8, q * n
