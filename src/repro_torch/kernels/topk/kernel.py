"""Blocked top-kp selection: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``block_topk`` of
``src/repro/kernels/topk/kernel.py``; the CUDA source is
``src/repro_torch/csrc/topk.cu``, whose header gives the design (one
thread block per (query, score block): order-preserving uint32 keys, an
MSD radix select of the kp-th largest, the lowest-index ties kept, the
survivors sorted in shared memory; a dozen barriers whatever kp is) and
the bound (bytes: one read of the scores).

Each (query, ``block_n`` block) yields its top-kp (value, index) pairs in
the TPU kernel's order: descending value, ties to the lower index, and
once only -inf is left, (-inf, block base) for every remaining round.
The global top-k is contained in the union of per-block top-kp iff
k <= kp, and kp is limited to [1, KP_MAX].

``block_topk`` launches the kernel on a CUDA tensor and runs
``block_topk_plain`` on a CPU tensor; ``n_launches`` counts launches (a
captured program's at each replay: ``_build.counted_in_capture``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["KP_MAX", "block_topk", "block_topk_plain", "n_launches"]

#: widest per-block selection the kernel supports, as on the TPU
KP_MAX = 128
#: widest block the kernel holds in registers (1024 threads x 32 keys)
BLOCK_N_MAX = 32 * 1024

#: kernel launches since the last reset
n_launches = 0


def _check_kp(kp: int) -> None:
    if not 1 <= kp <= KP_MAX:
        raise ValueError(
            f"block_topk kp must be in [1, {KP_MAX}], got {kp}; the "
            "global top-k is only contained in the per-block unions for "
            f"k <= kp, and kp > {KP_MAX} exceeds the kernel's iterative-"
            "extraction budget -- use ops.topk_select (which routes wider "
            "selections to the oracle)")


def _blocks(n: int, block_n: int) -> tuple[int, int]:
    bn = min(block_n, n)
    return bn, -(-n // bn)


def block_topk_plain(scores: torch.Tensor, *, kp: int, block_n: int = 4096):
    """The kernel's function in plain torch: a stable descending sort of
    each -inf padded block, its first kp entries, -inf entries re-indexed
    to the block base."""
    _check_kp(kp)
    qn, n = scores.shape
    bn, n_b = _blocks(n, block_n)
    s = scores.to(torch.float32)
    if n_b * bn != n:
        s = torch.nn.functional.pad(s, (0, n_b * bn - n),
                                    value=float("-inf"))
    s = s.reshape(qn, n_b, bn)
    vals, order = torch.sort(s, dim=2, descending=True, stable=True)
    vals, order = vals[..., :kp], order[..., :kp]
    if kp > bn:                       # rounds past the block's width
        vals = torch.nn.functional.pad(vals, (0, kp - bn),
                                       value=float("-inf"))
        order = torch.nn.functional.pad(order, (0, kp - bn), value=0)
    base = (torch.arange(n_b, device=s.device) * bn)[None, :, None]
    idxs = torch.where(vals == float("-inf"), base, base + order)
    return (vals.reshape(qn, n_b * kp),
            idxs.reshape(qn, n_b * kp).to(torch.int32))


def block_topk(scores: torch.Tensor, *, kp: int, block_n: int = 4096):
    """scores: (Q, N) -> (vals (Q, n_blocks*kp) f32, idxs int32).

    kp outside [1, KP_MAX] raises ValueError: a wider kp would return a
    silently wrong union.  Scores must be finite or -inf."""
    global n_launches
    _build.check_no_grad("topk", scores)
    dev = scores.device
    if dev.type == "cpu":
        return block_topk_plain(scores, kp=kp, block_n=block_n)
    if dev.type != "cuda":
        raise ValueError(f"block_topk runs on cuda or cpu, not {dev}")
    _check_kp(kp)
    qn, n = scores.shape
    bn, n_b = _blocks(n, block_n)
    if bn > BLOCK_N_MAX:
        raise ValueError(f"block_n={bn} exceeds the kernel's register "
                         f"budget of {BLOCK_N_MAX} scores a block")
    s = _build.operand(scores, torch.float32)
    vals = torch.empty((qn, n_b * kp), dtype=torch.float32, device=dev)
    idxs = torch.empty((qn, n_b * kp), dtype=torch.int32, device=dev)
    launch = _build.library("topk")
    err = launch(s.data_ptr(), vals.data_ptr(), idxs.data_ptr(), qn, n, bn,
                 n_b, kp, _build.stream(dev))
    _build.check(err, "topk")
    if not _build.counted_in_capture(__name__):
        n_launches += 1
    return vals, idxs
