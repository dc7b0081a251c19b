"""Flash-attention forward: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``flash_attention_fwd`` of
``src/repro/kernels/flash_attention/kernel.py``; the CUDA source is
``src/repro_torch/csrc/flash_attention.cu``, whose header gives the
design (a group of threads per query row, several bh packed per block,
K/V tiles in shared memory, fp32 online softmax in registers) and the
bound (bytes and fp32 operations about balanced at the funnel's shape).

Inputs are (BH, S, hd) in float32 or bfloat16 with hd in ``HEAD_DIMS``;
unlike the TPU wrapper, S need not divide any block size (the kernel
masks the ragged edge).  ``flash_attention_fwd`` launches the kernel on
a CUDA tensor and runs ``flash_attention_fwd_plain`` (the oracle
``attention_ref``) on a CPU tensor; ``n_launches`` counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_fwd", "flash_attention_fwd_plain",
           "n_launches"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (4, 8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset
n_launches = 0


def _check(q, k, v, window) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention_fwd takes q, k, v of one (BH, S, "
                         f"hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None) -> torch.Tensor:
    """The kernel's function in plain torch (``attention_ref``)."""
    _check(q, k, v, window)
    return attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q, k, v: (BH, S, hd) -> (BH, S, hd) in q's dtype."""
    global n_launches
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, "
                         f"not {dev}")
    _check(q, k, v, window)
    bh, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    launch = _build.library("flash_attention")
    err = launch(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                 bh, s, hd, _DTYPE_CODES[q.dtype], int(causal),
                 0 if window is None else int(window), hd ** -0.5,
                 _build.stream(dev))
    _build.check(err, "flash_attention")
    n_launches += 1
    return out
