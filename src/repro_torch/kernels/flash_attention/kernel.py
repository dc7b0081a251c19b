"""Flash-attention forward: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``flash_attention_fwd`` of
``src/repro/kernels/flash_attention/kernel.py`` and the fold of its
wrapper; the CUDA source is ``src/repro_torch/csrc/flash_attention.cu``,
whose header gives the bounds (bytes at the funnel's shape, bf16
tensor-core operations at the LM shapes) and the design of its paths
and routes:

* ``short``: S <= 32 and hd <= 16 (BST's attention).  Persistent
  blocks, a ring of groups of whole batch rows in shared memory, two
  query rows of one head per thread with all S scores in registers.  Its
  ``short_bulk`` route fills the ring with bulk async copies where each
  batch row of q, k and v is one 16-byte aligned contiguous span (and
  the batch stride 16-byte aligned); otherwise ``short_loads`` stages the
  same groups with plain loads.
* ``general_tc``: bf16 at hd 64 or 128 where TMA can address q, k and v
  (16-byte aligned bases, byte strides multiples of 16 on every axis
  longer than 1; the LM shapes).  Persistent blocks walk work items of
  128 query rows of one head: two warpgroups of ``wgmma`` (QK^T and P.V
  on the tensor cores, P cast to bf16 for P.V), K and V tiles of 128
  keys through a TMA ring fed by a producer warp.  ``cutouts.py`` times
  builds of it with parts of its work cut out.
* ``general``: the rest (float32, other head dims, a sliced head dim or
  broadcast heads at hd 64 or 128), an online softmax over kv tiles on
  the CUDA cores.

The C launcher picks the path and route from the dtype, shape, strides
and alignment it is given, before the launch, and reports it:
``last_route`` holds the route of the last launch and
``route_launches`` counts launches by route.  ``flash_attention_bshd``
takes the model layout, q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) with
Hkv dividing Hq, through their strides: any operand whose last axis has
stride 1 is read in place (the kernel reads key/value head h // g for
query head h), and the output is a new contiguous (B, S, Hq, hd).
``flash_attention_fwd`` is the TPU kernel's (BH, S, hd) layout, the case
H = 1.  Both launch the kernel on a CUDA tensor and run their plain
version (the oracle
``attention_ref``, through the fold) on a CPU tensor; ``n_launches``
counts launches.  Neither has a backward: an input that requires grad
under grad mode raises (``_build.check_no_grad``); training goes through
``ops.flash_attention``, whose ``torch.autograd.Function`` launches the
same kernel forward.

On a fake or meta tensor (``device.is_fake``: the dry run's) both
return an empty output of the kernel's shape and dtype through the op
``repro_torch::flash_attention_shape``, whose FLOP formula is
registered with ``torch.utils.flop_counter``: the plain version's two
products, 4 * B * Hq * S * S * hd, masked tiles included.  That branch
launches nothing, runs no plain version and moves no counter; a real
CPU tensor still runs the plain version and a real CUDA tensor still
launches the kernel.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.device import is_fake
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_bshd)

__all__ = ["HEAD_DIMS", "ROUTES", "flash_attention_bshd",
           "flash_attention_shard", "flash_flops",
           "flash_attention_fwd", "flash_attention_fwd_plain", "last_route",
           "n_launches", "route_launches"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (4, 8, 16, 32, 64, 128)
#: the routes by the code the launcher reports
ROUTES = ("general", "short_bulk", "short_loads", "general_tc")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the twelve (batch, sequence, head) element strides of q, k, v and o as
#: the launcher reads them
_pack_strides = struct.Struct("12q").pack
_route_code = ctypes.c_int(-1)
_ROUTE_OUT = ctypes.byref(_route_code)

#: kernel launches since the last reset
n_launches = 0
#: the route of the last launch (one of ROUTES), None before the first
last_route: str | None = None
#: kernel launches by route since the last reset (``clear()`` resets)
route_launches: dict[str, int] = {}


def _check(q, k, v, window) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention_fwd takes q, k, v of one (BH, S, "
                         f"hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_window(window)


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_bshd(q, k, v, window) -> None:
    """q's and k's shapes, checked."""
    qsh, ksh = q.shape, k.shape
    if len(qsh) != 4 or len(ksh) != 4 or ksh != v.shape:
        raise ValueError("flash_attention_bshd takes q (B, S, Hq, hd) and "
                         f"k, v (B, S, Hkv, hd), got {tuple(qsh)}, "
                         f"{tuple(ksh)}, {tuple(v.shape)}")
    if (ksh[0], ksh[1], ksh[3]) != (qsh[0], qsh[1], qsh[3]):
        raise ValueError(f"q {tuple(qsh)} and k, v {tuple(ksh)} "
                         "differ in batch, sequence or head dim")
    if qsh[2] % ksh[2] != 0:
        raise ValueError(f"query heads {qsh[2]} must be a multiple of the "
                         f"key/value heads {ksh[2]}")
    _check_window(window)


def flash_flops(q_shape, k_shape) -> int:
    """FLOPs of one call: q (B, S, Hq, hd) or (BH, S, hd) against keys of
    k's sequence length, the plain version's QK^T and PV products."""
    if len(q_shape) == 3:
        (bh, s, hd), hq = q_shape, 1
    else:
        bh, s, hq, hd = q_shape
    return 4 * bh * hq * s * k_shape[1] * hd


def _shape_op():
    """The op a fake call goes through: q's shape, contiguous, in q's
    dtype (a shape function: it builds and launches nothing)."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::flash_attention_shape",
                             mutates_args=())
    def shape_op(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        raise RuntimeError("flash_attention_shape runs on fake tensors only")

    @shape_op.register_fake
    def _(q, k, v):
        return q.new_empty(q.shape)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_shape)
    def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
        return flash_flops(q_shape, k_shape)

    return shape_op


_SHAPE_OP = _shape_op()


def _fake_out(q, k, v):
    """The output a launch would write, for a fake or meta q."""
    return _SHAPE_OP(q, k, v)


def _on_card(q, k, v, hd: int):
    """q, k, v checked for the kernel, each with a head dim of stride 1
    (a copy only where it has another)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    dt, dev = q.dtype, q.device
    if dt not in _DTYPE_CODES or k.dtype != dt or v.dtype != dt:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    return tuple(x if x.stride(-1) == 1 else x.contiguous()
                 for x in (q, k, v))


def _launch(q, k, v, out, strides, b, s, hq, g, hd, causal, window):
    """One launch on the (batch, sequence, head) element strides of q, k,
    v and out; the launcher picks the route and reports it."""
    global n_launches, last_route
    err = _build.library("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _pack_strides(*strides), b, s, hq, g, hd, _DTYPE_CODES[q.dtype],
        int(causal), 0 if window is None else int(window), hd ** -0.5,
        _ROUTE_OUT, _build.stream(out.device))
    _build.check(err, "flash_attention")
    last_route = ROUTES[_route_code.value]
    if not _build.counted_in_capture(__name__, last_route):
        n_launches += 1
        route_launches[last_route] = route_launches.get(last_route, 0) + 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) -> a contiguous
    (B, S, Hq, hd) in q's dtype, read through the operands' strides."""
    _check_bshd(q, k, v, window)
    b, s, hq, hd = q.shape
    _build.check_no_grad("flash_attention", q, k, v)
    if is_fake(q):
        return _fake_out(q, k, v)
    if not q.is_cuda and q.device.type == "cpu":
        return attention_ref_bshd(q, k, v, causal=causal, window=window)
    q, k, v = _on_card(q, k, v, hd)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    return _launch(q, k, v, out, (qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
                                  vs[0], vs[1], vs[2], s * hq * hd, hq * hd,
                                  hd),
                   b, s, hq, hq // k.shape[2], hd, causal, window)


def flash_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """``flash_attention_bshd``, or on the dry run's fake tensors one
    sequence shard of q (B, Sq, Hq, hd) against whole keys (B, Sk, Hkv,
    hd): the output's shape, launching nothing."""
    if is_fake(q) and q.shape[1] != k.shape[1]:
        return _fake_out(q, k, v)
    return flash_attention_bshd(q, k, v, causal=causal, window=window)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None) -> torch.Tensor:
    """The kernel's function in plain torch (``attention_ref``)."""
    _check(q, k, v, window)
    return attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q, k, v: (BH, S, hd) -> (BH, S, hd) in q's dtype: the model layout
    with one head."""
    _check(q, k, v, window)
    _build.check_no_grad("flash_attention", q, k, v)
    if is_fake(q):
        return _fake_out(q, k, v)
    if not q.is_cuda and q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    bh, s, hd = q.shape
    q, k, v = _on_card(q, k, v, hd)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    out = torch.empty((bh, s, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # one head: its stride is never stepped
    return _launch(q, k, v, out, (qs[0], qs[1], hd, ks[0], ks[1], hd, vs[0],
                                  vs[1], hd, s * hd, hd, hd),
                   bh, s, 1, 1, hd, causal, window)
