"""Device resolution for every entry point of the port."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "fence", "device_scope", "is_fake",
           "is_dtensor"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    ``RuntimeError``; the CPU is honoured only when asked for by name.
    There is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU "
            "(the port never falls back to it on its own)")
    return dev


def fence(device: torch.device) -> None:
    """Wait for the work queued on the calling thread's current CUDA
    stream of ``device`` (a no-op off CUDA).  Not the whole device: the
    service runs predict on a stream of its own beside execute, and a
    timing fence of one must not wait for the other's work."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def device_scope(device: torch.device):
    """A context in which ``device`` is the current CUDA device (a
    kernel launches on the current device's stream), or a no-op off
    CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def is_dtensor(t) -> bool:
    """A ``torch.distributed.tensor.DTensor`` (the dry run's arguments)."""
    return type(t) is not torch.Tensor and hasattr(t, "_local_tensor")


def is_fake(t) -> bool:
    """A tensor with no data to compute on: a ``FakeTensor``, a meta
    tensor, or a DTensor whose local shard is one (the dry run traces
    on them).  A plain tensor answers without an import."""
    if type(t) is torch.Tensor or type(t) is torch.nn.Parameter:
        return t.is_meta
    local = getattr(t, "_local_tensor", None)
    if local is not None:
        return is_fake(local)
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.is_meta
