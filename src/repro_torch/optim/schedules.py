"""Learning-rate schedules (pure functions of the step), copied from the
JAX package's ``optim/schedules.py``.  A tensor step gives a float32
tensor; an integer step is divided on the host first, as the reference
divides a Python number before ``jnp`` takes it."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant", "warmup_linear_decay"]


def _s(step):
    return (step.to(torch.float32) if isinstance(step, torch.Tensor)
            else float(step))


def _f32(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 200, total: int = 10_000,
                  floor: float = 0.1):
    s = _s(step)
    warm = torch.clamp(_f32(s / max(warmup, 1)), max=1.0)
    prog = torch.clamp(_f32((s - warmup) / max(total - warmup, 1)), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def warmup_linear_decay(step, *, warmup: int = 200, total: int = 10_000,
                        floor: float = 0.0):
    s = _s(step)
    warm = torch.clamp(_f32(s / max(warmup, 1)), max=1.0)
    prog = torch.clamp(_f32((s - warmup) / max(total - warmup, 1)), 0.0, 1.0)
    return warm * (1.0 - (1.0 - floor) * prog)


def constant(step, **_):
    return 1.0
