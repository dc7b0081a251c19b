"""AdamW over parameter trees of tensors: a copy of the JAX package's
``optim/adamw.py`` (its ZeRO-1 moment placement is
``distrib.sharding.lm_opt_specs``).

The update runs in float32 in the reference's order of operations: clip
the gradients by their global norm, update the moments, correct their
bias, ``mh / (sqrt(vh) + eps) + wd * p``, then ``p - lr * step``.  It is
not ``torch.optim.AdamW``, which decays the weights first.  Each of
those operations is one op over a whole leaf, done in place or into one
float32 scratch leaf: at wide-deep's full width a leaf holds 5.1 GB, and
every temporary of the JAX expression would take that again.  So the
parameters and moments are updated in place and the gradients are
consumed (they serve as scratch); the returned trees are the ones given.
The bias corrections and the clip stay 0-d tensors on the device, so a
step reads nothing back to the host.  On DTensors (the dry run's) each
gradient is first reduced to its parameter's placements, so the
data-parallel reduction is part of the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import is_dtensor
from repro_torch.tree import leaves, map_tree

__all__ = ["AdamWConfig", "init_opt_state", "global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Any, moment_dtype=torch.float32) -> dict:
    """Zero moments beside each parameter and a 0-d int32 step."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    dev = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in tree order."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_leaf(cfg: AdamWConfig, p, g, m, v, clip, b1c, b2c, lr) -> None:
    g32 = g if g.dtype == torch.float32 else g.to(torch.float32)
    g32.mul_(clip)
    m32 = m if m.dtype == torch.float32 else m.to(torch.float32)
    v32 = v if v.dtype == torch.float32 else v.to(torch.float32)
    tmp = torch.mul(g32, 1 - cfg.b1)                 # (1 - b1) * g
    m32.mul_(cfg.b1).add_(tmp)
    torch.mul(g32, 1 - cfg.b2, out=tmp).mul_(g32)    # (1 - b2) * g * g
    v32.mul_(cfg.b2).add_(tmp)
    if m32 is not m:                   # low-precision moments: rounded
        m.copy_(m32)
        v.copy_(v32)
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
    torch.div(m32, b1c, out=tmp)                     # mh
    torch.div(v32, b2c, out=g32).sqrt_().add_(cfg.eps)
    tmp.div_(g32)                                    # mh / (sqrt(vh) + eps)
    p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
    tmp.add_(torch.mul(p32, cfg.weight_decay, out=g32))
    p32.sub_(tmp.mul_(lr))
    if p32 is not p:
        p.copy_(p32)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 lr_scale: torch.Tensor | float = 1.0):
    """Returns (params, state, metrics), ``params`` and the moments
    updated in place and ``grads`` consumed; ``state["step"]`` is a new
    0-d tensor."""
    flat_p = leaves(params)
    flat_g = leaves(grads)
    if flat_p and is_dtensor(flat_p[0]):
        # sharded gradients come as partial sums: reduce each to its
        # parameter's placements (the data-parallel reduce-scatter)
        flat_g = [g.redistribute(p.device_mesh, p.placements)
                  for g, p in zip(flat_g, flat_p, strict=True)]
    gn = global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * lr_scale
    for p, g, m, v in zip(flat_p, flat_g, leaves(state["m"]),
                          leaves(state["v"]), strict=True):
        _update_leaf(cfg, p, g, m, v, clip, b1c, b2c, lr)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "clip": clip}
