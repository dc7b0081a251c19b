"""Shared model layers: the post-LN layer norm and the numpy initialisers.

A copy of what the funnel needs from the JAX package's
``models/layers.py``: ``layer_norm`` (eps 1e-6, statistics in float32),
``init_linear`` and ``init_norm``.  Initialisers return numpy arrays drawn
from a caller's ``np.random.Generator``; ``to_device`` turns a parameter
tree of them into tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["layer_norm", "init_linear", "init_norm", "full_fp32_matmul",
           "check_full_fp32_matmul", "to_device", "torch_dtype"]

#: model dtypes the port runs.  A bfloat16 parameter is drawn in float32
#: and rounded by torch, as ``ml_dtypes`` rounds the JAX package's draw
#: (through float32, to nearest even).
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not supported; use one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def layer_norm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, mean and variance in float32 (not
    ``nn.LayerNorm``, whose eps is 1e-5)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * w + b


def init_linear(rng: np.random.Generator, shape, scale: float | None = None,
                dtype=np.float32) -> np.ndarray:
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    s = scale if scale is not None else fan_in ** -0.5
    return rng.normal(0.0, s, shape).astype(dtype)


def init_norm(shape, dtype=np.float32) -> np.ndarray:
    return np.ones(shape, dtype)


def full_fp32_matmul() -> None:
    """Run float32 matrix products in full float32 on the card, as the
    reference does: TF32 off (``torch.backends.cuda.matmul.allow_tf32``
    and cuDNN's), precision "highest".  These are process-wide settings:
    a program sets them once, where it starts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_full_fp32_matmul(device: torch.device) -> None:
    """Raise if float32 matrix products on ``device`` would round through
    TF32 (see ``full_fp32_matmul``); a CPU device always passes."""
    if device.type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise ValueError(
            "float32 matrix products on the card would use TF32; call "
            "repro_torch.models.layers.full_fp32_matmul() first")


def to_device(tree, device, dtype: torch.dtype | None = None):
    """A nested dict/list of arrays as the same tree of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device, dtype) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tree))
    return t.to(device=device, dtype=dtype)
