"""Config registry and dry-run bundle protocol (the port of the JAX
package's ``configs/base.py``).

Every architecture module exposes:

  ARCH: str                      — the arch id
  SHAPES: dict[str, dict]        — its own input-shape set (kind + dims)
  SKIPS: dict[str, str]          — shape -> reason, for inapplicable cells
  model_config() / smoke_config()
  dryrun_bundle(shape, mesh, mode) -> Bundle — what ``launch.dryrun`` runs

A Bundle carries the step function, the abstract argument trees (fake
tensors: shapes and dtypes, no storage), the ``NamedSharding`` trees the
arguments are placed by, the donated arguments, the activation hints
and the roofline metadata; ``launch/dryrun.py`` is generic over it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Bundle", "get", "ALL_ARCHS", "RECSYS_ARCHS", "LM_ARCHS",
           "GNN_ARCHS", "abstract_tree", "fake_mode", "train_step_fn"]

ALL_ARCHS = (
    "tinyllama-1.1b", "qwen3-4b", "qwen2-0.5b", "deepseek-v3-671b",
    "mixtral-8x22b",
    "graphsage-reddit",
    "wide-deep", "dien", "bst", "mind",
)
RECSYS_ARCHS = ("wide-deep", "dien", "bst", "mind")
LM_ARCHS = ("tinyllama-1.1b", "qwen2-0.5b", "qwen3-4b", "mixtral-8x22b",
            "deepseek-v3-671b")
GNN_ARCHS = ("graphsage-reddit",)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ALL_ARCHS}


@dataclasses.dataclass
class Bundle:
    fn: Callable                 # the step
    args: tuple                  # abstract argument trees (fake tensors)
    in_shardings: tuple          # NamedSharding trees, one per argument
    out_shardings: Any
    donate_argnums: tuple
    hints: dict                  # activation sharding hints
    meta: dict                   # model_flops, params, kind, notes


def train_step_fn(loss_fn, adam):
    """A bundle's training step, ``(params, opt, batch) -> (params, opt,
    metrics)``: ``loss_fn(params, batch)``'s gradients by autograd, then
    AdamW (in place), as the reference's ``jax.value_and_grad`` and
    ``adamw_update``."""
    from repro_torch.launch.train import value_and_grad
    from repro_torch.optim import adamw

    def step(params, opt, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch), params)
        new_p, new_o, m = adamw.adamw_update(adam, params, grads, opt)
        return new_p, new_o, {"loss": loss, **m}

    return step


def get(arch: str):
    """The config module of ``arch``."""
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported; the port has "
                       f"{ALL_ARCHS}")
    return importlib.import_module(_MODULES[arch])


_FAKE = None


def fake_mode():
    """The process's ``FakeTensorMode``: every abstract tree is made in
    it, and the dry run traces in it."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dt))).dtype


def abstract_tree(tree: Any, device="cpu") -> Any:
    """A (possibly ``FakeArray``-bearing) tree as fake tensors of the same
    shapes and dtypes on ``device``."""
    with fake_mode():
        def one(a):
            return torch.empty(tuple(a.shape), dtype=_torch_dtype(a.dtype),
                               device=device)
        if isinstance(tree, dict):
            return {k: abstract_tree(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(abstract_tree(v, device) for v in tree)
        return one(tree)
