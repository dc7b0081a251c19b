"""Config registry of the port: the JAX package's ``configs/base.py:get``
over the four recsys archs, the five LM archs and the GNN."""

from __future__ import annotations

import importlib

__all__ = ["RECSYS_ARCHS", "LM_ARCHS", "GNN_ARCHS", "get"]

RECSYS_ARCHS = ("wide-deep", "dien", "bst", "mind")
LM_ARCHS = ("tinyllama-1.1b", "qwen2-0.5b", "qwen3-4b", "mixtral-8x22b",
            "deepseek-v3-671b")
GNN_ARCHS = ("graphsage-reddit",)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in RECSYS_ARCHS + LM_ARCHS + GNN_ARCHS}


def get(arch: str):
    """The config module of ``arch``: ``ARCH``, ``SHAPES``,
    ``model_config()`` and ``smoke_config()``; a recsys arch's also has
    ``_model_flops``, an LM arch's ``SKIPS``, the GNN's ``SKIPS`` and
    ``model_flops(shape)``."""
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported; the port has "
                       f"{RECSYS_ARCHS + LM_ARCHS + GNN_ARCHS}")
    return importlib.import_module(_MODULES[arch])
