"""Config registry of the port's trainable archs: the JAX package's
``configs/base.py:get`` over the four recsys archs (the LM and GNN
archs wait for ROADMAP item 7)."""

from __future__ import annotations

import importlib

__all__ = ["RECSYS_ARCHS", "get"]

RECSYS_ARCHS = ("wide-deep", "dien", "bst", "mind")

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_")
            for a in RECSYS_ARCHS}


def get(arch: str):
    """The config module of ``arch``: ``ARCH``, ``SHAPES``,
    ``model_config()``, ``smoke_config()`` and ``_model_flops``."""
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported; the port has "
                       f"{RECSYS_ARCHS}")
    return importlib.import_module(_MODULES[arch])
