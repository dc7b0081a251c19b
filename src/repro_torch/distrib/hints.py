"""Activation sharding hints (the port of the JAX package's
``distrib/hints.py``).

Model code stays mesh-agnostic; a launcher installs named hints before
it runs a step (and clears them after).  A hint is a
``sharding.NamedSharding`` whose mesh carries a
``torch.distributed`` ``DeviceMesh`` (``torch_mesh``); ``hint(x, name)``
redistributes a ``DTensor`` ``x`` to the hint's placements, the
counterpart of ``jax.lax.with_sharding_constraint``.  A missing hint, or
a plain tensor, is a no-op, so models run unmodified on one device.
``get`` reads the non-sharding values of the context (the active mesh
for the MoE's shard_map dispatch).
"""

from __future__ import annotations

import contextlib
from typing import Any

_HINTS: dict[str, Any] = {}

__all__ = ["hint", "set_hints", "hints_ctx", "get"]


def set_hints(d: dict[str, Any]) -> None:
    global _HINTS
    _HINTS = dict(d)


def get(name: str, default=None):
    """A non-sharding context value (e.g. the active mesh)."""
    return _HINTS.get(name, default)


def hint(x, name: str):
    s = _HINTS.get(name)
    if s is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = s.placements
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


@contextlib.contextmanager
def hints_ctx(d: dict[str, Any]):
    global _HINTS
    old = _HINTS
    _HINTS = dict(d)
    try:
        yield
    finally:
        _HINTS = old
