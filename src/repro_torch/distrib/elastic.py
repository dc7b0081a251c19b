"""Elastic scaling: restore any checkpoint onto any mesh (the port of the
JAX package's ``distrib/elastic.py``).

Checkpoints carry logical structure only (``ckpt/checkpoint.py``);
resharding is re-running the architecture's sharding rules against the
*new* mesh and placing each leaf.  A placed leaf is the list of its
per-position shards, in the mesh's position order, each on its
position's device (``sharding.NamedSharding.shard``), the layout one
process driving every position serves from.  This covers scale-up,
scale-down and pod-count changes; with ``ckpt/failover.py`` it gives
the "lose a pod, continue on the survivors" story.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.distrib import sharding as S
from repro_torch.tree import leaves, unflatten

__all__ = ["reshard", "restore_elastic"]


def reshard(tree: Any, mesh: S.DeviceMesh,
            spec_fn: Callable[[Any, S.DeviceMesh], Any]) -> Any:
    """``tree`` placed by the specs ``spec_fn(tree, mesh)``: each leaf
    the list of its per-position shards."""
    specs = S.spec_leaves(spec_fn(tree, mesh))
    return unflatten(tree, [S.NamedSharding(mesh, s).shard(t)
                            for t, s in zip(leaves(tree), specs,
                                            strict=True)])


def restore_elastic(path: str, like: Any, mesh: S.DeviceMesh,
                    spec_fn: Callable[[Any, S.DeviceMesh], Any],
                    step: int | None = None) -> tuple[Any, dict]:
    """Load a checkpoint written on *any* mesh onto ``mesh``."""
    shardings = S.tree_shardings(mesh, spec_fn(like, mesh))
    return ckpt.restore(path, like, step=step, shardings=shardings)
