"""Named device meshes and the per-architecture partition rules (the
port of the JAX package's ``distrib/sharding.py``).

A mesh is ``("data", "model")`` or ``("pod", "data", "model")``: batch
always shards over the data-parallel axes (``dp_axes``), tensor and
expert parallelism over ``model``; the serving engine shards the
candidate (doc) dimension over ``model``.  Its positions are
``torch.device``s.  One device may hold several positions
(``launch.mesh.force_host_device_count``), and then the shards share
it; the production meshes of ``launch.mesh`` lie over ``"meta"``
positions (the dry run's).

A partition spec ``P`` is a tuple with one entry per tensor dimension
(fewer entries leave the trailing dims whole): ``None``, an axis name,
or a tuple of axis names, as ``jax.sharding.PartitionSpec`` holds.  The
rules (``lm_param_specs``, ``recsys_param_specs``, ...) are the
reference's, condition for condition, so a spec tree of the port can be
held against the reference's.  ``NamedSharding(mesh, spec)`` is the
pair a spec is placed by: its ``shard_shape`` is one position's block
(ceiling division, as ``jax.sharding.NamedSharding.shard_shape``), and
``placements`` the same layout as ``torch.distributed.tensor``
placements over the mesh's axes.

``fsdpify`` is the generic ZeRO-3-style annotator: it adds the data axes
to the first still-unsharded dimension whose size divides.  The
reference's ``make_compat_mesh`` and ``compat_shard_map`` are shims over
JAX versions and have no counterpart.
"""

from __future__ import annotations

import math
import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, map_tree, unflatten

__all__ = ["DeviceMesh", "dp_axes", "dp_axis_spec", "MeshInfo", "P",
           "NamedSharding", "stream_shard_spec", "fsdpify",
           "lm_param_specs", "lm_opt_specs", "batch_specs_lm",
           "sage_param_specs", "recsys_param_specs", "tree_shardings",
           "shard_shape", "spec_placements", "spec_leaves"]


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


class DeviceMesh:
    """Named axes over an array of ``torch.device`` positions.

    ``shape`` maps each axis name to its size, in axis order, as a JAX
    mesh's ``shape`` does."""

    def __init__(self, devices, shape, axis_names):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes "
                             f"{axis_names}")
        flat = [torch.device(d) for d in devices]
        if len(flat) != int(np.prod(shape)):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{int(np.prod(shape))} positions, got "
                             f"{len(flat)}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    def grid(self, axis: str) -> list[list[torch.device]]:
        """The positions as rows of ``axis``: one row per coordinate of
        the other axes, flattened in axis order (the order request rows
        split over the data axes), each row in ``axis`` order."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return [list(row) for row in arr.reshape(-1, arr.shape[-1])]


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_axis_spec(mesh: DeviceMesh):
    """The axis entry a batch dimension shards over: every data-parallel
    axis of the mesh (None when it has none; the name alone when one)."""
    dp = dp_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


class MeshInfo:
    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.dp = dp_axes(mesh)
        self.dp_size = int(np.prod([mesh.shape[a] for a in self.dp]))
        self.tp = mesh.shape.get("model", 1)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(spec: P, shape, mesh: DeviceMesh) -> tuple[int, ...]:
    """One position's block of a ``shape`` tensor placed by ``spec``:
    each dim divided by the product of its axes' sizes, rounded up."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(-(-int(d) // math.prod(mesh.shape[a] for a in _axes_of(e)))
                 for d, e in zip(shape, parts))


def spec_placements(spec: P, mesh: DeviceMesh) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one per mesh
    axis in axis order: ``Shard(d)`` on each axis that dim ``d`` names,
    ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if a in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


class NamedSharding:
    """A mesh and a spec: how one tensor is laid over the mesh."""

    def __init__(self, mesh: DeviceMesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(self.spec, shape, self.mesh)

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)

    def shard(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t``'s block for each position, in the mesh's position order
        (row-major over its axes), copied to that position's device.  A
        dim over several axes is split with the first axis major, as
        ``jax.sharding.NamedSharding`` splits it."""
        names = self.mesh.axis_names
        parts = list(self.spec) + [None] * (t.dim() - len(self.spec))
        out = []
        for c in np.ndindex(*self.mesh.devices.shape):
            blk = t
            for d, e in enumerate(parts):
                axes = _axes_of(e)
                if not axes:
                    continue
                sizes = [self.mesh.shape[a] for a in axes]
                i = int(np.ravel_multi_index(
                    [c[names.index(a)] for a in axes], sizes))
                n = -(-t.shape[d] // math.prod(sizes))
                blk = blk.narrow(d, min(i * n, t.shape[d]),
                                 max(min(n, t.shape[d] - i * n), 0))
            out.append(blk.to(self.mesh.devices[c], copy=True))
        return out

    def __repr__(self):
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"


def stream_shard_spec(mesh: DeviceMesh, axis: str = "model") -> P:
    """PartitionSpec of a doc-range-partitioned per-query stream: batch
    over the data-parallel axes, stream columns over the doc shard
    axis (each shard holds only the postings and scores of the docs it
    owns)."""
    return P(dp_axis_spec(mesh), axis)


def fsdpify(spec: P, shape, mesh: DeviceMesh, min_size: int = 2 ** 16) -> P:
    """Add the dp axes to the first unsharded, divisible dim of ``spec``.

    Small tensors (< min_size elements) are left alone: sharding them
    costs more in collective latency than it saves in bytes."""
    if math.prod(shape) < min_size:
        return spec
    dp = dp_axes(mesh)
    dp_n = math.prod(mesh.shape[a] for a in dp)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    # already FSDP'd (idempotent: the optimizer-state widening reapplies it)
    flat = [a for p in parts for a in _axes_of(p)]
    if any(a in flat for a in dp):
        return spec
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % dp_n == 0 and dim >= dp_n:
            parts[i] = dp if len(dp) > 1 else dp[0]
            return P(*parts)
    return spec


def _map_with_path(params: Any, fn) -> Any:
    """``fn(path, leaf)`` over the leaves, the path's keys joined by
    ``/`` (the reference's ``tree_map_with_path`` string)."""
    flat = leaves_with_paths(params)
    return unflatten(params, [fn("/".join(str(k) for k in path), leaf)
                              for path, leaf in flat])


def _replicated(ndim: int) -> P:
    return P(*([None] * ndim))


# ------------------------------------------------------------------- LM --

def lm_param_specs(params: Any, mesh: DeviceMesh, *, fsdp: bool = True):
    """Megatron-style TP + optional FSDP for the transformer LM family;
    ``REPRO_MOE_EP2D`` and ``REPRO_MOE_TPF`` pick the reference's
    expert layouts."""

    def rule(path: str, leaf) -> P:
        shape = leaf.shape
        last = path.rsplit("/", 1)[-1]
        if last in ("embed", "lm_head"):                # vocab-parallel
            spec = P(None, "model")
        elif last in ("w_gate", "w_up", "ff1", "shared_gate", "shared_up"):
            spec = P(*([None] * (len(shape) - 1)), "model")   # col-parallel
        elif last in ("w_down", "ff2", "shared_down"):
            # row-parallel: contracting dim sharded
            spec = P(*([None] * (len(shape) - 2)), "model", None)
        else:
            # attention projections run sequence-parallel (replicated over
            # model, FSDP'd over data), the router, norms, small products
            spec = _replicated(len(shape))
        # MoE expert-parallel overrides: (L, E, D, F) tensors with E
        # divisible by the model axis shard experts instead of features
        if last in ("w_gate", "w_up", "w_down") and len(shape) == 4:
            tp = mesh.shape.get("model", 1)
            dp = dp_axes(mesh)
            dp_n = math.prod(mesh.shape[a] for a in dp)
            if (os.environ.get("REPRO_MOE_EP2D", "0") == "1"
                    and shape[1] % (tp * dp_n) == 0):
                # experts over model and data: weights stay local
                return P(None, ("model",) + dp, None, None)
            if shape[1] % tp == 0 and shape[1] >= tp:
                spec = P(None, "model", None, None)       # EP
            elif os.environ.get("REPRO_MOE_TPF", "0") == "1":
                # the f dim over both axes (Megatron TP widened), so FSDP
                # never lands on the contracting dim
                return (P(None, None, None, ("model", "data"))
                        if last != "w_down"
                        else P(None, None, ("model", "data"), None))
            else:
                spec = (P(None, None, None, "model")
                        if last != "w_down" else P(None, None, "model", None))
        if fsdp:
            spec = fsdpify(spec, shape, mesh)
        return spec

    return _map_with_path(params, rule)


def lm_opt_specs(param_specs: Any, params: Any, mesh: DeviceMesh,
                 zero1: bool = True) -> dict:
    """Optimizer-state specs: the parameters'; ``zero1`` also spreads the
    moments over dp (``fsdpify`` already did where parameters are
    FSDP'd)."""
    flat_p = [leaf for _, leaf in leaves_with_paths(params)]
    flat_s = spec_leaves(param_specs)
    m_specs = unflatten(params, [fsdpify(s, p.shape, mesh) if zero1 else s
                                 for s, p in zip(flat_s, flat_p, strict=True)])
    return {"m": m_specs, "v": m_specs, "step": P()}


def batch_specs_lm(mesh: DeviceMesh) -> P:
    dp = dp_axes(mesh)
    return P(dp if len(dp) > 1 else dp[0])


# ------------------------------------------------------------------ GNN --

def sage_param_specs(params: Any, mesh: DeviceMesh) -> Any:
    """GraphSAGE weights are small: replicated (edge work is what
    shards)."""
    return map_tree(lambda leaf: _replicated(len(leaf.shape)), params)


# --------------------------------------------------------------- recsys --

def recsys_param_specs(params: Any, mesh: DeviceMesh, *,
                       fsdp: bool = True) -> Any:
    """Column-shard embedding tables over 'model' when their width
    divides (else rows); tensor-parallel the wide MLP products;
    replicate the small recurrent cells."""
    tp = mesh.shape.get("model", 1)

    def rule(path: str, leaf) -> P:
        shape = leaf.shape
        last = path.rsplit("/", 1)[-1]
        if "table" in last or last == "items":
            # (V, D) or (F, V, D): shard the last dim if it divides, else rows
            if shape[-1] % tp == 0 and shape[-1] >= tp:
                spec = P(*([None] * (len(shape) - 1)), "model")
            elif shape[0] % tp == 0 and shape[0] >= tp:
                spec = P("model", *([None] * (len(shape) - 1)))
            else:
                spec = _replicated(len(shape))
        elif (last == "w" and len(shape) == 2 and shape[1] % tp == 0
              and shape[1] >= tp and math.prod(shape) >= 2 ** 16):
            spec = P(None, "model")
        else:
            spec = _replicated(len(shape))
        if fsdp:
            spec = fsdpify(spec, shape, mesh)
        return spec

    return _map_with_path(params, rule)


# ---------------------------------------------------------------- misc --

def tree_shardings(mesh: DeviceMesh, spec_tree: Any) -> Any:
    """A ``NamedSharding`` for each spec of ``spec_tree``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def spec_leaves(tree: Any) -> list:
    """The specs of a spec tree in ``tree.leaves`` order (a ``P`` is a
    leaf, not a tuple to walk into)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in spec_leaves(v)]
    return [tree]


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree
