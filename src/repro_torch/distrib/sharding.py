"""Named device meshes for sharded serving (the serving subset of the JAX
package's ``distrib/sharding.py``).

A mesh is ``("data", "model")`` or ``("pod", "data", "model")``: the
candidate (doc) dimension shards over ``model``, request batches over
the data-parallel axes (``dp_axes``).  Its positions are
``torch.device``s; one device may hold several positions
(``launch.mesh.force_host_device_count``), and then the shards share it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeviceMesh", "dp_axes", "dp_axis_spec", "MeshInfo"]


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
