"""Meshes (the port of the JAX package's ``launch/mesh.py``).

``make_production_mesh`` is the dry run's: (data=16, model=16), 256
H100s, or (pod=2, data=16, model=16), 512, with the reference's shapes
and axis names, laid over ``"meta"`` positions (nothing is placed on
them; ``launch.dryrun`` turns the mesh into a ``torch.distributed``
device mesh on a fake process group).  The 'pod' axis carries only
data parallelism and the gradient reduction: the sharding rules never
put tensor or expert parallelism on it.  ``make_smoke_mesh`` is the
one-position mesh with the production axis names.  ``HW`` holds the
card's datasheet figures the dry run's roofline divides by.

``make_serving_mesh`` lays the ``pod x data x model`` positions over the
visible devices of one type, and raises when there are too few.
``force_host_device_count(n)`` is the counterpart of the JAX package's
CPU emulation: the next meshes lay ``n`` positions round-robin over the
visible devices, so the CPU holds 4 or 8 CPU shards and one card 2 or 4
shards.  It takes effect only when a caller asks for it (the CLI's
``--force-host-devices``, the tests); nothing turns it on by itself.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distrib.sharding import DeviceMesh

__all__ = ["make_serving_mesh", "force_host_device_count",
           "visible_positions", "make_production_mesh", "make_smoke_mesh",
           "HW"]

#: One NVIDIA H100 SXM5 80GB at its 700 W limit, from NVIDIA's H100
#: datasheet: dense bf16 tensor-core peak, HBM3 bandwidth, memory.  A
#: 16-wide 'model' axis spans two 8-card nodes, so the one link constant
#: is a card's inter-node bandwidth: one NDR InfiniBand port, 400 Gb/s.
HW = {
    "peak_flops_bf16": 989.4e12,   # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "ib_bw": 50e9,                 # B/s per card, inter-node
    "hbm_bytes": 80 * 2 ** 30,
}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(["meta"] * (512 if multi_pod else 256), shape, axes)


def make_smoke_mesh() -> DeviceMesh:
    """One position with the production axis names (the CPU tests)."""
    return DeviceMesh(["meta"], (1, 1), ("data", "model"))

#: mesh positions forced by ``force_host_device_count`` (0: not forced)
_forced = 0


def force_host_device_count(n: int) -> None:
    """Lay ``n`` mesh positions round-robin over the visible devices from
    now on; ``n = 0`` goes back to one position a device."""
    global _forced
    if n < 0:
        raise ValueError(f"force_host_device_count: n={n} < 0")
    _forced = int(n)


def visible_positions(device) -> list[torch.device]:
    """The mesh positions on ``device``'s type: each card, or the one
    CPU, or ``n`` forced positions laid round-robin over them."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    if _forced:
        return [devs[i % len(devs)] for i in range(_forced)]
    return devs


def make_serving_mesh(n_model: int | None = None, n_data: int = 1,
                      n_pod: int = 1, device=None) -> DeviceMesh:
    """Mesh for the sharded serving engine over ``device``'s type (None:
    the cards).  Candidates (the doc dimension) shard over 'model',
    request batches over ('pod', 'data').  ``n_model=None`` takes every
    position left after the data axes.  Raises when the mesh needs more
    positions than are visible."""
    positions = visible_positions(device)
    n_dev = len(positions)
    if n_model is None:
        n_model = max(1, n_dev // (n_data * n_pod))
    need = n_pod * n_data * n_model
    if need > n_dev:
        raise ValueError(
            f"make_serving_mesh: need {need} devices "
            f"(pod={n_pod} x data={n_data} x model={n_model}) but only "
            f"{n_dev} visible; lay more positions over them with "
            "force_host_device_count(n) first.")
    if n_pod > 1:
        return DeviceMesh(positions[:need], (n_pod, n_data, n_model),
                          ("pod", "data", "model"))
    return DeviceMesh(positions[:need], (n_data, n_model),
                      ("data", "model"))
