"""Cross-shard operations of the sharded serving engine (the port of the
JAX package's ``distrib/collectives.py``).

The JAX package runs them inside ``shard_map`` (``all_gather``,
``pmax``, ``pmin``, ``psum``, ``pmean``, ``all_to_all``).  Here one
process drives every shard, and a collective is a function over the
list of per-shard tensors, in shard order, that returns one result on
each shard's device: ``all_gather`` copies every shard's tensor to each
device and concatenates them in shard order, ``pmax``, ``pmin``,
``psum`` and ``pmean`` stack and reduce, ``all_to_all`` exchanges
equal chunks (the MoE's expert dispatch).  The gather and the max and
min are exact, so the sharded engine's arithmetic is the unsharded
one's.  Shards that share a device share one reduced tensor.

``sharded_topk`` is the distributed form of the k knob: candidates are
split over the shards in equal doc ranges, each shard extracts its local
top-k, and only the (value, global id) survivors cross between shards.
Ties go to the lowest global id, as ``jax.lax.top_k`` sends them to the
lowest index:

* the local top-k is clamped to the shard width, so ``k`` may exceed
  ``N // n_shards``;
* ``N % n_shards != 0`` pads the candidates with sentinel (-inf)
  columns before the split, so every global id is the true column;
* within a shard's survivors ties already ascend by id, and the blocks
  are concatenated in ascending doc range, so a stable descending sort
  of the gathered values keeps the lowest global id of a tie (the
  ``lax.top_k`` lowest-position rule the JAX merge relies on, which
  ``torch.topk`` does not give).  ``+0.0`` and ``-0.0`` compare equal
  in that sort, as in the ``topk`` kernel; the engine's scores are
  never ``-0.0``.

On a DTensor (the dry run's, its columns sharded over ``axis``),
``sharded_topk`` runs the same steps as one device's program, as the
reference's ``shard_map`` body does: its local block (sentinel-padded to
the shard width), a local top-k, global ids from its coordinate on
``axis``, the survivors all-gathered over ``axis`` as a functional
collective (the dry run's tracker counts it), and the merge.
"""

from __future__ import annotations

import torch

from repro_torch.device import device_scope, is_dtensor

__all__ = ["sharded_topk", "merge_local_topk", "gather_local_topk",
           "merge_gathered_topk", "require_axis", "all_gather", "pmax",
           "pmin", "pmean", "psum", "all_to_all", "per_device"]


def require_axis(mesh, axis: str, what: str = "sharded_topk") -> int:
    """Validate that ``axis`` names a mesh axis; returns its size."""
    if axis not in mesh.shape:
        raise ValueError(
            f"{what}: axis {axis!r} is not an axis of the mesh "
            f"(axes: {tuple(mesh.axis_names)}). Pass axis=<one of those> "
            "or build the mesh with the expected axis name.")
    return int(mesh.shape[axis])


def per_device(devices, fn) -> list:
    """``fn(i)`` for the first shard ``i`` on each distinct device of
    ``devices`` (run with that device current), one result per shard:
    shards that share a device share the result."""
    first = {}
    for i, d in enumerate(devices):
        if d not in first:
            with device_scope(d):
                first[d] = fn(i)
    return [first[d] for d in devices]


def all_gather(xs, dim: int = 1) -> list[torch.Tensor]:
    """Every shard's tensor, concatenated along ``dim`` in shard order,
    on each shard's device."""
    devs = [x.device for x in xs]
    return per_device(devs, lambda i: torch.cat(
        [x.to(devs[i]) for x in xs], dim=dim))


def pmax(xs) -> list[torch.Tensor]:
    devs = [x.device for x in xs]
    return per_device(devs, lambda i: torch.stack(
        [x.to(devs[i]) for x in xs]).amax(dim=0))


def pmin(xs) -> list[torch.Tensor]:
    devs = [x.device for x in xs]
    return per_device(devs, lambda i: torch.stack(
        [x.to(devs[i]) for x in xs]).amin(dim=0))


def psum(xs) -> list[torch.Tensor]:
    """The sum over the shards (in shard order), on each shard's device."""
    devs = [x.device for x in xs]
    return per_device(devs, lambda i: torch.stack(
        [x.to(devs[i]) for x in xs]).sum(dim=0).to(xs[0].dtype))


def pmean(xs) -> list[torch.Tensor]:
    """The mean over the shards, on each shard's device."""
    devs = [x.device for x in xs]
    return per_device(devs, lambda i: torch.stack(
        [x.to(devs[i]) for x in xs]).mean(dim=0))


def all_to_all(xs, split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """The tiled all-to-all of ``jax.lax.all_to_all``: each of the n
    shards splits its tensor into n equal chunks along ``split_dim``;
    shard j receives the j-th chunk of every shard, concatenated in
    shard order along ``concat_dim``, on its own device."""
    n = len(xs)
    chunks = [torch.chunk(x, n, dim=split_dim) for x in xs]
    return [torch.cat([chunks[m][j].to(xs[j].device) for m in range(n)],
                      dim=concat_dim) for j in range(n)]


def gather_local_topk(vs, gis):
    """The collective half of ``merge_local_topk``: every shard's (B, kl)
    survivors gathered into flat (B, S*kl) value and id matrices on each
    shard's device (the engine runs it as its own dispatch)."""
    return all_gather(vs), all_gather(gis)


def _stable_top(v: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest of each row, ties to the lower
    position: a stable descending sort (no negation, so integer minima
    sort last too)."""
    return torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]


def merge_gathered_topk(vflat: torch.Tensor, gflat: torch.Tensor, k: int):
    """The arithmetic half of ``merge_local_topk``: the gathered
    survivors down to the top-k, value descending, ties to the lowest
    global id (a stable sort: see the module docstring).

    Returns (values (B, k), ids (B, k)), padded with (-inf, -1) in the
    impossible case that fewer than k survivors exist."""
    take = min(k, vflat.shape[1])
    order = _stable_top(vflat, take)
    mv, mg = vflat.gather(1, order), gflat.gather(1, order)
    if take < k:
        pad = (0, k - take)
        mv = torch.nn.functional.pad(mv, pad, value=float("-inf"))
        mg = torch.nn.functional.pad(mg, pad, value=-1)
    return mv, mg


def merge_local_topk(vs, gis, k: int):
    """Merge per-shard top-k survivors (values and *global* ids, each
    (B, kl), in shard order) into the global top-k on each shard's
    device.  Only the survivors cross between shards."""
    vflat, gflat = gather_local_topk(vs, gis)
    return per_device([v.device for v in vs], lambda i: merge_gathered_topk(
        vflat[i], gflat[i], k))


def sharded_topk(mesh, scores: torch.Tensor, k: int, axis: str = "model"):
    """Top-k over (B, N) scores split over ``axis`` of ``mesh``: the
    columns in equal doc ranges, shard ``s`` on the ``s``-th device of
    ``axis`` (the first row of the other axes).

    Returns (values (B, k), global ids (B, k) int32) on ``scores``'
    device, ties to the lowest id."""
    n = scores.shape[-1]
    n_shards = require_axis(mesh, axis)
    if not 1 <= k <= n:
        raise ValueError(f"sharded_topk: k={k} outside [1, N={n}]")
    pad = (-n) % n_shards
    sentinel = (float("-inf") if scores.dtype.is_floating_point
                else torch.iinfo(scores.dtype).min)
    width = (n + pad) // n_shards
    kl = min(k, width)
    if is_dtensor(scores):
        return _sharded_topk_dtensor(scores, k, axis, width, kl, sentinel)
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=sentinel)
    vs, gis = [], []
    for s, dev in enumerate(mesh.grid(axis)[0]):
        with device_scope(dev):
            local = scores[:, s * width:(s + 1) * width].to(dev)
            i = _stable_top(local, kl)
            vs.append(local.gather(1, i))
            gis.append((i + s * width).to(torch.int32))
    v, g = merge_local_topk(vs, gis, k)[0]
    return v.to(scores.device), g.to(scores.device)


def _sharded_topk_dtensor(scores, k: int, axis: str, width: int, kl: int,
                          sentinel):
    """``sharded_topk`` of a DTensor (B, N): one device's program.  Its
    block of ``width`` columns (the last one's short block padded with
    ``sentinel``, as the reference pads N), a stable local top-``kl``,
    global ids, an all-gather of the (B, kl) survivors over ``axis`` in
    coordinate order, and ``merge_gathered_topk``; the results come back
    replicated."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tm = scores.device_mesh
    dim = tm.mesh_dim_names.index(axis)
    pl = [Shard(1) if i == dim else Replicate() for i in range(tm.ndim)]
    local = scores.redistribute(tm, pl).to_local()
    if local.shape[1] < width:
        local = torch.nn.functional.pad(
            local, (0, width - local.shape[1]), value=sentinel)
    i = _stable_top(local, kl)
    base = tm.get_local_rank(dim) * width
    v = local.gather(1, i)
    gi = (i + base).to(torch.int32)
    vflat = funcol.all_gather_tensor(v, 1, (tm, dim))
    gflat = funcol.all_gather_tensor(gi, 1, (tm, dim))
    mv, mg = merge_gathered_topk(vflat, gflat, k)
    rep = [Replicate()] * tm.ndim
    return (DTensor.from_local(mv, tm, rep, run_check=False),
            DTensor.from_local(mg, tm, rep, run_check=False))
