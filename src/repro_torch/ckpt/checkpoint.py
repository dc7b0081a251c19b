"""Resumable checkpoints in the JAX package's format (``ckpt/checkpoint.py``).

One directory per step, ``step_%08d``, holds ``manifest.json`` (step,
leaves with name, file, shape and dtype, and ``extra``) and one ``.npy``
per leaf.  A leaf's name is its path joined by ``::``: dict keys in
sorted order and list indices, as ``jax.tree_util`` walks a tree, so a
checkpoint written by either package restores in the other.  The
directory is written as ``.tmp`` and committed by an atomic rename.

Leaves are tensors (on any device) or numpy arrays; ``restore`` returns
each leaf as ``like``'s leaf is: a tensor on its device, or an array.
numpy has no bfloat16, so a bfloat16 tensor (the LM's parameters) is
written as its raw bits, a uint16 array, and read back into a bfloat16
tensor bit for bit (the JAX package writes ``ml_dtypes`` arrays there,
so such a leaf does not cross between the packages).
``restore(..., shardings=)`` is the mesh-elastic restore
(``distrib.elastic``): each leaf comes back as its per-position shards.

``save`` copies one leaf at a time to the host, so its host peak is the
largest leaf; ``AsyncCheckpointer.save`` copies the whole tree to the
host before it returns (training goes on updating the tensors in place)
and writes it on a thread, recording the bytes and seconds of each
write in its ``writes``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten

__all__ = ["save", "restore", "AsyncCheckpointer", "latest_step",
           "tree_bytes"]

_SEP = "::"


def _names_and_leaves(tree: Any):
    flat = leaves_with_paths(tree)
    return [_SEP.join(str(p) for p in path) for path, _ in flat], \
        [leaf for _, leaf in flat]


def tree_bytes(tree: Any) -> int:
    """The bytes of the leaves a checkpoint of ``tree`` writes."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in leaves(tree))


def _to_host(leaf) -> np.ndarray:
    """A numpy copy that later in-place updates of ``leaf`` cannot
    touch."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _write(path: str, names, arrays, step: int, extra) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, arr in zip(names, arrays):
        fn = name.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(path: str, tree: Any, step: int, extra: dict | None = None) -> str:
    """Write ``tree`` atomically to ``{path}/step_{step:08d}``."""
    names, flat = _names_and_leaves(tree)
    return _write(path, names, (_to_host(x) for x in flat), step, extra)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, like: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Load into the structure of ``like``: each leaf a tensor on the
    device of ``like``'s tensor there, or a numpy array.  With
    ``shardings`` (a tree of ``distrib.sharding.NamedSharding``, possibly
    of another mesh than the one that wrote the checkpoint: the elastic
    restore) each leaf is the list of its per-position shards instead,
    each on its position's device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {rec["name"]: rec for rec in manifest["leaves"]}
    names, flat = _names_and_leaves(like)
    shard_flat = ([None] * len(flat) if shardings is None
                  else _sharding_leaves(shardings))
    out = []
    for name, leaf, sh in zip(names, flat, shard_flat, strict=True):
        arr = np.load(os.path.join(d, by_name[name]["file"]))
        if isinstance(leaf, torch.Tensor) or sh is not None:
            arr = np.asarray(arr, order="C")
            if getattr(leaf, "dtype", None) == torch.bfloat16:
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                arr = torch.from_numpy(arr)
            arr = sh.shard(arr) if sh is not None else arr.to(leaf.device)
        out.append(arr)
    return unflatten(like, out), manifest["extra"]


def _sharding_leaves(tree) -> list:
    """The shardings of a tree in leaf order (a sharding is a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _sharding_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _sharding_leaves(v)]
    return [tree]


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writer (one in flight at a time)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: one record per committed write: step, bytes, seconds (the
        #: host copy included)
        self.writes: list[dict] = []

    def save(self, tree: Any, step: int, extra: dict | None = None):
        self.wait()
        t0 = time.perf_counter()
        names, flat = _names_and_leaves(tree)
        host = [_to_host(x) for x in flat]

        def run():
            try:
                _write(self.path, names, host, step, extra)
                self.writes.append({"step": step, "bytes": sum(
                    a.nbytes for a in host), "seconds":
                    time.perf_counter() - t0})
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.path) if d.startswith("step_")
            and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)
