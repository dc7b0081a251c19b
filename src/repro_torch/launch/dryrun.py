"""Dry run: trace every (arch x shape x mesh) cell on fake tensors and
size it for a many-card H100 deployment (the port of the JAX package's
``launch/dryrun.py``).

The reference compiles each cell for 256 or 512 placeholder devices and
reads the compiled artifact.  Here each cell's step runs once, at full
depth, on ``FakeTensor``s (shapes and dtypes, no storage): its
arguments are ``torch.distributed.tensor`` DTensors placed by the
bundle's ``NamedSharding``s over the production mesh, on a fake process
group of 256 or 512 ranks, and DTensor's sharding propagation decides
the per-device computation and its collectives, as GSPMD does for the
reference.  The bundle's activation hints are installed around the
step (``distrib.hints.hints_ctx``), as the reference installs them
around its compile, and the model code applies them where the
reference does: ``lm_activations`` pins an LM's residual stream
(sequence over ``model``; each product in a pinned layer runs on the
device's blocks, ``layers.linear``), ``attn_q`` its attention's
queries, ``moe_buffer`` the gspmd MoE dispatch's expert buffer, and
the ``mesh`` decides the shard_map dispatch under
``REPRO_MOE_SHARDMAP=1``.  ``Tracker``, a ``TorchDispatchMode`` under
DTensor, sees
the ops one device (rank 0) runs on its shards and gives the record:

  * memory — the bytes of the storages alive at each op: arguments,
    outputs, the outputs that alias donated arguments, the peak;
  * cost — the FLOPs of those ops (``torch.utils.flop_counter``'s
    formulas, flash_attention's registered beside them) and the bytes
    each op reads and writes (views excluded);
  * collectives — the result bytes of each all-gather, reduce-scatter,
    all-reduce and all-to-all, by kind (the reference parses them out
    of the HLO text; there is no HLO here);
  * roofline — those over the H100 SXM5's datasheet rates
    (``launch.mesh.HW``), the dominant term, and the model FLOPs'
    share.

A multi-pod mesh is traced as its flat (pod*data) x model mesh (see
``trace_bundle``).  An indexed write into a sharded DTensor (a cache
slot) writes each device's block in place (``_local_write``).  A view
DTensor refuses is retried with the reshaped dims gathered
(``_regathered_view``).  Any other op DTensor has no sharding strategy
for, or whose strategy fails on fake tensors (a data-dependent step, a
refused in-place placement change), runs replicated: its arguments
whole on the device (their bytes counted as gathered), a written
argument keeping its block; the record lists those ops under
``replicated_ops``.  The kernel wrappers a bundle reaches return their
outputs' shapes on fake tensors and launch nothing.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all-cells --mesh both --jobs 4

Each record is a JSON file under ``--out`` (git-ignored
``build/repro_torch/dryrun`` by default); a cell that raises is
recorded with ``status: "error"``.  The fake process group belongs to
its process (``torch_mesh`` makes it once, of 512 ranks): nothing else
in the process may use ``torch.distributed``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base as cfgbase
from repro_torch.distrib import hints as H
from repro_torch.distrib.sharding import DeviceMesh, NamedSharding, P
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.tree import leaves, unflatten

__all__ = ["Tracker", "trace", "trace_bundle", "run_cell", "main",
           "argument_bytes", "kernel_launches", "COLLECTIVE_KINDS"]

#: functional collective op -> the reference's (HLO) collective kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _metadata_methods():
    """DTensor's methods that run ops for metadata only, muted while the
    tracker is on: (class, name, run on real tensors).  Sharding
    propagation runs ops on fake global shapes (output metadata,
    decompositions); a strided shard's size and offset come from an
    index tensor of the dim's length, whose values a fake tensor would
    not have (``_strided_size_and_offset`` computes the common cases
    without it)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    return [(ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
            (ShardingPropagator, "propagate_op_sharding_non_cached", False),
            (_StridedShard, "local_shard_size_and_offset", True)]


def _strided_size_and_offset(orig):
    """``_StridedShard.local_shard_size_and_offset`` by arithmetic where
    it asks for the first offset or none: the dim is split into
    ``split_factor`` pieces and each piece into ``num_chunks`` chunks
    (ceiling division, as ``torch.chunk``), rank r holding chunk r of
    every piece.  The original builds an index tensor of the dim's
    length for it (a table's 40 M rows at wide-deep); it still answers a
    request for every offset."""
    import inspect
    sig = inspect.signature(orig)

    def fast(self, *args, **kwargs):
        b = sig.bind(self, *args, **kwargs)
        b.apply_defaults()
        a = b.arguments
        # FIRST / NONE (or the older ``return_first_offset=True``)
        mode = a.get("offset_mode", a.get("return_first_offset"))
        mode = getattr(mode, "name", mode)
        n, chunks, r = (a.get("curr_local_size"), a.get("num_chunks"),
                        a.get("rank"))
        if mode not in ("FIRST", "NONE", True) or not all(
                isinstance(x, int) for x in (n, chunks, r)):
            return orig(self, *args, **kwargs)
        piece = -(-n // int(self.split_factor))
        size, first = 0, None
        for i in range(int(self.split_factor)):
            lo, hi = min(piece * i, n), min(piece * (i + 1), n)
            step = -(-(hi - lo) // chunks)
            s0, s1 = min(step * r, hi - lo), min(step * (r + 1), hi - lo)
            if s1 > s0:
                first = lo + s0 if first is None else first
                size += s1 - s0
        if mode == "NONE":
            return size, None
        return size, -1 if first is None else first

    return fast


#: the view ops a refused split is retried for (``_regathered_view``)
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default)
#: ops that allocate without writing: no bytes moved
_ALLOCATIONS = ("empty", "empty_strided", "new_empty", "new_empty_strided",
                "empty_like")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tracker(TorchDispatchMode):
    """Counts what one device runs: FLOPs, bytes read and written, the
    result bytes of each collective kind, and the bytes of the live
    storages (current and peak).

    Entered above a ``FakeTensorMode`` (or over real tensors).  An op on
    DTensors is handed to DTensor (the mode returns ``NotImplemented``
    for it, so the local ops it runs come back here); the ops DTensor's
    sharding propagation runs on global shapes to learn output metadata
    are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.replicated_ops: dict[str, int] = {}
        self._storages: dict[int, tuple] = {}
        self._defer = None
        self._muted = 0
        self._dtensor = None
        self._patched = None
        self._depth = 0

    # ---------------------------------------------------------- storages --
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (a meta
        tensor's holds nothing)."""
        if t.is_meta:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = (weakref.ref(st, self._freed(key)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key):
        def cb(_):
            rec = self._storages.pop(key, None)
            if rec is not None:
                self.live -= rec[1]
        return cb

    @staticmethod
    def storages(tree) -> dict[int, int]:
        """{storage key: bytes} of the local tensors of ``tree``."""
        out = {}
        for t in leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            t = getattr(t, "_local_tensor", t)
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
        return out

    # ------------------------------------------------------------ enter --
    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._depth += 1
        if self._patched is None:
            self._patched = [(cls, name, getattr(cls, name), real)
                             for cls, name, real in _metadata_methods()]
            for cls, name, orig, real in self._patched:
                if name == "local_shard_size_and_offset":
                    orig = _strided_size_and_offset(orig)
                setattr(cls, name, self._muting(orig, real))
        return super().__enter__()

    def _muting(self, orig, real: bool):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def muted(*args, **kwargs):
            self._muted += 1
            try:
                with (unset_fake_temporarily() if real
                      else contextlib.nullcontext()):
                    return orig(*args, **kwargs)
            finally:
                self._muted -= 1
        return muted

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0 and self._patched is not None:
            for cls, name, orig, _ in self._patched:
                setattr(cls, name, orig)
            self._patched = None
        return out

    # --------------------------------------------------------- dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            if (func is torch.ops.aten.index_put_.default
                    and isinstance(args[0], self._dtensor)):
                return self._local_write(func, args, kwargs)
            if self._defer is func:
                self._defer = None
                return NotImplemented
            self._defer = func
            try:
                with self:
                    return func(*args, **kwargs)
            except Exception:
                # no strategy, a refused placement change, or a data-
                # dependent step of one: a genuine fault in the op
                # raises again when it runs replicated
                self._defer = None
                if func in _VIEWS:
                    out = self._regathered_view(func, args, kwargs)
                    if out is not None:
                        return out
                return self._replicated(func, args, kwargs)
            finally:
                self._defer = None
        out = func(*args, **kwargs)
        if not self._muted:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        outs = [o for o in leaves(out) if isinstance(o, torch.Tensor)]
        for o in outs:
            self.track(o)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                    _nbytes(o) for o in outs)
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if func.is_view or not outs or name in _ALLOCATIONS:
            return
        ins = [a for a in leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(o) for o in outs)

    def _regathered_view(self, func, args, kwargs):
        """A view DTensor refuses (a split of a dim sharded unevenly):
        the dims it reshapes gathered first, the leading dims it keeps
        left sharded, then the view again.  None where nothing would
        change (the caller then runs it replicated)."""
        from torch.distributed.tensor import Replicate
        x, shape = args[0], list(args[1])
        if -1 in shape:
            known = math.prod(d for d in shape if d != -1)
            shape[shape.index(-1)] = x.numel() // max(known, 1)
        keep = 0
        while (keep < min(x.dim(), len(shape))
               and x.shape[keep] == shape[keep]):
            keep += 1
        pl = [Replicate() if getattr(p, "dim", -1) >= keep else p
              for p in x.placements]
        if pl == list(x.placements):
            return None
        with self:
            return func(x.redistribute(x.device_mesh, pl), *args[1:],
                        **kwargs)

    def _local_write(self, func, args, kwargs):
        """An indexed write into a sharded DTensor (a decode step's cache
        slot): each device writes the rows its block holds, in place, no
        collective (as the reference's dynamic update of a sharded cache
        compiles).  On fake tensors the index values carry nothing, so
        the write is a local ``index_put_`` of as many rows as the
        narrowest index gives, with values of the block's shape."""
        dst, indices = args[0], args[1]
        local = dst._local_tensor
        idx = [None if i is None else getattr(i, "_local_tensor", i)
               for i in indices]
        n = min(i.shape[0] for i in idx if i is not None)
        idx = [None if i is None else i[:n] for i in idx]
        vals = local.new_empty((n, *local.shape[len(idx):]))
        with self:
            func(local, idx, vals, *args[3:], **kwargs)
        return dst

    def _replicated(self, func, args, kwargs):
        """``func`` run whole on the device: each DTensor argument not
        already replicated is gathered (a whole tensor, its bytes counted
        as an all-gather, or an all-reduce of a partial sum), written
        arguments keep their own placements (their local blocks stand
        for the scatter back), other outputs are replicated DTensors.
        Values are not moved: this runs on fake tensors only, and goes
        through no DTensor op, so a refusal cannot recur."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_map
        name = str(func)
        self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
        flat, _ = tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        with self:
            def local(x):
                if not isinstance(x, DTensor):
                    return x
                if all(p.is_replicate() for p in x.placements):
                    return x._local_tensor
                whole = torch.empty(x.shape, dtype=x.dtype,
                                    device=x._local_tensor.device)
                kind = ("all-reduce" if all(p.is_partial() or p.is_replicate()
                                            for p in x.placements)
                        else "all-gather")
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + _nbytes(whole))
                return whole
            largs, lkwargs = tree_map(local, (args, kwargs))
            out = func(*largs, **lkwargs)
            written = {id(largs[i]): args[i]
                       for i, a in enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write
                       and i < len(args) and isinstance(args[i], DTensor)}

            def wrap(o):
                if not isinstance(o, torch.Tensor):
                    return o
                if id(o) in written:
                    return written[id(o)]
                return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return tree_map(wrap, out)


# -------------------------------------------------------------- placing --

#: ranks of the fake process group: the largest production mesh's; a
#: smaller mesh takes its first ranks
FAKE_WORLD = 512
_MESHES: dict = {}


def torch_mesh(mesh):
    """The mesh as a ``torch.distributed`` device mesh over the first
    ranks of a fake process group of ``FAKE_WORLD`` ranks (made once a
    process; a mesh once a shape, so DTensor's caches never see a stale
    group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = tuple(mesh.shape.values()), tuple(mesh.axis_names)
    if (shape, names) not in _MESHES:
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=FAKE_WORLD)
        _MESHES[shape, names] = DeviceMesh(
            "cpu", torch.arange(math.prod(shape)).view(shape),
            mesh_dim_names=names)
    return _MESHES[shape, names]


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= max(int(d), 1)
    return tuple(reversed(out))


def _flat_shardings(like, shardings) -> list:
    """The shardings of ``like``'s leaves in leaf order (a sharding tree
    may stop at a leaf's position, as the reference's prefix trees do)."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return [shardings] * len(leaves(like))
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _flat_shardings(like[k], shardings[k])]
    if isinstance(like, (list, tuple)):
        return [s for v, sv in zip(like, shardings, strict=True)
                for s in _flat_shardings(v, sv)]
    raise ValueError(f"no sharding for a leaf: {shardings!r}")


def argument_bytes(bundle) -> tuple[int, int]:
    """(per-device argument bytes, per-device bytes of the donated
    arguments) of ``bundle``, from its shardings' shard shapes."""
    total = alias = 0
    for i, (arg, sh) in enumerate(zip(bundle.args, bundle.in_shardings)):
        for t, s in zip(leaves(arg), _flat_shardings(arg, sh)):
            n = math.prod(s.shard_shape(t.shape)) * t.element_size()
            total += n
            if i in bundle.donate_argnums:
                alias += n
    return total, alias


def place(args, shardings, tmesh, device="cpu") -> tuple:
    """Fake local shards of ``args`` (global fake tensors) as DTensors
    over ``tmesh`` (plain fake tensors of the global shape without a
    mesh)."""
    from torch.distributed.tensor import DTensor
    out = []
    for arg, sh in zip(args, shardings):
        flat = []
        for t, s in zip(leaves(arg), _flat_shardings(arg, sh)):
            if tmesh is None:
                flat.append(torch.empty(t.shape, dtype=t.dtype,
                                        device=device))
                continue
            local = torch.empty(s.shard_shape(t.shape), dtype=t.dtype,
                                device=device)
            flat.append(DTensor.from_local(
                local, tmesh, s.placements, run_check=False,
                shape=t.shape, stride=_contiguous_strides(t.shape)))
        out.append(unflatten(arg, flat))
    return tuple(out)


# -------------------------------------------------------------- tracing --

def trace(fn, make_args, *, donate_argnums=(), hints=None) -> dict:
    """Run ``fn(*make_args())`` once under a ``Tracker`` (inside the
    process's fake mode when the arguments are fake) and return its
    counts: memory (argument, output, alias, temp and peak bytes),
    FLOPs, bytes, collectives and the ops that ran replicated.
    ``make_args`` runs under the tracker, so the arguments' storages are
    counted from the start."""
    tr = Tracker()
    with contextlib.ExitStack() as stack:
        stack.enter_context(tr)
        args = make_args()
        arg_st = Tracker.storages(args)
        for t in leaves(args):
            if isinstance(t, torch.Tensor):
                tr.track(getattr(t, "_local_tensor", t))
        donated = {}
        for i in donate_argnums:
            donated.update(Tracker.storages(args[i]))
        stack.enter_context(H.hints_ctx(hints or {}))
        out = fn(*args)
        out_st = Tracker.storages(out)
    alias = sum(n for k, n in out_st.items() if k in donated)
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "alias_bytes": alias,
            "temp_bytes": max(tr.peak - arg_b - out_b + alias, 0),
            "peak_estimate_bytes": tr.peak,
        },
        "flops": tr.flops,
        "bytes": tr.bytes,
        "collectives": dict(sorted(tr.collectives.items())),
        "replicated_ops": dict(sorted(tr.replicated_ops.items())),
    }


def _without_pods(tree, flat):
    """A sharding tree of a ``pod x data x model`` mesh over the flat
    ``(pod*data) x model`` mesh ``flat``: 'pod' merged into 'data'."""

    def entry(e):
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a is not None and a != "pod")
        if e is None or not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    if isinstance(tree, NamedSharding):
        return NamedSharding(flat, P(*(entry(e) for e in tree.spec)))
    if isinstance(tree, dict):
        return {k: _without_pods(v, flat) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_without_pods(v, flat) for v in tree)
    return tree


def trace_bundle(bundle, mesh, device="cpu") -> dict:
    """``trace`` of a bundle's step, its arguments placed over ``mesh``
    (one position: plain fake tensors; more: DTensors on the fake
    group).  A multi-pod mesh is traced as its flat ``(pod*data) x
    model`` mesh: 'pod' carries only data parallelism and every rule
    puts it beside 'data', so each device's blocks, products and
    collective bytes are the same."""
    from torch.distributed.tensor.experimental import implicit_replication
    n = math.prod(mesh.shape.values())
    shardings, hints = bundle.in_shardings, dict(bundle.hints)
    if "pod" in mesh.shape:
        mesh = DeviceMesh(list(mesh.devices.flat),
                          (mesh.shape["pod"] * mesh.shape["data"],
                           mesh.shape["model"]), ("data", "model"))
        shardings = _without_pods(shardings, mesh)
        hints = {k: mesh if k == "mesh" else _without_pods(v, mesh)
                 for k, v in hints.items()}
    tmesh = torch_mesh(mesh) if n > 1 else None
    with cfgbase.fake_mode(), implicit_replication():
        return trace(bundle.fn,
                     lambda: place(bundle.args, shardings, tmesh, device),
                     donate_argnums=bundle.donate_argnums, hints=hints)


def kernel_launches() -> dict[str, int]:
    """The four kernels' launch counters (a trace moves none of them)."""
    import importlib
    return {k: importlib.import_module(
        f"repro_torch.kernels.{k}.kernel").n_launches
        for k in ("impact_scan", "topk", "flash_attention", "embedding_bag")}


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """One cell's record: the ``"mem"`` bundle (full depth) traced once
    on the production mesh; the multi-pod record drops the roofline, as
    the reference's does."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    mod = cfgbase.get(arch)
    mesh_name = "multi" if multi_pod else "single"
    if shape in mod.SKIPS:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": mod.SKIPS[shape]}
    t0 = time.time()
    before = kernel_launches()
    bundle = mod.dryrun_bundle(shape, mesh, mode="mem")
    res = trace_bundle(bundle, mesh)
    t_trace = time.time() - t0
    moved = {k: n - before[k] for k, n in kernel_launches().items()}
    n_chips = math.prod(mesh.shape.values())
    flops_dev, bytes_dev = res["flops"], res["bytes"]
    coll = res["collectives"]
    coll_total = float(sum(coll.values()))
    meta = {k: v for k, v in bundle.meta.items() if k != "l1_bundle"}
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "status": "ok",
        "n_chips": n_chips,
        "probe": "one full-depth fake-tensor trace of the 'mem' bundle",
        "mem_probe_s": round(t_trace, 1),
        "cost_probe_s": 0.0,
        "memory": res["memory"],
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives": coll,
        "collective_bytes_per_device": coll_total,
        "roofline": {
            "compute_s": flops_dev / HW["peak_flops_bf16"],
            "memory_s": bytes_dev / HW["hbm_bw"],
            "collective_s": coll_total / HW["ib_bw"],
        },
        "replicated_ops": res["replicated_ops"],
        "kernel_launches": moved,
        "meta": meta,
    }
    r = rec["roofline"]
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=r.get)
    mf = meta.get("model_flops")
    if mf:
        r["model_flops"] = mf
        r["useful_flops_frac"] = mf / n_chips / max(flops_dev, 1.0)
        ideal = mf / n_chips / HW["peak_flops_bf16"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        r["roofline_fraction"] = ideal / max(bound, 1e-30)
    rec["memory"]["fits_hbm"] = (
        rec["memory"]["peak_estimate_bytes"] <= HW["hbm_bytes"])
    if multi_pod:
        rec["roofline"] = {"note": "single-pod records carry the roofline"}
        del rec["cost"]
    return rec


#: the archs whose cells trace longest (61 and 56 MoE layers)
_LONGEST = ("deepseek-v3-671b", "mixtral-8x22b")


def _cell(job) -> dict:
    arch, shape, mp = job
    try:
        return run_cell(arch, shape, mp)
    except Exception as e:  # recorded: a failing cell is a bug
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single", "status": "error",
                "error": repr(e), "traceback": traceback.format_exc()[-4000:]}


def _line(rec: dict) -> str:
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec["status"] == "ok":
        m = rec["memory"]
        extra = (f" trace={rec['mem_probe_s']}s"
                 f" peak={m['peak_estimate_bytes'] / 2 ** 30:.2f}GiB"
                 f" fits={m['fits_hbm']}"
                 + (f" dom={rec['roofline']['dominant']}"
                    if "dominant" in rec["roofline"] else ""))
    else:
        extra = " " + rec.get("reason", rec.get("error", ""))[:140]
    return f"[dryrun] {tag} -> {rec['status']}{extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all-cells", action="store_true")
    ap.add_argument("--out", default="build/repro_torch/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each holds its own fake group)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all_cells:
        cells = [(a, s) for a in cfgbase.ALL_ARCHS
                 for s in cfgbase.get(a).SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all-cells")
        cells = [(args.arch, args.shape)]
    jobs = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            if os.path.exists(os.path.join(args.out, tag + ".json")):
                print(f"[skip existing] {tag}")
                continue
            jobs.append((arch, shape, mp))

    # the longest traces first, so no worker is left with one at the end
    jobs.sort(key=lambda j: j[0] not in _LONGEST)

    def write(rec):
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(_line(rec), flush=True)

    if args.jobs <= 1:
        for job in jobs:
            write(_cell(job))
        return
    import concurrent.futures as cf
    import multiprocessing as mp_
    with cf.ProcessPoolExecutor(args.jobs, mp_context=mp_.get_context("spawn"),
                                initializer=torch.set_num_threads,
                                initargs=(1,)) as ex:
        for rec in ex.map(_cell, jobs):
            write(rec)


if __name__ == "__main__":
    main()
