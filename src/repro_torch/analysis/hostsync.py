"""Host-sync detector of the port: no stream syncs in the hot path.

The counterpart of the JAX package's ``analysis/hostsync.py`` in torch
idiom.  On the card a call that waits for the stream serializes the
host's enqueue with the device's work, once per batch (or per decode
layer): invisible in correctness tests, ruinous at p99, and it forbids a
captured CUDA graph.  The pass flags, in the hot scopes below:

* ``hostsync/blocking-sync``: ``torch.cuda.synchronize()``, a
  ``Stream``/``Event`` ``.synchronize()``, and the port's timing fence
  ``fence(...)`` (``repro_torch.device.fence``), which waits for the
  calling thread's stream;
* ``hostsync/device-to-host``: ``.item()``, ``.tolist()``, ``.cpu()``
  and ``.numpy()`` (``x.cpu().numpy()`` is one finding);
* ``hostsync/host-to-device``: ``torch.tensor(..., device=...)`` and
  ``torch.as_tensor(..., device=...)``, and ``.to(<device>)`` or
  ``.cuda()`` of host data (``torch.from_numpy``, ``torch.tensor``,
  ``torch.as_tensor`` without a device, or a name bound to one of them
  in the same function): a copy from pageable memory waits for the
  stream.  A copy from ``.pin_memory()`` with ``non_blocking=True`` does
  not, and is not flagged.

Vetted exceptions (the timing fences, the ranked-list boundary) live in
``src/repro_torch/analysis/baseline.json`` with notes; anything new
fails.  What no AST can see -- ``int(t)`` or ``bool(t)`` of a CUDA
tensor, a data-dependent shape (``nonzero``, boolean masks,
``unique``) -- the runtime sanitizer ``sanitizers.no_syncs`` catches.

Hot scopes: the engine outside construction and warmup, its captured
programs (``serving/programs.py``: a build runs on the serving path
when a shape is first served), the server's predict (``predict_classes``,
``predict_versioned``, ``predict_margin``, their ``_operands`` and
``_host`` and the stage functions its cache captures), the funnel's
``execute`` (its inputs' copies, its program and the ranked-list
boundary), the service's ``_exec_loop`` and ``_run_batch``, the scheduler's ``_chunk_step``,
``kernels/``, ``obs/trace.py`` and ``obs/metrics.py`` (the reference's),
``obs/device.py`` (the spans' device intervals: never a wait for the
card), plus the LM decode path: ``decode_step`` and its decode-only helpers in
``models/transformer.py``, ``decode_attention``, and the per-token
layers of ``models/layers.py`` that a decode step calls.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

PASS_NAME = "hostsync"

#: (path suffix, only these functions (None: all), exempt functions)
HOT_PATHS: tuple[tuple[str, tuple[str, ...] | None, tuple[str, ...]], ...] = (
    ("serving/engine.py", None,
     ("__init__", "warmup", "warmup_shape", "padded_batch")),
    ("serving/programs.py", None, ()),
    ("serving/pipeline.py",
     ("predict_classes", "predict_versioned", "predict_margin", "_operands",
      "_host", "_stage_proba0", "_stage_predict", "_stage_margin"), ()),
    ("serving/service.py", ("_exec_loop", "_run_batch"), ()),
    ("serving/funnel.py", ("execute", "stage_call", "_as_tensor",
                            "_stage_funnel"), ()),
    ("serving/sched/scheduler.py", ("_chunk_step",), ()),
    ("kernels/", None, ()),
    ("obs/trace.py", None, ()),
    ("obs/metrics.py", None, ()),
    ("obs/device.py", None, ()),
    ("models/transformer.py",
     ("decode_step", "_decode_layers", "_decode_attn_gqa",
      "_decode_attn_mla", "_slot_positions"), ()),
    ("models/attention.py", ("decode_attention",), ()),
    ("models/layers.py", ("rope", "rms_norm", "dense", "swiglu"), ()),
)

_D2H_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_MAKERS = {"torch.from_numpy", "torch.tensor", "torch.as_tensor"}
_DTYPES = {"float16", "float32", "float64", "bfloat16", "half", "float",
           "double", "int8", "int16", "int32", "int64", "long", "int",
           "uint8", "bool"}


def _snippet(node) -> str:
    s = ast.unparse(node)
    return s if len(s) <= 120 else s[:117] + "..."


def _hot_scope(path: str):
    p = path.replace("\\", "/")
    for suffix, only, exempt in HOT_PATHS:
        if suffix.endswith("/"):
            if ("/" + suffix) in ("/" + p) or p.startswith(suffix):
                return only, exempt
        elif p.endswith(suffix):
            return only, exempt
    return None


def _kw(call: ast.Call, name: str):
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_method(call: ast.Call, names) -> bool:
    return (isinstance(call.func, ast.Attribute) and call.func.attr in names
            and not isinstance(call.func.value, ast.Constant))


def _makes_host_tensor(e: ast.AST, host: set[str]) -> bool:
    """Does ``e`` evaluate to a tensor in host memory?"""
    if isinstance(e, ast.Name):
        return e.id in host
    if isinstance(e, ast.Call):
        if astutil.dotted(e.func) in _HOST_MAKERS:
            dev = _kw(e, "device")
            return dev is None or (isinstance(dev, ast.Constant)
                                   and dev.value == "cpu")
        # a host tensor's own methods (``.long()``, ``.reshape``) stay on
        # the host; ``.pin_memory()`` is handled by the caller
        if isinstance(e.func, ast.Attribute) and e.func.attr not in (
                "to", "cuda", "pin_memory"):
            return _makes_host_tensor(e.func.value, host)
    return False


def _is_dtype(e: ast.AST) -> bool:
    d = astutil.dotted(e) or ""
    return d.startswith("torch.") and d.split(".")[-1] in _DTYPES


def _pageable_h2d(call: ast.Call, host: set[str]) -> bool:
    """``<host tensor>.to(<device>)`` / ``.cuda()`` not from pinned
    memory with ``non_blocking=True``."""
    if not _is_method(call, ("to", "cuda")):
        return False
    recv = call.func.value
    nb = _kw(call, "non_blocking")
    if (isinstance(recv, ast.Call) and _is_method(recv, ("pin_memory",))
            and isinstance(nb, ast.Constant) and nb.value is True):
        return False
    if isinstance(recv, ast.Call) and _is_method(recv, ("pin_memory",)):
        recv = recv.func.value
    if not _makes_host_tensor(recv, host):
        return False
    if call.func.attr == "cuda":
        return True
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    return bool(args) and not all(_is_dtype(a) for a in args)


def _host_names(fn: ast.AST) -> set[str]:
    """Names bound in ``fn``'s own body to host tensors."""
    host: set[str] = set()
    for _ in range(3):                    # short chains: a few passes
        for node in astutil.walk_shallow(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _makes_host_tensor(node.value, host)):
                host.add(node.targets[0].id)
    return host


def scan(tree: ast.Module, path: str) -> list[tuple[Finding, int]]:
    """The pass's findings, each with the last line of its call (a
    runtime frame inside a multi-line call reports one of its lines)."""
    scope_cfg = _hot_scope(path)
    if scope_cfg is None:
        return []
    only, exempt = scope_cfg
    quals = astutil.qualname_map(tree)
    out: list[tuple[Finding, int]] = []

    def add(node, invariant, message, hint):
        out.append((Finding(invariant=invariant, file=path,
                            line=node.lineno, scope=scope,
                            code=_snippet(node), message=message,
                            hint=hint), node.end_lineno))

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if only is not None and fn.name not in only:
            continue
        if fn.name in exempt:
            continue
        scope = quals.get(fn, fn.name)
        host = _host_names(fn)
        calls = [n for n in astutil.walk_shallow(fn)
                 if isinstance(n, ast.Call)]
        # ``x.cpu().numpy()`` is one copy: report it at the ``.numpy()``
        folded = {id(c.func.value) for c in calls
                  if _is_method(c, ("numpy",))
                  and isinstance(c.func.value, ast.Call)
                  and _is_method(c.func.value, ("cpu",))}
        for node in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
            t = astutil.tail(node.func)
            d = astutil.dotted(node.func) or ""
            if t == "synchronize" or (t == "fence"
                                      and isinstance(node.func, ast.Name)):
                add(node, "hostsync/blocking-sync",
                    f"`{t}` in a hot-path scope waits for the device on "
                    "every call.",
                    "let the stream run; sync only at the serve boundary "
                    "or inside a vetted timing fence (baseline it with a "
                    "note)")
            elif _is_method(node, _D2H_METHODS) and id(node) not in folded:
                add(node, "hostsync/device-to-host",
                    f"`.{t}()` in a hot-path scope copies a CUDA tensor "
                    "to the host and waits for the stream.",
                    "keep the value on the device; read it out once, at "
                    "the ranked-list boundary")
            elif (d in ("torch.tensor", "torch.as_tensor")
                  and _kw(node, "device") is not None
                  and not (isinstance(_kw(node, "device"), ast.Constant)
                           and _kw(node, "device").value == "cpu")):
                add(node, "hostsync/host-to-device",
                    f"`{d}(..., device=...)` copies host data from "
                    "pageable memory, which waits for the stream.",
                    "build the value on the device (torch.full, arange), "
                    "or copy it once from pinned memory with "
                    "non_blocking=True")
            elif _pageable_h2d(node, host):
                add(node, "hostsync/host-to-device",
                    "a copy of host data to the device from pageable "
                    "memory waits for the stream.",
                    "copy from .pin_memory() with non_blocking=True, or "
                    "build the value on the device")
    return out


def run(tree: ast.Module, path: str) -> list[Finding]:
    return [f for f, _ in scan(tree, path)]
