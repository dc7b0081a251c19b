"""Kernel-wrapper lint: the launch discipline of the port's kernel path.
The counterpart of the JAX package's ``analysis/pallas.py``, which gives
the Pallas kernel bodies their structural rules.  The port's kernels are
CUDA C++ behind a plain C interface, which a Python AST cannot read, and
``chip_smoke.py``'s phase 1 holds each against its plain version; what
the AST can read is the Python wrapper that launches it, and the
ROADMAP's ground rules for the kernel path are rules of the wrapper:
no fallback around a launch, every launch checked and counted, the plain
version only on a CPU tensor.

A launcher is what ``_build.library(name)`` returns (a ``ctypes``
function).  A function that calls one launches; so does a function of
the same module that calls a launching one (``flash_attention_bshd``
through ``_launch``).  The pass flags:

* ``kernels/launch-unchecked`` -- a launch whose return value (the
  launcher's ``cudaGetLastError``) does not reach ``_build.check(err,
  name)`` in the same function.  An unchecked launch that the runtime
  refused leaves the output ``torch.empty`` held, and nothing raises.
* ``kernels/launch-uncounted`` -- a function that launches and does not
  raise its module's ``n_launches`` under ``if not
  _build.counted_in_capture(...)``.  ``chip_smoke.py`` proves the main
  path ran through a kernel by its count, and a captured program counts
  at each replay through the same call: an uncounted launch makes the
  ``kernels`` line undercount, or a program's launches count twice.
* ``kernels/fallback-around-launch`` -- a ``try`` whose body launches
  or loads a library (``_build.library``, ``ctypes.CDLL``), with a
  handler that calls a plain version, returns, or passes.  A kernel
  that failed to build or launch would then run its plain version, or
  nothing, on the card and report success: the hidden fallback the
  rules forbid.
* ``kernels/plain-off-cpu`` -- a call of a plain version (a name ending
  ``_plain``, or holding ``ref`` as a word: ``embedding_bag_ref``,
  ``attention_ref_bshd``) in a function that launches, on any branch
  but the arm of ``<x>.type == "cpu"`` (or the ``else`` of ``!=
  "cpu"``).  A wrapper launches its kernel on a CUDA tensor and runs
  its plain version only because the tensor lies on the CPU.

The module is read alone (no imports are followed), so a launch through
another module's wrapper is that module's to check.  Vetted findings
live in the baseline with a note, as for every pass.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

PASS_NAME = "kernels"

#: calls that load a kernel library
_LOADERS = {"library", "CDLL"}
_PLAIN = re.compile(r"(_plain$|(^|_)ref(_|$))")


def _snippet(node) -> str:
    s = ast.unparse(node)
    return s if len(s) <= 120 else s[:117] + "..."


def _is_library(node) -> bool:
    """``_build.library(...)`` (or ``library(...)``)."""
    return (isinstance(node, ast.Call)
            and astutil.dotted(node.func) in ("_build.library", "library"))


def _is_plain(call: ast.Call) -> bool:
    name = astutil.tail(call.func)
    return name is not None and bool(_PLAIN.search(name))


def _calls(fn) -> list[ast.Call]:
    return [n for n in astutil.walk_shallow(fn) if isinstance(n, ast.Call)]


def _launches(fn) -> list[ast.Call]:
    """The launcher calls of ``fn``: ``_build.library(..)(..)``, or a call
    of a name bound to ``_build.library(..)`` in ``fn``."""
    bound = {t.id for n in astutil.walk_shallow(fn)
             if isinstance(n, ast.Assign) and _is_library(n.value)
             for t in n.targets if isinstance(t, ast.Name)}
    return [c for c in _calls(fn)
            if _is_library(c.func)
            or (isinstance(c.func, ast.Name) and c.func.id in bound)]


def _launching(tree) -> tuple[dict, set]:
    """(name -> def of every function in the module, the names of those
    that launch, directly or through a function of the module)."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = {name for name, fn in defs.items() if _launches(fn)}
    grew = True
    while grew:
        grew = False
        for name, fn in defs.items():
            if name not in out and any(
                    astutil.tail(c.func) in out for c in _calls(fn)):
                out.add(name)
                grew = True
    return defs, out


def _checked_names(fn) -> set[str]:
    """Names passed as the first argument of ``_build.check`` in fn."""
    return {c.args[0].id for c in _calls(fn)
            if astutil.tail(c.func) == "check" and c.args
            and isinstance(c.args[0], ast.Name)}


def _unchecked(fn) -> list[ast.Call]:
    """The launches of fn whose value never reaches ``_build.check``."""
    checked = _checked_names(fn)
    in_check = {id(c.args[0]) for c in _calls(fn)
                if astutil.tail(c.func) == "check" and c.args}
    assigned = {}
    for n in astutil.walk_shallow(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            assigned[id(n.value)] = [t.id for t in n.targets
                                     if isinstance(t, ast.Name)]
    return [c for c in _launches(fn)
            if id(c) not in in_check
            and not set(assigned.get(id(c), ())) & checked]


def _counted(fn) -> bool:
    """fn raises ``n_launches`` in the body of ``if not
    _build.counted_in_capture(...)``."""
    for n in astutil.walk_shallow(fn):
        if not (isinstance(n, ast.If) and isinstance(n.test, ast.UnaryOp)
                and isinstance(n.test.op, ast.Not)
                and isinstance(n.test.operand, ast.Call)
                and astutil.tail(n.test.operand.func)
                == "counted_in_capture"):
            continue
        for s in n.body:
            for m in ast.walk(s):
                if (isinstance(m, ast.AugAssign)
                        and astutil.tail(m.target) == "n_launches"):
                    return True
    return False


def _cpu_arm(test) -> str | None:
    """The arm of an ``if`` that runs only on a CPU tensor: ``"body"``
    for ``<x>.type == "cpu"`` or a conjunction holding it, ``"orelse"``
    for ``<x>.type != "cpu"``, else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return ("body" if any(_cpu_arm(v) == "body" for v in test.values)
                else None)
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu"):
        if isinstance(test.ops[0], ast.Eq):
            return "body"
        if isinstance(test.ops[0], ast.NotEq):
            return "orelse"
    return None


def _plain_off_cpu(fn) -> list[ast.Call]:
    """Plain-version calls of fn outside every CPU arm."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(cur, ast.If):
            arm = _cpu_arm(cur.test)
            stack.append(cur.test)
            if arm != "body":
                stack.extend(cur.body)
            if arm != "orelse":
                stack.extend(cur.orelse)
            continue
        if isinstance(cur, ast.Call) and _is_plain(cur):
            out.append(cur)
        stack.extend(ast.iter_child_nodes(cur))
    return out


def _falls_back(handler: ast.ExceptHandler) -> bool:
    """The handler runs a plain version, returns, or passes."""
    for n in handler.body:
        if isinstance(n, (ast.Return, ast.Pass)):
            return True
        for m in ast.walk(n):
            if isinstance(m, ast.Return) or (isinstance(m, ast.Call)
                                             and _is_plain(m)):
                return True
    return False


def run(tree: ast.Module, path: str) -> list[Finding]:
    quals = astutil.qualname_map(tree)
    defs, launching = _launching(tree)
    findings: list[Finding] = []

    def emit(fn, node, invariant, message, hint, code=None):
        findings.append(Finding(invariant, path, node.lineno,
                                quals.get(fn, fn.name),
                                code or _snippet(node), message, hint))

    for name, fn in defs.items():
        for c in _unchecked(fn):
            emit(fn, c, "kernels/launch-unchecked",
                 "the launcher's error code never reaches _build.check: a "
                 "launch the runtime refused leaves the output unwritten "
                 "and raises nothing.",
                 "err = launch(...); _build.check(err, name)")
        if _launches(fn) and not _counted(fn):
            emit(fn, fn, "kernels/launch-uncounted",
                 f"`{name}` launches a kernel without raising its module's "
                 "n_launches under `if not _build.counted_in_capture(...)`: "
                 "chip_smoke.py's kernels line undercounts it, and a "
                 "captured program's replays do not count it.",
                 "if not _build.counted_in_capture(__name__): "
                 "n_launches += 1", code=f"def {name}")
        for n in astutil.walk_shallow(fn):
            if not isinstance(n, ast.Try):
                continue
            body = [c for s in n.body for c in ast.walk(s)
                    if isinstance(c, ast.Call)]
            if not any(astutil.tail(c.func) in _LOADERS
                       or astutil.tail(c.func) in launching
                       or c in _launches(fn) for c in body):
                continue
            for h in n.handlers:
                if _falls_back(h):
                    emit(fn, h, "kernels/fallback-around-launch",
                         "a launch (or a library load) inside a try whose "
                         "handler runs the plain version, returns or "
                         "passes: a kernel that failed on the card would "
                         "report success.",
                         "let the launch raise; run the plain version "
                         "only on a CPU tensor")
        if name in launching:
            for c in _plain_off_cpu(fn):
                emit(fn, c, "kernels/plain-off-cpu",
                     "a plain version runs in a launching function "
                     "outside the arm of `<x>.type == \"cpu\"`: a CUDA "
                     "tensor could take it instead of the kernel.",
                     "launch on a CUDA tensor; run the plain version only "
                     "under `if <x>.device.type == \"cpu\":`")
    return findings
