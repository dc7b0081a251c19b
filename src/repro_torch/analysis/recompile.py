"""Graph-capture hazard lint: the one-program-per-shape invariant of the
port, statically.  The counterpart of the JAX package's
``analysis/recompile.py`` (it keeps the name, so a reader finds it).

The serving engine builds one program per stage and padded shape and
never again (``ServingEngine._compiled``); on the card a program is a
CUDA graph captured once and replayed, with the predicted parameters as
tensor operands.  A capture records device work only: anything the host
decides or reads while the stage runs is frozen into the graph at
capture, and replayed for every later batch of that shape, whatever its
data.  Inside a captured scope (``astutil.find_captured_scopes``: the
stage functions handed to the cache and the port functions they call),
the pass flags, under the JAX rules' names in torch's terms:

* ``recompile/captured-branch``       -- ``if``/``while``/``assert``/a
  ternary on a tensor-derived value (the branch taken at capture is the
  one every replay takes; reading the value also syncs the stream)
* ``recompile/captured-coercion``     -- ``int()``/``float()``/``bool()``
  of a tensor, ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` (a sync,
  which capture forbids, and a host value frozen at capture)
* ``recompile/host-tensor``           -- ``torch.tensor``,
  ``torch.as_tensor``, ``torch.from_numpy``, ``np.asarray`` or
  ``np.array`` (a tensor made per call from host data is frozen at
  capture)
* ``recompile/data-dependent-shape``  -- ``nonzero``, one-argument
  ``torch.where``, boolean-mask indexing, ``masked_select``, ``unique``,
  ``repeat_interleave`` without ``output_size`` (a shape read back from
  the device: a sync, and a shape the graph cannot change)
* ``recompile/captured-cache-key``    -- a tensor-derived dict key
* ``recompile/captured-iteration``    -- a Python ``for`` over a tensor
  (a trip count read from the device, frozen at capture)
* ``recompile/captured-closure``      -- a function handed to the cache
  that closes over a tensor of its enclosing scope, or a method that
  reads ``self``: the cache keys on its arguments' shapes, and a replay
  keeps reading what the capture saw

Branches that run only on the CPU (``if <x>.type == "cpu":``) or only
on the dry run's DTensors and fake tensors (``if is_dtensor(x):``) are
not captured and not checked.  Vetted findings live in the baseline with a
note, as for every pass.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

PASS_NAME = "recompile"

_COERCIONS = {"int", "float", "bool", "complex"}
_D2H_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_TENSORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
                 "np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SHAPE_METHODS = {"nonzero", "argwhere", "masked_select", "unique",
                  "unique_consecutive"}
_CONTAINER_CALLS = {"list", "tuple", "dict", "set", "sorted", "reversed",
                    "zip", "enumerate", "range", "items", "keys", "values"}


def _snippet(node) -> str:
    s = ast.unparse(node)
    return s if len(s) <= 120 else s[:117] + "..."


def _cond_of(node):
    if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
        return node.test
    return None


def _is_container(e: ast.AST) -> bool:
    """A Python container or iterator of static length (iterating it is a
    static unroll, whatever its elements hold)."""
    return (isinstance(e, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                           ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp))
            or (isinstance(e, ast.Call)
                and astutil.tail(e.func) in _CONTAINER_CALLS))


def _iterates_dicts(loop: ast.For) -> bool:
    """A loop whose element is read by string key in its body (``for lyr
    in params["mlp"]: .. lyr["w"] ..``): it iterates a list of parameter
    dicts, a static unroll, since a tensor's rows take no string key."""
    if not isinstance(loop.target, ast.Name):
        return False
    name = loop.target.id
    return any(isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
               and n.value.id == name and isinstance(n.slice, ast.Constant)
               and isinstance(n.slice.value, str)
               for stmt in loop.body for n in ast.walk(stmt))


def _is_mask(e: ast.AST, masks: set[str]) -> bool:
    """An expression that yields a boolean tensor: a comparison, its
    negation or a conjunction of them, or a name bound to one."""
    if isinstance(e, ast.Name):
        return e.id in masks
    if isinstance(e, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in e.ops)
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
        return _is_mask(e.operand, masks)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr,
                                                      ast.BitXor)):
        return _is_mask(e.left, masks) or _is_mask(e.right, masks)
    return False


def _mask_names(fn: ast.AST) -> set[str]:
    masks: set[str] = set()
    for _ in range(3):
        for node in astutil.walk_shallow(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _is_mask(node.value, masks)):
                masks.add(node.targets[0].id)
    return masks


def _data_dependent(node: ast.Call) -> str | None:
    t = astutil.tail(node.func)
    d = astutil.dotted(node.func) or ""
    kws = {k.arg for k in node.keywords}
    if t in _SHAPE_METHODS and isinstance(node.func, ast.Attribute):
        return t
    if d == "torch.where" and len(node.args) + len(node.keywords) == 1:
        return "torch.where(cond)"
    if (t == "repeat_interleave" and isinstance(node.func, ast.Attribute)
            and "output_size" not in kws):
        return "repeat_interleave without output_size"
    return None


def _bound_names(fn: ast.AST) -> set[str]:
    """Names a function binds itself: parameters, assignment and loop
    targets, comprehension variables, nested defs, imports."""
    a = fn.args
    out = {p.arg for p in list(getattr(a, "posonlyargs", [])) + a.args
           + a.kwonlyargs}
    out |= {p.arg for p in (a.vararg, a.kwarg) if p is not None}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store,
                                                                ast.Del)):
            out.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not fn:
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(x.asname or x.name).split(".")[0] for x in node.names}
        elif isinstance(node, ast.arg):
            out.add(node.arg)
    return out


def _enclosing_function(parents: dict, node: ast.AST):
    cur = parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        cur = parents.get(cur)
    return cur


def _closure_findings(parents, sc, emit) -> None:
    """A root that closes over a tensor of its enclosing function, or a
    method root that reads ``self``."""
    fn = sc.node
    outer = _enclosing_function(parents, fn)
    if isinstance(outer, ast.ClassDef):
        if any(isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
               and n.value.id == "self" for n in ast.walk(fn)):
            emit(fn, "recompile/captured-closure",
                 "a method handed to the program cache reads `self`: the "
                 "key holds only its arguments' shapes, and a replay keeps "
                 "the attributes the capture read.",
                 "hand the cache a module-level stage function and pass "
                 "tensors as arguments, configuration by keyword",
                 code="self")
        return
    if outer is None:
        return
    taint = astutil.Taint(outer, astutil.positional(outer))
    free = {n.id for n in ast.walk(fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    free -= _bound_names(fn) if not isinstance(fn, ast.Lambda) else {
        a.arg for a in ast.walk(fn.args) if isinstance(a, ast.arg)}
    free &= _bound_names(outer) & taint.tainted
    for name in sorted(free):
        emit(fn, "recompile/captured-closure",
             f"the stage closes over `{name}`, a tensor of its enclosing "
             "scope: the program cache keys on the arguments' shapes, and "
             "a replay keeps reading the tensor the capture saw.",
             "pass the tensor as an argument of the stage", code=name)


def run(tree: ast.Module, path: str) -> list[Finding]:
    scopes = astutil.find_captured_scopes(tree, path)
    quals = astutil.qualname_map(tree)
    findings: list[Finding] = []
    parents = ({c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
               if scopes else {})

    for fn_node, sc in scopes.items():
        scope = quals.get(fn_node)
        if scope is None:                        # a lambda
            outer = _enclosing_function(parents, fn_node)
            scope = (quals.get(outer, "") + ".<lambda>").lstrip(".")

        def emit(node, invariant, message, hint, expr=None, code=None):
            findings.append(Finding(
                invariant=invariant, file=path, line=node.lineno,
                scope=scope,
                code=code if code is not None else _snippet(
                    expr if expr is not None else node),
                message=message, hint=hint))

        if sc.root:
            _closure_findings(parents, sc, emit)
        taint = astutil.Taint(fn_node, sc.seeds, sc.extra)
        masks = _mask_names(fn_node)
        containers = {t.id for node in astutil.walk_shallow(fn_node)
                      if isinstance(node, ast.Assign)
                      and _is_container(node.value)
                      for t in node.targets if isinstance(t, ast.Name)}
        for node in astutil.captured_walk(fn_node):
            cond = _cond_of(node)
            if cond is not None and taint.is_tainted(cond):
                kind = type(node).__name__.lower()
                emit(node, "recompile/captured-branch",
                     f"Python `{kind}` on a tensor inside a captured scope "
                     f"({sc.reason}): the branch the capture took is the "
                     "one every replay takes, and reading the value syncs "
                     "the stream.",
                     "use torch.where or a mask, or hoist the decision "
                     "into a static keyword of the stage", expr=cond)
            elif (isinstance(node, ast.For) and taint.is_tainted(node.iter)
                  and not _is_container(node.iter)
                  and not _iterates_dicts(node)
                  and not (isinstance(node.iter, ast.Name)
                           and node.iter.id in containers)):
                emit(node, "recompile/captured-iteration",
                     "Python `for` over a tensor: the trip count is read "
                     "from the device and frozen at capture.",
                     "loop over a static range, or vectorize",
                     expr=node.iter)
            elif isinstance(node, ast.Call):
                t = astutil.tail(node.func)
                d = astutil.dotted(node.func) or ""
                dd = _data_dependent(node)
                if (t in _COERCIONS and isinstance(node.func, ast.Name)
                        and node.args and taint.is_tainted(node.args[0])):
                    emit(node, "recompile/captured-coercion",
                         f"`{t}()` of a tensor syncs the stream (capture "
                         "forbids it) and freezes the value at capture.",
                         "keep the value on the device, or derive it from "
                         "static shape metadata")
                elif (t in _D2H_METHODS and isinstance(node.func,
                                                       ast.Attribute)
                      and taint.is_tainted(node.func.value)):
                    emit(node, "recompile/captured-coercion",
                         f"`.{t}()` copies a tensor to the host inside a "
                         "captured scope: a sync, and a value frozen at "
                         "capture.",
                         "return the tensor and read it out after the "
                         "stage, at the ranked-list boundary")
                elif d in _HOST_TENSORS:
                    emit(node, "recompile/host-tensor",
                         f"`{d}` makes a tensor from host data inside a "
                         "captured scope: the capture freezes the data it "
                         "saw.",
                         "pass the tensor as an argument of the stage, or "
                         "build it on the device (torch.full, arange)")
                elif dd is not None:
                    emit(node, "recompile/data-dependent-shape",
                         f"`{dd}` gives a shape that depends on the data: "
                         "it is read back from the device (a sync) and "
                         "the graph cannot change it.",
                         "use a fixed-width form: torch.where(cond, a, b), "
                         "a mask, topk, output_size=")
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and any(_is_mask(e, masks) for e in (
                      node.slice.elts if isinstance(node.slice, ast.Tuple)
                      else [node.slice]))):
                emit(node, "recompile/data-dependent-shape",
                     "boolean-mask indexing gives a shape that depends on "
                     "the data: a sync, and a shape the graph cannot "
                     "change.",
                     "use torch.where(mask, x, fill) at a fixed width")
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                                ast.Store):
                if (taint.is_tainted(node.slice)
                        and not taint.is_tainted(node.value)):
                    emit(node, "recompile/captured-cache-key",
                         "a tensor used as a container key: a per-value "
                         "key reads the tensor (a sync) and defeats the "
                         "shape-keyed cache.",
                         "key on static metadata (shape, dtype, name) "
                         "only, as ServingEngine._compiled does",
                         expr=node)
            elif isinstance(node, ast.Dict):
                for k in node.keys:
                    if k is not None and taint.is_tainted(k):
                        emit(node, "recompile/captured-cache-key",
                             "a tensor used as a dict key.",
                             "key on static metadata (shape, dtype, "
                             "name), not on tensor data", expr=k)
    return findings
