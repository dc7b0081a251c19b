"""The AST helpers the port's passes share: a copy of the part of the
JAX package's ``analysis/astutil.py`` they need (call tails, dotted
names, scope names, a walk that stops at nested scopes, taint
tracking), and the port's counterpart of its traced-context discovery:
the captured scopes.

* **Captured-scope discovery** (``find_captured_scopes``): which
  function bodies run inside a CUDA graph capture.  A function is
  captured when it is handed to a program cache -- an argument of the
  engine's ``_timed``, ``_run`` or ``_compiled``, or of
  ``ProgramCache.compiled`` (the server's predicts) -- (a function, a
  method, a lambda) or called from a captured function, in the same
  package (imports are followed across modules), or nested inside one.
  A branch that runs only on the CPU (``if <x>.type == "cpu":``) is not
  captured: a graph is captured on a CUDA device only.
* **Taint tracking** (``Taint``): which names in a captured body hold
  tensors.  A function handed to the cache has every positional
  parameter and its ``*args`` tainted (the cache's arguments are tensors; static
  configuration goes by keyword); a callee has the parameters its
  captured call sites pass tainted values to.  Taint propagates through
  assignment, tuple unpacking, ``for`` targets (not ``enumerate``'s
  index) and calls, and stops at
  static metadata (``.shape``, ``.dtype``, ``.device``, ``.size()``,
  ``.data_ptr()``, ``len()``).  Tensor factories (``torch.arange``,
  ``torch.full``, ...) are tainted whatever their inputs.

Pure ``ast``: the lint driver executes none of the code it reads.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import os

__all__ = ["CapturedScope", "Taint", "find_captured_scopes", "tail",
           "dotted", "qualname_map", "walk_shallow", "captured_walk",
           "positional", "CACHE_ENTRYPOINTS"]

#: attribute reads that yield static metadata of a tensor
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "requires_grad", "is_floating_point"}

#: tensor methods whose result is static metadata (the address of a
#: tensor is static under capture: a graph replays on the same buffers)
STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride", "data_ptr",
                  "element_size", "is_contiguous", "get_device",
                  "storage_offset"}

#: calls whose result is static even on tensor operands
STATIC_CALLS = {"len", "isinstance", "issubclass", "type", "getattr",
                "hasattr", "callable", "id", "repr", "str", "format",
                "is_dtensor", "is_fake"}

#: type checks whose true arm no graph captures: DTensors and fake
#: tensors are the dry run's, traced on no card
_UNCAPTURED_CHECKS = {"is_dtensor", "is_fake"}

#: ``torch.<name>`` factories: a tensor whatever their inputs
TENSOR_FACTORIES = {"arange", "full", "zeros", "ones", "empty", "full_like",
                    "zeros_like", "ones_like", "empty_like", "rand", "randn",
                    "randint", "linspace", "eye"}

#: call tails that hand a stage function to a program cache
CACHE_ENTRYPOINTS = {"_timed", "_run", "_compiled", "compiled"}


def tail(node: ast.AST) -> str | None:
    """Last component of a call target: ``torch.cuda.synchronize`` ->
    ``"synchronize"``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def dotted(node: ast.AST) -> str | None:
    """Full dotted name of an attribute chain, or None if not a chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_CALLABLE_NODES = _FUNC_NODES + (ast.Lambda,)
_SCOPE_NODES = _CALLABLE_NODES + (ast.ClassDef,)


def walk_shallow(node: ast.AST):
    """``ast.walk`` that does not descend into nested function/class
    scopes (their bodies are separate contexts): it yields a nested def
    itself, but not its body."""
    stack = [node]
    first = True
    while stack:
        cur = stack.pop()
        if not first and isinstance(cur, _SCOPE_NODES):
            yield cur
            continue
        first = False
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def qualname_map(tree: ast.Module) -> dict[ast.AST, str]:
    """node -> dotted qualname (``Class.method.inner``) for every
    function/class definition in the module."""
    out: dict[ast.AST, str] = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES + (ast.ClassDef,)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = q
                visit(child, q)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _uncaptured_branch(test: ast.AST) -> str | None:
    """Which arm of an ``if`` no graph captures: ``"body"`` for
    ``<x>.type == "cpu"`` (or ``!= "cuda"``) and for ``is_dtensor(..)``
    or ``is_fake(..)``, or a conjunction holding one of them,
    ``"orelse"`` for ``<x>.type == "cuda"`` (or ``!= "cpu"``) and for
    ``not is_dtensor(..)``, else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        # the body runs only where every conjunct holds
        return ("body" if any(_uncaptured_branch(v) == "body"
                              for v in test.values) else None)
    negated = (isinstance(test, ast.UnaryOp)
               and isinstance(test.op, ast.Not))
    call = test.operand if negated else test
    if (isinstance(call, ast.Call)
            and tail(call.func) in _UNCAPTURED_CHECKS):
        return "orelse" if negated else "body"
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)):
        return None
    dev, op = test.comparators[0].value, test.ops[0]
    if not isinstance(op, (ast.Eq, ast.NotEq)) or dev not in ("cpu", "cuda"):
        return None
    return "body" if (dev == "cpu") == isinstance(op, ast.Eq) else "orelse"


def captured_walk(node: ast.AST):
    """``walk_shallow`` that also skips the arm of an ``if`` that no
    graph captures (the CPU's, the dry run's DTensors')."""
    stack = [node]
    first = True
    while stack:
        cur = stack.pop()
        if not first and isinstance(cur, _SCOPE_NODES):
            yield cur
            continue
        first = False
        yield cur
        if isinstance(cur, ast.If):
            skip = _uncaptured_branch(cur.test)
            stack.append(cur.test)
            if skip != "body":
                stack.extend(cur.body)
            if skip != "orelse":
                stack.extend(cur.orelse)
            continue
        stack.extend(ast.iter_child_nodes(cur))


def positional(fn: ast.AST) -> list[str]:
    """A function's positional parameters, ``self``/``cls`` left out."""
    a = fn.args
    names = [p.arg for p in list(getattr(a, "posonlyargs", [])) + a.args]
    return names[1:] if names[:1] in (["self"], ["cls"]) else names


# ------------------------------------------------------------------ taint --

class Taint:
    """Which names in one captured function body hold tensors.

    ``seeds``: the parameters that carry tensors; ``extra``: tainted
    names a nested scope inherits from its enclosing captured scope.
    """

    def __init__(self, fn_node: ast.AST, seeds=(), extra=()):
        a = fn_node.args
        self.vararg = a.vararg.arg if a.vararg else None
        self.kwarg = a.kwarg.arg if a.kwarg else None
        self.tainted: set[str] = set(extra) | set(seeds)
        self._propagate(fn_node)

    def _propagate(self, root) -> None:
        for _ in range(8):                   # small fixpoint: chains are
            before = len(self.tainted)       # short in practice
            for node in walk_shallow(root):
                self._step(node)
            if len(self.tainted) == before:
                return

    def _taint_target(self, target: ast.expr) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)
        elif isinstance(target, ast.Subscript):
            self._taint_target(target.value)

    def _step(self, node: ast.AST) -> None:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.NamedExpr)):
            if node.value is not None and self.is_tainted(node.value):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    self._taint_target(t)
        elif isinstance(node, ast.For):
            self._taint_loop(node.iter, node.target)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for comp in node.generators:
                self._taint_loop(comp.iter, comp.target)

    def _taint_loop(self, it: ast.expr, target: ast.expr) -> None:
        """A loop over a tainted iterable taints its target; the index
        of ``enumerate`` stays a Python int."""
        if not self.is_tainted(it):
            return
        if (isinstance(it, ast.Call) and tail(it.func) == "enumerate"
                and isinstance(target, ast.Tuple) and len(target.elts) == 2):
            self._taint_target(target.elts[1])
        else:
            self._taint_target(target)

    def is_tainted(self, e: ast.AST) -> bool:
        """Does evaluating ``e`` yield a tensor (or a value read from
        one)?"""
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in STATIC_ATTRS:
                return False
            return self.is_tainted(e.value)
        if isinstance(e, ast.Subscript):
            if (isinstance(e.value, ast.Name)
                    and e.value.id in (self.vararg, self.kwarg)
                    and e.value.id in self.tainted):
                return True
            return self.is_tainted(e.value) or self.is_tainted(e.slice)
        if isinstance(e, ast.Call):
            t = tail(e.func)
            if t in STATIC_CALLS:
                return False
            if isinstance(e.func, ast.Attribute) and t in STATIC_METHODS:
                return False
            if (t in TENSOR_FACTORIES
                    and (dotted(e.func) or "").split(".")[0] == "torch"):
                return True
            if any(self.is_tainted(a) for a in e.args):
                return True
            if any(self.is_tainted(k.value) for k in e.keywords):
                return True
            if isinstance(e.func, ast.Attribute):
                return self.is_tainted(e.func.value)
            return False
        if isinstance(e, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
            return False
        if isinstance(e, _SCOPE_NODES):
            return False
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            # its elements and filters: iterating a tuple of tensors is a
            # static unroll (``_step`` taints the loop variable)
            parts = ([e.key, e.value] if isinstance(e, ast.DictComp)
                     else [e.elt])
            parts += [c for g in e.generators for c in g.ifs]
            return any(self.is_tainted(p) for p in parts)
        return any(self.is_tainted(c) for c in ast.iter_child_nodes(e)
                   if isinstance(c, (ast.expr, ast.comprehension,
                                     ast.keyword)))


# --------------------------------------------------------- captured scopes --

@dataclasses.dataclass
class CapturedScope:
    node: ast.AST             # FunctionDef / Lambda
    seeds: frozenset[str]     # parameters that carry tensors
    extra: frozenset[str]     # tainted names of the enclosing captured scope
    root: bool                # handed to the program cache itself
    reason: str               # why it is captured (messages)


class _Module:
    """One parsed module: its scopes by qualname and its imports."""

    def __init__(self, name: str, tree: ast.Module, is_pkg: bool):
        self.name = name
        self.tree = tree
        self.quals = qualname_map(tree)
        self.by_qual = {q: n for n, q in self.quals.items()}
        pkg = name if is_pkg else name.rpartition(".")[0]
        self.imports: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    key = a.asname or a.name.split(".")[0]
                    self.imports[key] = a.name if a.asname else key
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = pkg.split(".")
                    parts = parts[:len(parts) - (node.level - 1)]
                    base = ".".join(parts + ([base] if base else []))
                for a in node.names:
                    self.imports[a.asname or a.name] = f"{base}.{a.name}"
        self._entry_args = None
        self._parents = None

    def scope_qual(self, node: ast.AST) -> str | None:
        """The qualname a call inside ``node`` resolves from: its own, or
        for a lambda its enclosing scope's."""
        if node in self.quals:
            return self.quals[node]
        if self._parents is None:
            self._parents = {c: p for p in ast.walk(self.tree)
                             for c in ast.iter_child_nodes(p)}
        cur = self._parents.get(node)
        while cur is not None and cur not in self.quals:
            cur = self._parents.get(cur)
        return None if cur is None else self.quals[cur] + ".<lambda>"

    def enclosing(self, qual: str, kind) -> str | None:
        """The nearest enclosing scope of ``qual`` of node type ``kind``."""
        parts = qual.split(".")
        for i in range(len(parts) - 1, 0, -1):
            q = ".".join(parts[:i])
            if isinstance(self.by_qual.get(q), kind):
                return q
        return None

    def entry_args(self) -> list:
        """(scope qualname, argument, entry point) of every argument of a
        call to the program cache in this module."""
        if self._entry_args is None:
            self._entry_args = []
            calls = [n for n in ast.walk(self.tree)
                     if isinstance(n, ast.Call)
                     and tail(n.func) in CACHE_ENTRYPOINTS]
            for fn, qual in (self.quals.items() if calls else ()):
                if not isinstance(fn, _FUNC_NODES):
                    continue
                mine = set(walk_shallow(fn))
                self._entry_args += [(qual, arg, tail(c.func))
                                     for c in calls if c in mine
                                     for arg in c.args]
        return self._entry_args


class _CallGraph:
    """Call resolution over the modules of one package."""

    def __init__(self, modules: dict[str, _Module]):
        self.modules = modules

    def symbol(self, target: str, depth: int = 0):
        """(module, function node) that the dotted ``target`` names,
        following re-exports."""
        modname, _, attr = target.rpartition(".")
        m = self.modules.get(modname)
        if m is None or depth > 5:
            return None
        node = m.by_qual.get(attr)
        if isinstance(node, _FUNC_NODES):
            return m, node
        if node is None and attr in m.imports:
            return self.symbol(m.imports[attr], depth + 1)
        return None

    def resolve(self, m: _Module, qual: str, func: ast.AST):
        """(module, function node) a call target in scope ``qual`` of
        module ``m`` names, or None (a library call, a tensor method)."""
        if isinstance(func, ast.Name):
            scope = m.enclosing(qual + ".x", _FUNC_NODES)
            while scope is not None:          # a def nested in the caller
                node = m.by_qual.get(f"{scope}.{func.id}")
                if isinstance(node, _FUNC_NODES):
                    return m, node
                scope = m.enclosing(scope, _FUNC_NODES)
            node = m.by_qual.get(func.id)
            if isinstance(node, _FUNC_NODES):
                return m, node
            if func.id in m.imports:
                return self.symbol(m.imports[func.id])
            return None
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            base = func.value.id
            if base in ("self", "cls"):
                cls = m.enclosing(qual + ".x", ast.ClassDef)
                while cls is not None:
                    node = m.by_qual.get(f"{cls}.{func.attr}")
                    if isinstance(node, _FUNC_NODES):
                        return m, node
                    bases = [b.id for b in m.by_qual[cls].bases
                             if isinstance(b, ast.Name)]
                    cls = next((b for b in bases
                                if isinstance(m.by_qual.get(b),
                                              ast.ClassDef)), None)
                return None
            if isinstance(m.by_qual.get(base), ast.ClassDef):
                node = m.by_qual.get(f"{base}.{func.attr}")
                return (m, node) if isinstance(node, _FUNC_NODES) else None
            target = m.imports.get(base)
            if target is not None and target in self.modules:
                return self.symbol(f"{target}.{func.attr}")
        return None

    def captured(self) -> dict[ast.AST, CapturedScope]:
        """Every captured scope of the package, to a fixpoint."""
        out: dict[ast.AST, CapturedScope] = {}
        todo = []

        def add(m, node, seeds, extra, root, reason):
            old = out.get(node)
            if old is not None:
                seeds, extra = old.seeds | seeds, old.extra | extra
                root = root or old.root
                if (seeds, extra, root) == (old.seeds, old.extra, old.root):
                    return
                reason = old.reason
            out[node] = CapturedScope(node, frozenset(seeds),
                                      frozenset(extra), root, reason)
            todo.append((m, node))

        for m in self.modules.values():
            for qual, arg, entry in m.entry_args():
                got = ((m, arg) if isinstance(arg, ast.Lambda)
                       else self.resolve(m, qual, arg))
                if got is not None:
                    va = got[1].args.vararg
                    add(got[0], got[1],
                        set(positional(got[1])) | ({va.arg} if va else set()),
                        set(), True, f"handed to `{entry}` in `{qual}`")
        while todo:
            m, node = todo.pop()
            sc = out[node]
            taint = Taint(node, sc.seeds, sc.extra)
            qual = m.scope_qual(node)
            for sub in captured_walk(node):
                if sub is not node and isinstance(sub, _CALLABLE_NODES):
                    add(m, sub, set(positional(sub)), taint.tainted,
                        False, f"nested in `{qual or '<lambda>'}`")
                if not isinstance(sub, ast.Call) or qual is None:
                    continue
                got = self.resolve(m, qual, sub.func)
                if got is None:
                    continue
                cm, callee = got
                add(cm, callee, _call_seeds(callee, sub, taint), set(),
                    False, f"called from captured `{qual}`")
        return out


def _call_seeds(callee: ast.AST, call: ast.Call, taint: Taint) -> set[str]:
    """The parameters of ``callee`` that ``call`` passes tensors to."""
    a = callee.args
    pos = positional(callee)
    named = set(pos) | {p.arg for p in a.kwonlyargs}
    out: set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            if taint.is_tainted(arg.value):
                out |= set(pos[i:]) | ({a.vararg.arg} if a.vararg else set())
            continue
        if not taint.is_tainted(arg):
            continue
        if i < len(pos):
            out.add(pos[i])
        elif a.vararg:
            out.add(a.vararg.arg)
    for k in call.keywords:
        if not taint.is_tainted(k.value):
            continue
        if k.arg is None:                       # **kwargs
            out |= named
        elif k.arg in named:
            out.add(k.arg)
        elif a.kwarg:
            out.add(a.kwarg.arg)
    return out


def _package_of(path: str):
    """(directory holding the top package, module name) of ``path``, or
    (None, its stem) outside a package."""
    p = os.path.abspath(path)
    d = os.path.dirname(p)
    top = None
    while os.path.exists(os.path.join(d, "__init__.py")):
        top, d = d, os.path.dirname(d)
    stem = os.path.splitext(os.path.basename(p))[0]
    if top is None:
        return None, stem
    rel = os.path.splitext(os.path.relpath(p, d))[0].replace(os.sep, ".")
    return (d, os.path.basename(top)), rel.removesuffix(".__init__")


def _load_package(root: str, top: str) -> dict[str, _Module]:
    """Every module of package ``top`` under ``root``."""
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, top)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__"
                         and not d.startswith("."))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.splitext(os.path.relpath(path, root))[0]
            name = rel.replace(os.sep, ".").removesuffix(".__init__")
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            out[name] = _Module(name, tree, f == "__init__.py")
    return out


def _scope_key(quals: dict, node: ast.AST):
    """A scope's name that survives a reparse: its qualname, or a
    lambda's position."""
    return quals.get(node) or ("<lambda>", node.lineno, node.col_offset)


@functools.lru_cache(maxsize=4)
def _package_scopes(root: str, top: str) -> dict:
    """{module name: {scope key: CapturedScope}} of the package as it is
    on disk, computed once."""
    modules = _load_package(root, top)
    out: dict = {}
    owner = {n: m for m in modules.values() for n in ast.walk(m.tree)
             if isinstance(n, _CALLABLE_NODES)}
    for node, sc in _CallGraph(modules).captured().items():
        m = owner[node]
        out.setdefault(m.name, {})[_scope_key(m.quals, node)] = sc
    return out


def find_captured_scopes(tree: ast.Module,
                         path: str) -> dict[ast.AST, CapturedScope]:
    """The captured scopes of ``tree`` (the source of ``path``): those
    the module's own calls to the cache reach within it, and, in a
    package, those the package on disk reaches (matched by qualname), so
    a stage handed to the cache in one module captures its callees in
    every other."""
    pkg, name = _package_of(path)
    out = {}
    if any(isinstance(n, ast.Call) and tail(n.func) in CACHE_ENTRYPOINTS
           for n in ast.walk(tree)):
        here = _Module(name, tree, os.path.basename(path) == "__init__.py")
        out = _CallGraph({name: here}).captured()
    disk = _package_scopes(*pkg).get(name) if pkg else None
    if not disk:
        return out
    quals = qualname_map(tree)
    for node in ast.walk(tree):
        if not isinstance(node, _CALLABLE_NODES):
            continue
        sc = disk.get(_scope_key(quals, node))
        if sc is None:
            continue
        old = out.get(node)
        if old is not None:
            sc = dataclasses.replace(sc, seeds=sc.seeds | old.seeds,
                                     extra=sc.extra | old.extra,
                                     root=sc.root or old.root)
        out[node] = dataclasses.replace(sc, node=node)
    return out
