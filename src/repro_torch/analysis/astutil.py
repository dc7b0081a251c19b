"""The AST helpers the port's two passes share: a copy of the part of the
JAX package's ``analysis/astutil.py`` they need (call tails, dotted
names, scope names, a walk that stops at nested scopes).  The traced-
context discovery and taint tracking of the reference serve its jit
passes, which the port has no counterpart of: it traces nothing.

Pure ``ast``: the lint driver executes none of the code it reads.
"""

from __future__ import annotations

import ast

__all__ = ["tail", "dotted", "qualname_map", "walk_shallow"]


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
_SCOPE_NODES = _FUNC_NODES + (ast.Lambda, ast.ClassDef)


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
