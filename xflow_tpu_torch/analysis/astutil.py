"""Small AST helpers shared by the xflowlint passes."""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None. `self.x.y`
    renders as 'self.x.y'; calls and subscripts break the chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee ('torch.zeros', 'print', ...)."""
    return dotted(call.func)


def walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Like ast.walk over a function body, but not into nested
    function, class or lambda definitions (separate scopes)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def parent_map(tree: ast.AST) -> dict:
    """child node -> parent node, for lexical-context questions."""
    parents: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def import_aliases(tree: ast.AST) -> dict:
    """local name -> canonical dotted origin, from import statements:
    `import numpy as np` -> {np: numpy}; `import torch.nn.functional as
    F` -> {F: torch.nn.functional}; `from time import perf_counter as
    pc` -> {pc: time.perf_counter}. Lets rule tables match canonical
    names whatever a module imported them as."""
    amap: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                amap[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    amap[a.asname or a.name] = f"{node.module}.{a.name}"
    return amap


def canonical(name: Optional[str], aliases: dict) -> Optional[str]:
    """Rewrite a dotted name's first component through the import-alias
    map ('np.asarray' -> 'numpy.asarray')."""
    if not name:
        return name
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin is None or origin == head:
        return name
    return f"{origin}.{rest}" if rest else origin


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def defs_by_name(defs: list) -> dict:
    """simple name -> [qualnames] over a func_defs() list."""
    by_name: dict = {}
    for qn, _node, _cls in defs:
        by_name.setdefault(qn.split(".")[-1], []).append(qn)
    return by_name


def resolve_scoped(simple: str, caller_qn: str, by_name: dict) -> list:
    """Scope-aware name resolution: among same-named definitions, pick
    the ones whose defining scope is an ancestor of the caller's scope,
    preferring the innermost (two `def one(...)` in different functions
    must never cross-link). Falls back to every candidate for `self.x`
    references."""
    cands = by_name.get(simple, [])
    if len(cands) <= 1:
        return list(cands)
    visible = []
    for c in cands:
        scope = c.rsplit(".", 1)[0] if "." in c else ""
        if scope == "" or caller_qn == scope or caller_qn.startswith(scope + "."):
            visible.append((len(scope.split(".")) if scope else 0, c))
    if not visible:
        return list(cands)
    best = max(d for d, _c in visible)
    return [c for d, c in visible if d == best]


def func_defs(tree: ast.AST) -> list:
    """Every (qualname, node, class_name) function/method in a module.
    Qualnames use '.' ('Cls.method', 'outer.inner')."""
    out = []

    def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                out.append((qn, child, cls))
                visit(child, qn + ".", cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child.name)
            else:
                visit(child, prefix, cls)

    visit(tree, "", None)
    return out
