"""XF301 thread-safety lockset: unlocked cross-thread attribute writes.

The reference package paid for this class once: its `JsonlAppender` was
written as a single-threaded sink, the serving-fleet router became its
first multi-threaded caller, and two handler threads could interleave
one JSONL line. The port runs the same shapes (the fleet's router, the
async checkpoint writer, the prefetch and heartbeat threads). The bug
class is mechanical: a class whose methods run on more than one thread
mutates `self.<attr>` somewhere without holding the object's lock.

Per class the pass:
- finds thread entry points: methods passed as `target=` to
  `threading.Thread` / `threading.Timer` (each its own thread), plus
  the external region: public methods (and everything they call) that
  outside callers invoke on their own threads;
- analyzes only classes that SPAWN a thread (or subclass a threading
  server base): a single-threaded helper may mutate freely;
- builds the per-class `self.method()` call graph and gives every
  method the set of threads it can run on;
- flags `self.<attr> = ...` / `self.<attr> += ...` stores (outside
  `__init__`, which happens before any thread starts) that are not
  lexically under `with self.<lock-family>` when the attribute is
  touched from two or more threads.

A lock is any `with self.<name>:` / `with self.<name>.<ctx>` where
`<name>` contains "lock", "cv", "cond" or "mutex". The pass is
intra-class and lexical: a helper that is only ever called with the
lock held is still flagged (suppress it inline, saying which caller
holds the lock).
"""

from __future__ import annotations

import ast
from typing import Optional

from xflow_tpu_torch.analysis import astutil
from xflow_tpu_torch.analysis.core import Finding, Project, register_pass

RULE = "XF301"

THREAD_SPAWNS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}
# (import aliases canonicalize `import threading as _th` before lookup)
# subclassing one of these makes methods run on server-managed threads
THREADED_BASES = {
    "ThreadingHTTPServer", "ThreadingMixIn", "ThreadingTCPServer",
    "ThreadingUnixStreamServer", "BaseHTTPRequestHandler",
}
LOCK_TOKENS = ("lock", "cv", "cond", "mutex")
# construction-time methods: writes there happen-before thread start
EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}


def _lockish(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in LOCK_TOKENS)


def _under_lock(node: ast.AST, parents: dict) -> bool:
    """Lexically inside `with self.<lock-family>[...]:`?"""
    cur = parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        if isinstance(cur, ast.With):
            for item in cur.items:
                name = astutil.dotted(item.context_expr)
                if name is None and isinstance(item.context_expr, ast.Call):
                    name = astutil.call_name(item.context_expr)
                if name and any(_lockish(part) for part in name.split(".")):
                    return True
        cur = parents.get(cur)
    return False


def _thread_targets(cls: ast.ClassDef, aliases: dict) -> list:
    """[(method name, spawn lineno)] for Thread/Timer targets that are
    `self.<m>` in this class."""
    out = []
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        if astutil.canonical(astutil.call_name(node),
                             aliases) not in THREAD_SPAWNS:
            continue
        target: Optional[ast.AST] = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and len(node.args) >= 2:
            target = node.args[1]  # Timer(interval, function)
        name = astutil.dotted(target) if target is not None else None
        if name and name.startswith("self."):
            out.append((name.split(".", 1)[1], node.lineno))
    return out


def _methods(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _call_graph(methods: dict) -> dict:
    graph: dict = {}
    for name, node in methods.items():
        callees = set()
        for sub in astutil.walk_scope(node):
            if isinstance(sub, ast.Call):
                cn = astutil.call_name(sub)
                if cn and cn.startswith("self."):
                    m = cn.split(".", 1)[1]
                    if "." not in m and m in methods:
                        callees.add(m)
        graph[name] = callees
    return graph


def _reach(seeds: set, graph: dict) -> set:
    seen = set(seeds)
    stack = list(seeds)
    while stack:
        for nxt in graph.get(stack.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return seen


def _self_attr_accesses(node: ast.AST, parents: dict):
    """Yields (attr, lineno, is_write, locked) for self.<attr> uses."""
    for sub in astutil.walk_scope(node):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if (isinstance(leaf, ast.Attribute)
                            and isinstance(leaf.value, ast.Name)
                            and leaf.value.id == "self"):
                        yield (leaf.attr, leaf.lineno, True,
                               _under_lock(sub, parents))
        elif (isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and isinstance(sub.ctx, ast.Load)):
            yield (sub.attr, sub.lineno, False, _under_lock(sub, parents))


@register_pass("lockset", (RULE,))
def run(project: Project) -> list:
    findings = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        parents = astutil.parent_map(mod.tree)
        aliases = astutil.import_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(
                    _check_class(node, mod.relpath, parents, aliases))
    return findings


def _check_class(cls: ast.ClassDef, relpath: str, parents: dict,
                 aliases: dict) -> list:
    methods = _methods(cls)
    if not methods:
        return []
    targets = _thread_targets(cls, aliases)
    threaded_base = any(
        (astutil.dotted(b) or "").split(".")[-1] in THREADED_BASES
        for b in cls.bases)
    if not targets and not threaded_base:
        return []
    graph = _call_graph(methods)
    # thread regions: one per spawn target; the external region is every
    # non-exempt method an outside caller can enter (public API and the
    # private helpers it reaches) — handler-base subclasses run do_*/
    # handle* on server threads, which the external region models too.
    regions: dict = {}
    target_names = {t for t, _ln in targets}
    for tgt in sorted(target_names & set(methods)):
        regions[f"thread:{tgt}"] = _reach({tgt}, graph)
    # the external region seeds from PUBLIC methods only: a private
    # helper (`_flush`) that only the spawned thread ever calls must
    # not read as caller-thread-reachable — it still joins the region
    # transitively when a public method actually calls it
    external_seeds = {
        name for name in methods
        if name not in target_names and not name.startswith("_")
    }
    regions["external"] = _reach(external_seeds, graph)

    # thread-id sets per method
    ids: dict = {name: set() for name in methods}
    for rid, members in regions.items():
        for m in members:
            ids[m].add(rid)

    # attribute access census
    write_sites: dict = {}  # attr -> [(line, locked, method)]
    touch_ids: dict = {}    # attr -> set of region ids touching it
    for name, node in methods.items():
        if name in EXEMPT_METHODS:
            continue
        mids = ids.get(name) or set()
        if not mids:
            continue  # unreachable helper; no thread can be attributed
        for attr, line, is_write, locked in _self_attr_accesses(node, parents):
            if _lockish(attr):
                continue  # the lock object itself
            touch_ids.setdefault(attr, set()).update(mids)
            if is_write:
                write_sites.setdefault(attr, []).append((line, locked, name))

    findings = []
    for attr, sites in sorted(write_sites.items()):
        if len(touch_ids.get(attr, ())) < 2:
            continue  # single-thread attribute
        unlocked = [(ln, m) for ln, locked, m in sites if not locked]
        for line, meth in sorted(unlocked):
            findings.append(Finding(
                rule=RULE, path=relpath, line=line,
                message=f"`self.{attr}` written without holding a lock in "
                        f"`{cls.name}.{meth}`, but the attribute is "
                        "reachable from multiple threads "
                        f"({', '.join(sorted(touch_ids[attr]))})",
                hint="guard the write (and its paired reads) with `with "
                     "self._lock:`, the unlocked JsonlAppender interleave's "
                     "bug class",
            ))
    return findings
