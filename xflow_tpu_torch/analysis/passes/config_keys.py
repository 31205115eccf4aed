"""XF4xx config cross-check: every `cfg.<section>.<key>` read resolves
to a default of the port's config tree (xflow_tpu_torch/config.py), and
every default is read somewhere.

The config tree is the port's only schema (one dataclass tree, the
reference's less four leaves): a misspelled key in code raises
`AttributeError` only when that code path finally runs, and a default
nobody reads is dead weight that reads as a tunable. Both are
mechanical to check:

- XF401 unknown-config-key: an attribute chain rooted at a Config
  value (a typo like `cfg.train.lag_every`), or a dotted override
  string, that does not resolve in the port's tree. (This docstring
  spells the example WITHOUT the `=value` suffix so the pass's own
  string scanner stays quiet.)
- XF402 dead-config-key: a leaf default no module of the port and no
  port test references (attribute read or dotted string). Only reported
  on full-tree runs: a partial lint would report everything dead.

Resolution is type-light but annotation-aware: parameters/attributes
annotated with a section class (`cfg: Config`, `data: DataConfig`)
resolve into that subtree; `x = cfg.serve`-style aliases follow; names
literally called `cfg`/`config` (and `self.cfg`/`self._cfg`/
`self.config`) are taken for the root Config. Dotted strings only count
in config-shaped contexts (`override()` dict keys
and `section.key=value` assignment strings), so registry counter names
like `data.rows` never false-positive.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Optional

from xflow_tpu_torch.analysis import astutil
from xflow_tpu_torch.analysis.core import Finding, Module, Project, register_pass

RULES = ("XF401", "XF402")

CFG_ROOT_NAMES = {"cfg", "config", "base_cfg", "base"}
CFG_ROOT_ATTRS = {"self.cfg", "self._cfg", "self.config", "self._config"}
OVERRIDE_CALLS = {"override", "config.override"}

# `section.key=value` tokens in Python strings
ASSIGN_RE = re.compile(
    r"(?<![\w./-])([a-z_]+)\.([a-z0-9_]+(?:\.[a-z0-9_]+)*)="
)


class ConfigTree:
    """The schema parsed from config.py's dataclass AST — never
    imported/executed, so linting works without the package's deps."""

    def __init__(self, sections: dict, root_extra: set, class_to_path: dict):
        self.sections = sections  # nested dicts; leaves -> lineno
        self.root_extra = root_extra  # Config-level properties/methods
        self.class_to_path = class_to_path  # "ServeConfig" -> ("serve",)

    @classmethod
    def parse(cls, config_path: str) -> Optional["ConfigTree"]:
        if not os.path.exists(config_path):
            return None
        with open(config_path) as f:
            try:
                tree = ast.parse(f.read(), filename=config_path)
            except SyntaxError:
                return None
        classes: dict = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
        if "Config" not in classes:
            return None

        def fields_of(cnode: ast.ClassDef) -> dict:
            out = {}
            for item in cnode.body:
                if isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    ann = item.annotation
                    ann_name = astutil.dotted(ann) or astutil.const_str(ann)
                    out[item.target.id] = (ann_name, item.lineno)
            return out

        def extras_of(cnode: ast.ClassDef) -> set:
            return {item.name for item in cnode.body
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}

        class_to_path: dict = {"Config": ()}

        def build(cnode: ast.ClassDef, path: tuple) -> dict:
            sub = {}
            for name, (ann, lineno) in fields_of(cnode).items():
                if ann in classes:
                    class_to_path.setdefault(ann, path + (name,))
                    sub[name] = build(classes[ann], path + (name,))
                else:
                    sub[name] = lineno
            return sub

        sections = build(classes["Config"], ())
        return cls(sections, extras_of(classes["Config"]), class_to_path)

    def resolve(self, chain: tuple) -> tuple:
        """Walk `chain` from the root. -> (status, depth) where status
        is 'ok' (resolves to leaf/section, possibly with trailing
        non-config attrs past a leaf), or 'bad' at chain[depth]."""
        node = self.sections
        for i, part in enumerate(chain):
            if isinstance(node, dict):
                if part in node:
                    node = node[part]
                    continue
                if i == 0 and part in self.root_extra:
                    return ("ok", i)
                return ("bad", i)
            # past a leaf: `.split(...)`-style trailing attrs are fine
            return ("ok", i)
        return ("ok", len(chain))

    def resolve_from(self, base: tuple, chain: tuple) -> tuple:
        return self.resolve(tuple(base) + tuple(chain))

    def leaves(self) -> list:
        out = []

        def walk(node: dict, path: tuple) -> None:
            for name, child in sorted(node.items()):
                if isinstance(child, dict):
                    walk(child, path + (name,))
                else:
                    out.append((path + (name,), child))

        walk(self.sections, ())
        return out

    def mark_used(self, used: set, chain: tuple) -> None:
        """Record the leaf a resolved chain touches (prefix-resolved)."""
        node = self.sections
        path: tuple = ()
        for part in chain:
            if isinstance(node, dict) and part in node:
                node = node[part]
                path = path + (part,)
            else:
                break
        if not isinstance(node, dict) and path:
            used.add(path)


def _usage_modules(project: Project) -> list:
    """Modules to scan for key USAGE: the lint set plus the port's tests
    (`tests/test_torch_*.py`, `tests/torch_*.py`; a key only tests read
    is not dead)."""
    mods = list(project.modules)
    have = {m.path for m in mods}
    tests_dir = os.path.join(project.root, "tests")
    if project.full_tree and os.path.isdir(tests_dir):
        for fn in sorted(os.listdir(tests_dir)):
            fp = os.path.join(tests_dir, fn)
            if fnmatch.fnmatch(fn, "*torch_*.py") and fp not in have:
                with open(fp, encoding="utf-8", errors="replace") as f:
                    mods.append(Module(fp, os.path.relpath(fp, project.root), f.read()))
    return mods


def _attr_chains(mod: Module, tree: ConfigTree):
    """Yields (chain-after-root, base-path, lineno) for reads rooted at
    a recognized Config value."""
    if mod.tree is None:
        return

    def class_path(ann_name: Optional[str]) -> Optional[tuple]:
        if not ann_name:
            return None
        m = re.search(r"\b([A-Z]\w*Config|Config)\b", ann_name)
        if m and m.group(1) in tree.class_to_path:
            return tree.class_to_path[m.group(1)]
        return None

    # phase 1 — annotations: param/attr annotated with a section class
    ann_roots: dict = {}    # bare name -> base path
    alias_roots: dict = {}  # name or self-attr chain -> base path
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                ann = a.annotation
                ann_name = (astutil.dotted(ann) or astutil.const_str(ann)
                            if ann is not None else None)
                base = class_path(ann_name)
                if base is not None:
                    ann_roots[a.arg] = base
        elif isinstance(node, ast.AnnAssign) and node.annotation is not None:
            ann_name = (astutil.dotted(node.annotation)
                        or astutil.const_str(node.annotation))
            tgt = astutil.dotted(node.target)
            base = class_path(ann_name)
            if base is not None and tgt:
                alias_roots[tgt] = base

    def _section_path(src: str) -> Optional[tuple]:
        """Base path a source expression denotes, if it is a SECTION
        (not a leaf): `cfg.serve`, an annotated name, an alias."""
        parts = src.split(".")
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            rest = parts[cut:]
            base = alias_roots.get(prefix)
            if base is None and cut == 1:
                base = ann_roots.get(parts[0])
            if base is None:
                root, rest2 = _split_root(parts)
                if root is None or cut != len(parts):
                    continue
                base, rest = root, rest2
            node2 = tree.sections
            for p in tuple(base) + tuple(rest):
                if isinstance(node2, dict) and p in node2:
                    node2 = node2[p]
                else:
                    return None
            return tuple(base) + tuple(rest) if isinstance(node2, dict) \
                else None
        return None

    # phase 2 — aliases: x = cfg.serve / self._scfg = serve_cfg, incl.
    # tuple unpacking; two sweeps so chained aliases settle
    for _sweep in range(2):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            pairs = []
            if len(node.targets) == 1 and isinstance(
                    node.targets[0], (ast.Tuple, ast.List)) and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                pairs = list(zip(node.targets[0].elts, node.value.elts))
            elif len(node.targets) == 1:
                pairs = [(node.targets[0], node.value)]
            for tgt_node, val_node in pairs:
                src = astutil.dotted(val_node)
                tgt = astutil.dotted(tgt_node)
                if not src or not tgt:
                    continue
                base = _section_path(src)
                if base is not None:
                    alias_roots[tgt] = base

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Attribute) or not isinstance(
                node.ctx, ast.Load):
            continue
        chain = astutil.dotted(node)
        if chain is None:
            continue
        parts = chain.split(".")
        # longest-prefix alias/annotation match
        base = None
        rest: list = []
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            if prefix in alias_roots:
                base, rest = alias_roots[prefix], parts[cut:]
                break
            if cut == 1 and parts[0] in ann_roots:
                base, rest = ann_roots[parts[0]], parts[1:]
                break
        if base is None:
            root, rest2 = _split_root(parts)
            if root is None:
                continue
            base, rest = root, rest2
        if not rest:
            continue
        # only report on the FULL chain (avoid double hits on inner
        # Attribute nodes of one chain): yield only maximal chains
        yield tuple(rest), tuple(base), node.lineno, node


def _split_root(parts: list) -> tuple:
    if parts[0] in CFG_ROOT_NAMES:
        return (), parts[1:]
    if len(parts) >= 2 and ".".join(parts[:2]) in CFG_ROOT_ATTRS:
        return (), parts[2:]
    return None, []


@register_pass("config-cross-check", RULES)
def run(project: Project) -> list:
    tree = ConfigTree.parse(project.config_path)
    if tree is None:
        return []
    findings: list = []
    used: set = set()
    scan = _usage_modules(project)
    lintable = {m.relpath for m in project.modules}
    for mod in scan:
        if mod.tree is None:
            continue
        chains = list(_attr_chains(mod, tree))
        # drop chains that are sub-chains of a longer reported chain
        inner: set = set()
        for _rest, _base, _ln, node in chains:
            sub = node.value
            while isinstance(sub, ast.Attribute):
                inner.add(id(sub))
                sub = sub.value
        for rest, base, lineno, node in chains:
            if id(node) in inner:
                continue
            status, depth = tree.resolve_from(base, rest)
            full = tuple(base) + tuple(rest)
            if status == "ok":
                tree.mark_used(used, full)
            elif mod.relpath in lintable:
                bad = ".".join(full[: depth + 1])
                findings.append(Finding(
                    rule="XF401", path=mod.relpath, line=lineno,
                    message=f"config read `{'.'.join(('cfg',) + full)}` "
                            f"does not resolve: `{bad}` is not in the "
                            "port's config.py tree",
                    hint="fix the key, or add the field (with a default "
                         "and a comment) to xflow_tpu_torch/config.py",
                ))
        # dotted strings: override() dict keys
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                cn = astutil.call_name(node)
                if cn in OVERRIDE_CALLS:
                    for d in ast.walk(node):
                        if isinstance(d, ast.Dict):
                            for k in d.keys:
                                s = astutil.const_str(k) if k else None
                                if s and re.fullmatch(r"[a-z_][\w.]*", s):
                                    _check_dotted(findings, tree, used, mod,
                                                  k.lineno, s,
                                                  report=mod.relpath
                                                  in lintable)
            s = astutil.const_str(node) if isinstance(node, ast.Constant) \
                else None
            if s:
                for m in ASSIGN_RE.finditer(s):
                    dotted = f"{m.group(1)}.{m.group(2)}"
                    if m.group(1) in tree.sections:
                        _check_dotted(findings, tree, used, mod,
                                      node.lineno, dotted,
                                      report=mod.relpath in lintable)
    # dead keys: full-tree runs only
    if project.full_tree:
        config_rel = os.path.relpath(project.config_path, project.root)
        for path, lineno in tree.leaves():
            if path not in used:
                findings.append(Finding(
                    rule="XF402", path=config_rel.replace(os.sep, "/"),
                    line=lineno,
                    message=f"config default `{'.'.join(path)}` is never "
                            "read by any module or test of the port "
                            "(dead key)",
                    hint="delete the field, or wire the code that should "
                         "be reading it",
                ))
    return findings


def _check_dotted(findings, tree, used, mod, lineno, dotted, report) -> None:
    chain = tuple(dotted.split("."))
    if chain[0] not in tree.sections:
        return  # not config-shaped ("data.rows" counter names etc. never
        # reach here for override() keys; assignment strings pre-filter)
    status, depth = tree.resolve(chain)
    if status == "ok":
        tree.mark_used(used, chain)
    elif report:
        bad = ".".join(chain[: depth + 1])
        findings.append(Finding(
            rule="XF401", path=mod.relpath, line=lineno,
            message=f"config override `{dotted}` does not resolve: "
                    f"`{bad}` is not in the port's config.py tree",
            hint="fix the key, or add the field to xflow_tpu_torch/config.py",
        ))
