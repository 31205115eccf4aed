"""XF5xx JSONL-schema drift: record literals vs docs/OBSERVABILITY.md.

The port writes the reference trainer's, server's and launcher's
records through its own stamped `JsonlAppender`, and those records are
documented as schema tables in docs/OBSERVABILITY.md (the reference's
document, read here and never edited). This pass parses the doc's
tables into {kind -> allowed keys} and checks every record dict literal
the port ships against them, so a key the port invents or misspells is
caught before a run writes it.

Doc parsing: a `##`/`###` heading (or a table-introducing paragraph
line) containing `kind="X"` binds the following markdown tables to
kind X; the first table of the "Metrics JSONL schema" section is the
provenance stamp (keys legal on every kind). Key cells may list
several backticked names (`` `a`, `b` ``).

Code side, a dict literal is a record when:
- it contains a literal `"kind"` key, or
- it `**`-merges a binding known to hold one (`{**self._kind, ...}`
  where `self._kind = {"kind": "serve"}`), or
- it is the argument of `.append(...)` on a name/attr bound to a
  `JsonlAppender(..., stamp={... "kind": "X"})` (the heartbeat and
  watchdog pattern, where the kind lives in the stamp).

Findings:
- XF501 undocumented-record-key: a literal key the kind's tables (or
  the stamp table) do not list.
- XF502 unknown-record-kind: a `kind` value with no doc section.

Dynamic keys (`**extra`, computed keys) are out of scope by design:
the pass checks what it can prove.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from xflow_tpu_torch.analysis import astutil
from xflow_tpu_torch.analysis.core import Finding, Project, register_pass

RULES = ("XF501", "XF502")

KIND_RE = re.compile(r'kind="([a-z_]+)"')
KEY_CELL_RE = re.compile(r"`([A-Za-z_][\w.]*)`")


def parse_schema_doc(path: str) -> Optional[tuple]:
    """-> ({kind: set(keys)}, stamp_keys) or None if the doc is absent."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    kinds: dict = {}
    stamp: set = set()
    current: list = []  # kinds the next table binds to
    stamp_next = False
    in_metrics_section = False
    in_fence = False
    i = 0
    while i < len(lines):
        line = lines[i]
        # fenced code blocks are examples, not schema: a `# comment`
        # line inside ``` must not read as a heading that clears the
        # current kind binding, and a fenced table is not a schema
        if line.lstrip().startswith("```"):
            in_fence = not in_fence
            i += 1
            continue
        if in_fence:
            i += 1
            continue
        if line.startswith("#"):
            in_metrics_section = "Metrics JSONL schema" in line
            found = KIND_RE.findall(line)
            current = found
            stamp_next = in_metrics_section
        elif KIND_RE.search(line) and not line.strip().startswith("|"):
            # a paragraph line naming kinds re-binds subsequent tables
            # (e.g. 'Heartbeat records (kind="heartbeat"):')
            found = KIND_RE.findall(line)
            if found:
                current = found
        if line.strip().startswith("|") and "---" not in line:
            # a table block: consume it
            keys: set = set()
            j = i
            while j < len(lines) and lines[j].strip().startswith("|"):
                row = lines[j]
                j += 1
                if re.match(r"^\s*\|[\s:|-]*$", row):
                    continue  # separator
                first_cell = row.split("|")[1] if row.count("|") >= 2 else ""
                for m in KEY_CELL_RE.finditer(first_cell):
                    name = m.group(1)
                    if "." not in name:  # skip `hbm.*`-style globs
                        keys.add(name)
            keys.discard("field")  # header row
            if stamp_next:
                stamp |= keys
                stamp_next = False
            else:
                for k in current:
                    kinds.setdefault(k, set()).update(keys)
            i = j
            continue
        i += 1
    for k in kinds:
        kinds[k] |= {"kind"}
    return kinds, stamp | {"kind", "event"}


def _kind_bindings(tree: ast.AST) -> tuple:
    """(dict-bindings, appender-bindings): dotted target -> kind, for
    `X = {"kind": "serve"}` and `X = JsonlAppender(..., stamp={...})`."""
    dict_kinds: dict = {}
    app_kinds: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = astutil.dotted(node.targets[0])
        if not tgt:
            continue
        val = node.value
        if isinstance(val, ast.Dict):
            k = _literal_kind(val)
            if k:
                dict_kinds[tgt] = k
        elif isinstance(val, ast.Call):
            cn = astutil.call_name(val) or ""
            if cn.split(".")[-1] == "JsonlAppender":
                for kw in val.keywords:
                    if kw.arg == "stamp" and isinstance(kw.value, ast.Dict):
                        k = _literal_kind(kw.value)
                        if k:
                            app_kinds[tgt] = k
    return dict_kinds, app_kinds


def _literal_kind(d: ast.Dict) -> Optional[str]:
    for k, v in zip(d.keys, d.values):
        if k is not None and astutil.const_str(k) == "kind":
            return astutil.const_str(v)
    return None


def _dict_info(d: ast.Dict, dict_kinds: dict) -> tuple:
    """(kind or None, literal keys, dynamic) for a dict literal,
    resolving one level of `**`-merge against known bindings."""
    kind = _literal_kind(d)
    keys: set = set()
    dynamic = False
    for k, v in zip(d.keys, d.values):
        if k is None:  # **merge
            name = astutil.dotted(v)
            merged = dict_kinds.get(name) if name else None
            if merged:
                kind = kind or merged
                keys.add("kind")
            else:
                dynamic = True
            continue
        s = astutil.const_str(k)
        if s is None:
            dynamic = True
        else:
            keys.add(s)
    return kind, keys, dynamic


@register_pass("schema-drift", RULES)
def run(project: Project) -> list:
    parsed = parse_schema_doc(project.schema_doc_path)
    if parsed is None:
        return []
    kinds, stamp = parsed
    findings: list = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        dict_kinds, app_kinds = _kind_bindings(mod.tree)
        checked: set = set()
        # records appended to a kind-stamped appender
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "append" and node.args
                    and isinstance(node.args[0], ast.Dict)):
                owner = astutil.dotted(node.func.value)
                akind = app_kinds.get(owner) if owner else None
                d = node.args[0]
                kind, keys, _dyn = _dict_info(d, dict_kinds)
                kind = kind or akind
                if kind is not None:
                    checked.add(id(d))
                    _check(findings, mod, d, kind, keys, kinds, stamp)
        # any other dict literal that states its kind
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict) and id(node) not in checked:
                kind, keys, _dyn = _dict_info(node, dict_kinds)
                if kind is None or "kind" not in keys:
                    continue
                _check(findings, mod, node, kind, keys, kinds, stamp)
    return findings


def _check(findings, mod, d, kind, keys, kinds, stamp) -> None:
    if kind not in kinds:
        findings.append(Finding(
            rule="XF502", path=mod.relpath, line=d.lineno,
            message=f'record kind "{kind}" has no schema section in '
                    "docs/OBSERVABILITY.md",
            hint="use the reference's record kind, or baseline the kind "
                 "with the reason the port writes it",
        ))
        return
    allowed = kinds[kind] | stamp
    for key in sorted(keys):
        if key not in allowed:
            findings.append(Finding(
                rule="XF501", path=mod.relpath, line=d.lineno,
                message=f'key `{key}` on a kind="{kind}" record is not in '
                        "the docs/OBSERVABILITY.md schema tables",
                hint="fix the drifted key, or baseline it with the reason "
                     "the port's record differs from the reference's",
            ))
