"""Shared analyzer core of the port's xflowlint: the source model, the
finding model, suppressions, baseline files, the pass registry and
`run_passes`.

Everything works from text and `ast`: the analyzer never imports the
code under analysis, so a lint run needs neither torch nor jax, and a
scratch copy of a module lints without being executed.

Suppressions:
- `# xflowlint: disable=XF301` on the offending line silences the named
  rule(s) (comma-separated) for that line only;
- `# xflowlint: disable-file=XF401` anywhere in a file silences the
  rule(s) for the whole file; `all` names every rule.

Baseline (`xflow_tpu_torch/tools/xflowlint_baseline.json`): accepted
findings are recorded as (rule, path, message) entries with a reason,
so the gate fails on growth (a new finding) and on staleness (a fixed
finding whose entry was not removed) rather than on existence. Line
numbers are not part of the fingerprint: an unrelated edit above a
baselined finding must not break the gate.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

SUPPRESS_RE = re.compile(
    r"#\s*xflowlint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)"
)

# the port's own sources; the reference package and the CUDA / C++
# sources are not Python this lint reads
DEFAULT_PY_GLOBS = ("xflow_tpu_torch/**/*.py", "chip_smoke.py")
EXCLUDE_DIRS = ("__pycache__", ".git", ".pytest_cache", "tests/fixtures",
                "xflow_tpu_torch/_build", "xflow_tpu_torch/csrc",
                "xflow_tpu_torch/native")
CONFIG_REL = "xflow_tpu_torch/config.py"
SCHEMA_DOC_REL = "docs/OBSERVABILITY.md"


@dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, location, message, and a fix hint."""

    rule: str
    path: str  # repo-relative, '/'-separated (stable across machines)
    line: int
    message: str
    hint: str = ""

    def fingerprint(self) -> tuple:
        """Baseline identity: line numbers excluded on purpose."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class Module:
    """One parsed Python source file plus its suppression table."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.syntax_error: Optional[str] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:  # surfaced as its own finding (XF001)
            self.syntax_error = f"{e.msg} (line {e.lineno})"
        self.line_suppress: dict[int, set] = {}
        self.file_suppress: set = set()
        for i, line in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1) == "disable-file":
                self.file_suppress |= rules
            else:
                self.line_suppress.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppress or "all" in self.file_suppress:
            return True
        at = self.line_suppress.get(line, ())
        return rule in at or "all" in at


class Project:
    """The source set one lint run sees, with the repo-root anchors the
    cross-checking passes need (the port's config.py, the records'
    docs/OBSERVABILITY.md)."""

    def __init__(self, root: str, modules: list, full_tree: bool = True):
        self.root = root
        self.modules: list[Module] = modules
        # dead-key analysis (XF402) is only sound when the whole tree
        # was scanned: a partial lint would report every key dead
        self.full_tree = full_tree
        self.config_path = os.path.join(root, *CONFIG_REL.split("/"))
        self.schema_doc_path = os.path.join(root, *SCHEMA_DOC_REL.split("/"))

    @classmethod
    def load(cls, root: str, paths: Optional[Iterable[str]] = None) -> "Project":
        """Load the default source set under `root`, or an explicit
        file/dir list (relative to cwd or absolute)."""
        root = os.path.abspath(root)
        py_files: list[str] = []
        full_tree = not paths
        if paths:
            for p in paths:
                p = os.path.abspath(p)
                if os.path.isdir(p):
                    for dirpath, dirnames, filenames in os.walk(p):
                        dirnames[:] = [d for d in dirnames if not _excluded(
                            os.path.join(dirpath, d))]
                        py_files.extend(os.path.join(dirpath, fn)
                                        for fn in sorted(filenames)
                                        if fn.endswith(".py"))
                else:
                    py_files.append(p)
        else:
            for pat in DEFAULT_PY_GLOBS:
                py_files.extend(_glob_under(root, pat))
        modules = [Module(fp, _rel_to(fp, root), _read(fp))
                   for fp in sorted(set(py_files))]
        return cls(root, modules, full_tree=full_tree)


def _read(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def _rel_to(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:
        rel = path
    return path if rel.startswith("..") else rel


def _glob_under(root: str, pattern: str) -> list:
    """`**`-aware glob rooted at `root`, skipping EXCLUDE_DIRS."""
    if "**" not in pattern:
        import glob

        return [p for p in glob.glob(os.path.join(root, pattern)) if not _excluded(p)]
    head, tail = (s.strip("/") for s in pattern.split("**", 1))
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, head) if head else root):
        dirnames[:] = [d for d in dirnames if not _excluded(os.path.join(dirpath, d))]
        out.extend(os.path.join(dirpath, fn) for fn in filenames if fnmatch.fnmatch(fn, tail))
    return out


def _excluded(path: str) -> bool:
    """EXCLUDE_DIRS entries match path components ('__pycache__') or
    '/'-joined sub-paths ('tests/fixtures')."""
    norm = path.replace(os.sep, "/")
    for x in EXCLUDE_DIRS:
        if "/" in x:
            if f"/{x}/" in f"/{norm}/":
                return True
        elif x in norm.split("/"):
            return True
    return False


# ---------------------------------------------------------------- baseline


@dataclass
class BaselineEntry:
    rule: str
    path: str
    message: str
    reason: str = ""


class Baseline:
    """Accepted findings: the gate fails on growth (a new finding) and
    staleness (an entry whose finding no longer fires)."""

    def __init__(self, entries: Optional[list] = None):
        self.entries: list[BaselineEntry] = list(entries or [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            data = json.load(f)
        return cls([BaselineEntry(rule=e["rule"], path=e["path"], message=e["message"],
                                  reason=e.get("reason", ""))
                    for e in data.get("entries", [])])

    def save(self, path: str) -> None:
        data = {
            "comment": (
                "xflowlint baseline of the PyTorch port: findings accepted with "
                "a reason. The gate fails on NEW findings and on STALE entries "
                "(a fixed finding must leave this file). Regenerate with "
                "python -m xflow_tpu_torch.tools.xflowlint --write-baseline "
                "after auditing every entry."
            ),
            "entries": [dataclasses.asdict(e) for e in sorted(
                self.entries, key=lambda e: (e.path, e.rule, e.message))],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
            f.write("\n")

    def split(self, findings: list, only_rules: Optional[set] = None) -> tuple:
        """-> (new_findings, baselined_findings, stale_entries).

        `only_rules` scopes the staleness check to the entries of the
        rules that ran: a `--rules XF301` run must not report an XF401
        entry stale because the config pass was skipped."""
        fired = {f.fingerprint() for f in findings}
        known = {(e.rule, e.path, e.message) for e in self.entries}
        new = [f for f in findings if f.fingerprint() not in known]
        base = [f for f in findings if f.fingerprint() in known]
        stale = [e for e in self.entries
                 if (e.rule, e.path, e.message) not in fired
                 and (only_rules is None or e.rule in only_rules)]
        return new, base, stale


# ---------------------------------------------------------- running passes

# rules whose analysis only runs on full-tree scans: a partial scan
# cannot fire them, so it must not call their baseline entries stale
FULL_TREE_RULES = ("XF402",)

# pass name -> (runner, rule ids); filled by xflow_tpu_torch.analysis.passes
PASS_REGISTRY: dict[str, tuple] = {}


def register_pass(name: str, rules: tuple) -> Callable:
    def deco(fn: Callable) -> Callable:
        PASS_REGISTRY[name] = (fn, rules)
        return fn

    return deco


def run_passes(project: Project, only_rules: Optional[set] = None) -> list:
    """Run every registered pass, apply suppressions, and return the
    findings sorted by (path, line, rule), one per defect. An
    unparseable file yields XF001."""
    import xflow_tpu_torch.analysis.passes  # noqa: F401  (registers the passes)

    raw: list[Finding] = []
    if only_rules is None or "XF001" in only_rules:
        raw.extend(Finding(rule="XF001", path=mod.relpath, line=1,
                           message=f"syntax error: {mod.syntax_error}",
                           hint="xflowlint needs parseable sources to analyze")
                   for mod in project.modules if mod.syntax_error is not None)
    for name in sorted(PASS_REGISTRY):
        runner, rules = PASS_REGISTRY[name]
        if only_rules is not None and not set(rules) & only_rules:
            continue
        raw.extend(f for f in runner(project) if only_rules is None or f.rule in only_rules)
    sources = {m.relpath: m for m in project.modules}
    kept = [f for f in raw if f.path not in sources
            or not sources[f.path].suppressed(f.rule, f.line)]
    # dedup: two passes (or one fixpoint sweep visiting a loop body
    # twice) must not report one defect twice
    seen: set = set()
    unique = []
    for f in sorted(kept, key=lambda f: (f.path, f.line, f.rule, f.message)):
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique
