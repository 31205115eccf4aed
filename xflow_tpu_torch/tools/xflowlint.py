"""xflowlint for the PyTorch port: the AST tier over the port's sources.

Runs the xflow_tpu_torch/analysis passes over `xflow_tpu_torch/**/*.py`
and `chip_smoke.py` (or explicit paths) and gates against the committed
baseline. Nothing is imported from the code under analysis, and neither
torch nor jax is needed.

    python -m xflow_tpu_torch.tools.xflowlint                  # full tree, baselined
    python -m xflow_tpu_torch.tools.xflowlint xflow_tpu_torch/serve   # a subset
    python -m xflow_tpu_torch.tools.xflowlint --rules XF301    # one rule family
    python -m xflow_tpu_torch.tools.xflowlint --write-baseline --reason "..."
    python -m xflow_tpu_torch.tools.xflowlint --list-rules

Exit codes:
    0  clean: no unbaselined findings, no stale baseline entries
    1  NEW findings (not in the baseline)
    2  STALE baseline entries (a fixed finding must leave the baseline)
    3  usage or internal error (a baseline entry still carrying the
       "TODO: justify or fix" placeholder reason included)

The baseline (xflow_tpu_torch/tools/xflowlint_baseline.json) makes the
gate fail on growth, not existence; an inline `# xflowlint:
disable=RULE` handles a single deliberate site, with a comment saying
why.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from xflow_tpu_torch.analysis.core import (
    FULL_TREE_RULES, PASS_REGISTRY, Baseline, BaselineEntry, Project, run_passes,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(REPO_ROOT, "xflow_tpu_torch", "tools", "xflowlint_baseline.json")
REASON_PLACEHOLDER = "TODO: justify or fix"


def _plural(n: int, one: str, many: str) -> str:
    return f"{n} {one if n == 1 else many}"


def _write_baseline(args, findings, target: str) -> int:
    """Record the findings as the baseline at `target`. Reasons carry
    over from the target file, so an audited reason survives
    regeneration; NEW entries take --reason, and without it the write
    is refused, so the placeholder never lands in a baseline."""
    reasons = {(e.rule, e.path, e.message): e.reason
               for e in Baseline.load(target).entries
               if e.reason and e.reason != REASON_PLACEHOLDER}
    out, seen, unreasoned = Baseline(), set(), []
    for f in findings:
        fp = f.fingerprint()
        if fp in seen:
            continue
        seen.add(fp)
        reason = reasons.get(fp) or args.reason
        if not reason:
            unreasoned.append(f)
            continue
        out.entries.append(BaselineEntry(rule=f.rule, path=f.path, message=f.message,
                                         reason=reason))
    if unreasoned:
        print(f"xflowlint: --write-baseline refused: "
              f"{_plural(len(unreasoned), 'NEW entry', 'NEW entries')} without a "
              "justification; pass --reason \"why this finding is accepted\" "
              "(prefer fixing the finding):", file=sys.stderr)
        for f in unreasoned[:10]:
            print(f"  {f.path}: {f.rule}: {f.message}", file=sys.stderr)
        return 3
    out.save(target)
    print(f"xflowlint: wrote {_plural(len(out.entries), 'baseline entry', 'baseline entries')} "
          f"to {target}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xflowlint", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files/dirs to lint (default: the port's tree)")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root (anchors xflow_tpu_torch/config.py and "
                         "docs/OBSERVABILITY.md)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {DEFAULT_BASELINE} on full-tree "
                         "runs; none on explicit paths)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record the current findings as the new baseline "
                         "(NEW entries require --reason)")
    ap.add_argument("--reason", default=None,
                    help="justification recorded on NEW baseline entries written by "
                         "--write-baseline (audited entries keep their reasons)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (e.g. XF301,XF401)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    import xflow_tpu_torch.analysis.passes  # noqa: F401  (registers the passes)

    if args.list_rules:
        for name, (_fn, rules) in sorted(PASS_REGISTRY.items()):
            print(f"{name}: {', '.join(rules)}")
        return 0

    only = None
    if args.rules:
        only = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r for _fn, rules in PASS_REGISTRY.values() for r in rules}
        bad = only - known - {"XF001"}
        if bad:
            print(f"xflowlint: unknown rule(s): {', '.join(sorted(bad))}", file=sys.stderr)
            return 3

    try:
        project = Project.load(args.root, args.paths or None)
    except OSError as e:
        print(f"xflowlint: {e}", file=sys.stderr)
        return 3
    findings = run_passes(project, only_rules=only)

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline and project.full_tree:
        baseline_path = DEFAULT_BASELINE

    if args.write_baseline:
        if not project.full_tree and args.baseline is None:
            print("xflowlint: --write-baseline over an explicit path set would overwrite "
                  "the tree's baseline with a PARTIAL scan (every entry outside the "
                  "scanned paths would be dropped); pass an explicit --baseline file",
                  file=sys.stderr)
            return 3
        if only is not None:
            print("xflowlint: --write-baseline with --rules would drop every other "
                  "rule's baseline entries; rerun without --rules", file=sys.stderr)
            return 3
        return _write_baseline(args, findings, baseline_path or DEFAULT_BASELINE)

    baseline = Baseline() if args.no_baseline or not baseline_path \
        else Baseline.load(baseline_path)
    # the placeholder reason must never gate: it means an entry was
    # recorded without a justification
    placeholders = [e for e in baseline.entries if e.reason == REASON_PLACEHOLDER]
    if placeholders:
        print(f"xflowlint: baseline audit FAILED: "
              f"{_plural(len(placeholders), 'entry still carries', 'entries still carry')} "
              f"the {REASON_PLACEHOLDER!r} placeholder reason; justify (edit the reason) "
              "or fix the finding and remove the entry:", file=sys.stderr)
        for e in placeholders[:10]:
            print(f"  {e.path}: {e.rule}: {e.message}", file=sys.stderr)
        return 3

    new, based, stale = baseline.split(findings, only_rules=only)
    if not project.full_tree:
        # a partial scan cannot have fixed a full-tree-only finding
        stale = [e for e in stale if e.rule not in FULL_TREE_RULES]

    if args.json:
        print(json.dumps({
            "new": [dataclasses.asdict(f) for f in new],
            "baselined": len(based),
            "stale_baseline": [{"rule": e.rule, "path": e.path, "message": e.message}
                               for e in stale],
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        if based:
            print(f"xflowlint: {len(based)} finding(s) suppressed by baseline "
                  f"({baseline_path})")
        for e in stale:
            print(f"xflowlint: STALE baseline entry (finding no longer fires: remove "
                  f"it): {e.path}: {e.rule}: {e.message}")
    print(f"xflowlint: {len(project.modules)} files, {len(findings)} finding(s): "
          f"{len(new)} new, {len(based)} baselined, "
          f"{_plural(len(stale), 'stale baseline entry', 'stale baseline entries')}",
          file=sys.stderr)
    if new:
        return 1
    return 2 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
