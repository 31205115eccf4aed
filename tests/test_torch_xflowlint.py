"""PyTorch port, xflowlint's AST tier (`xflow_tpu_torch/analysis/`, the CLI
`python -m xflow_tpu_torch.tools.xflowlint`), held against the reference's
passes (`xflow_tpu/analysis/`) on their shared fixture corpus:

- the rules both packages run (XF001, XF301, XF401, XF501/XF502) give the
  same (rule, line) sets on `tests/fixtures/xflowlint/`'s lockset, schema,
  config, suppression and clean fixtures; the port reads its own config
  tree, which lacks four of the reference's leaves on purpose, and a read of
  one of those four is the one place the two differ;
- the torch host-sync corpus (`tests/fixtures/xflowlint_torch/`) fires
  XF110/XF111 on every marked line and nowhere else: the one-behind staged
  read, the non-blocking copy into pinned memory, metadata reads and a
  read-only loop stay silent;
- a violation seeded into a copy of a real module of the port is caught with
  its rule id and line;
- the baseline's new / known / stale split, the refused placeholder reason,
  and the CLI's exit codes 0 / 1 / 2 / 3;
- the live tree lints clean against the committed baseline, every baseline
  entry and inline suppression carries a reason, and the lint runs with
  jax, xflow_tpu and torch blocked.

Everything here is stdlib `ast` over source files: nothing under analysis is
imported or run.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from xflow_tpu.analysis import core as jcore  # noqa: E402
from xflow_tpu.analysis.passes.config_keys import ConfigTree as JConfigTree  # noqa: E402
from xflow_tpu_torch.analysis.core import (  # noqa: E402
    Baseline, BaselineEntry, Finding, Project, run_passes,
)
from xflow_tpu_torch.analysis.passes.config_keys import ConfigTree  # noqa: E402
from xflow_tpu_torch.analysis.passes.hostsync import kernel_wrappers  # noqa: E402
from xflow_tpu_torch.tools import xflowlint as cli  # noqa: E402

FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "xflowlint")
TORCH_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "xflowlint_torch")
SHARED_RULES = {"XF001", "XF301", "XF401", "XF501", "XF502"}
# the reference's leaves the port's Config lacks on purpose: four data
# knobs the port's input plane does not take
PORT_LACKS = {("data", "block_bytes"), ("data", "drop_remainder"), ("data", "packed_tables"),
              ("data", "use_native_parser")}
PARITY_FIXTURES = ("bad_lockset.py", "good_lockset.py", "bad_schema.py", "bad_config.py",
                   "suppress_line.py", "suppress_file.py", "good_clean.py")


def lint(*paths, root=REPO_ROOT, rules=None):
    return run_passes(Project.load(root, list(paths)), only_rules=set(rules) if rules else None)


def jlint(*paths, rules):
    return jcore.run_passes(jcore.Project.load(REPO_ROOT, list(paths)), only_rules=set(rules))


def rule_lines(findings, rules=SHARED_RULES):
    return {(f.rule, f.line) for f in findings if f.rule in rules}


def marker_lines(path, rule):
    """Lines carrying a `# XFnnn:` expectation marker."""
    with open(path) as f:
        return {i for i, line in enumerate(f, 1) if f"# {rule}:" in line}


def run_cli(*args):
    return cli.main(list(args))


# ------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("fixture", PARITY_FIXTURES)
def test_shared_rules_match_the_reference_on_the_corpus(fixture):
    path = os.path.join(FIXTURES, fixture)
    got = rule_lines(lint(path))
    assert got == rule_lines(jlint(path, rules=SHARED_RULES))
    if fixture.startswith("bad_"):
        assert got  # the corpus's bad files fire on the port too


def test_the_corpus_fires_the_named_defects():
    (lock, cfg, schema) = (lint(os.path.join(FIXTURES, f)) for f in (
        "bad_lockset.py", "bad_config.py", "bad_schema.py"))
    attrs = {re.search(r"`self\.(\w+)`", f.message).group(1) for f in lock}
    assert {f.rule for f in lock} == {"XF301"} and {"_f", "_size"} <= attrs
    assert all("thread:_health_loop" in f.message and "external" in f.message for f in lock)
    assert {f.rule for f in cfg} == {"XF401"}
    assert {f.line for f in cfg} == marker_lines(os.path.join(FIXTURES, "bad_config.py"),
                                                 "XF401")
    blob = " ".join(f.message for f in schema)
    assert {f.rule for f in schema} == {"XF501", "XF502"}
    assert "queue_wait_p50ms" in blob and "stepp" in blob and '"shadow"' in blob


def test_the_config_trees_differ_by_the_five_leaves():
    port = {p for p, _ in ConfigTree.parse(os.path.join(
        REPO_ROOT, "xflow_tpu_torch", "config.py")).leaves()}
    ref = {p for p, _ in JConfigTree.parse(os.path.join(REPO_ROOT, "xflow_tpu",
                                                        "config.py")).leaves()}
    assert ref - port == PORT_LACKS and port <= ref


def test_a_leaf_the_port_lacks_is_the_one_difference(tmp_path):
    src = tmp_path / "reads.py"
    src.write_text("def f(cfg):\n"
                   "    return cfg.train.log_every\n"
                   + "".join(f"\n\ndef g{i}(cfg):\n    return cfg.{a}.{b}\n"
                             for i, (a, b) in enumerate(sorted(PORT_LACKS))))
    lines = {6 + 4 * i for i in range(len(PORT_LACKS))}
    assert {f.line for f in lint(str(src), rules=["XF401"])} == lines
    assert jlint(str(src), rules={"XF401"}) == []


def test_suppressions_silence_the_port_passes(tmp_path):
    with open(os.path.join(FIXTURES, "bad_lockset.py")) as f:
        src = f.read().splitlines()
    flagged = {f.line for f in lint(os.path.join(FIXTURES, "bad_lockset.py"))}
    per_line = tmp_path / "per_line.py"
    per_line.write_text("\n".join(ln + "  # xflowlint: disable=XF301" if i in flagged else ln
                                  for i, ln in enumerate(src, 1)) + "\n")
    assert flagged and lint(str(per_line)) == []
    for directive in ("XF301", "all"):
        whole = tmp_path / f"whole_{directive}.py"
        whole.write_text(f"# xflowlint: disable-file={directive}\n" + "\n".join(src) + "\n")
        assert lint(str(whole)) == []
    other = tmp_path / "other.py"
    other.write_text("# xflowlint: disable-file=XF401\n" + "\n".join(src) + "\n")
    assert {f.rule for f in lint(str(other))} == {"XF301"}


def test_a_file_that_does_not_parse_is_xf001(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert [f.rule for f in lint(str(bad))] == ["XF001"]
    assert lint(str(bad), rules=["XF301"]) == []
    bad.write_text("# xflowlint: disable-file=XF001 (generated)\ndef f(:\n")
    assert lint(str(bad)) == []


# --------------------------------------------------------- host syncs


def test_hostsync_corpus_fires_on_every_marker():
    path = os.path.join(TORCH_FIXTURES, "bad_hostsync.py")
    findings = lint(path)
    assert {f.rule for f in findings} == {"XF110", "XF111"}
    for rule in ("XF110", "XF111"):
        assert {f.line for f in findings if f.rule == rule} == marker_lines(path, rule), rule
    blob = " ".join(f.message for f in findings)
    for needle in (".item()", "print", "f-string", "bool", ".cpu()", ".to(cpu)", ".tolist()",
                   "torch.cuda.synchronize()", "numpy.asarray", ".synchronize()", "int",
                   "branch condition", "iteration over"):
        assert needle in blob, needle


def test_hostsync_one_behind_read_pinned_copy_and_metadata_stay_silent():
    """The staged read one step behind is aged by the newer dispatch (no
    suppression involved); `.to("cpu", non_blocking=True)` into a pinned
    buffer, `.shape` and `len()` read no value; the epilogue loop
    dispatches nothing."""
    path = os.path.join(TORCH_FIXTURES, "bad_hostsync.py")
    with open(path) as f:
        silent = {i for i, ln in enumerate(f, 1) if "# silent:" in ln}
    assert len(silent) == 4
    assert not silent & {f.line for f in lint(path)}


def test_hostsync_sources_include_the_kernel_wrappers(tmp_path):
    wrappers = kernel_wrappers(REPO_ROOT)
    for name in ("table_gather_sorted", "row_sums_sorted", "scatter_sorted",
                 "scatter_ftrl_sorted", "table_gather_sorted_multi", "scatter_sorted_multi",
                 "gather_sorted_cuda", "block_scale", "lab_rowsum"):
        assert name in wrappers, name
    assert not any(n.endswith("_plain") for n in wrappers) and "plan_sorted_batch" not in wrappers
    root = tmp_path / "root"
    shutil.copytree(os.path.join(REPO_ROOT, "xflow_tpu_torch", "ops"),
                    root / "xflow_tpu_torch" / "ops")
    src = root / "loop.py"
    src.write_text("from xflow_tpu_torch.ops import sorted_table as st\n\n\n"
                   "class T:\n"
                   "    def _fit(self, plans, d, w):\n"
                   "        for p in plans:\n"
                   "            g = st.scatter_sorted(d, p, None, 64, 4)\n"
                   "            if g.abs().max() > 1:\n"
                   "                break\n")
    assert [(f.rule, f.line) for f in lint(str(src), root=str(root))] == [("XF111", 8)]
    # outside the hot qualnames the same loop is not the pass's business
    src.write_text(src.read_text().replace("def _fit(", "def sweep("))
    assert lint(str(src), root=str(root)) == []


# ------------------------------------------ seeded faults in real modules

SEEDS = [
    # (rule, module, anchor line, the line inserted after it)
    ("XF110", "xflow_tpu_torch/train/trainer.py", "m = log.dispatch(batch, host)",
     "self.state, m2 = self.train_step(self.state, batch); print(float(m2['loss']))"),
    ("XF401", "xflow_tpu_torch/train/trainer.py", "hb_every = cfg.train.heartbeat_every",
     "lag = cfg.train.lag_every"),
    ("XF301", "xflow_tpu_torch/train/checkpoint.py", "self.skips += 1",
     "self.skips = max(self.skips, 0)"),
]


@pytest.mark.parametrize("rule,module,anchor,seed", SEEDS, ids=[s[0] for s in SEEDS])
def test_a_seeded_violation_in_a_real_module_is_caught(tmp_path, rule, module, anchor, seed):
    for rel in (module, "xflow_tpu_torch/config.py", "docs/OBSERVABILITY.md"):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(REPO_ROOT, rel), tmp_path / rel)
    target = tmp_path / module
    assert lint(str(target), root=str(tmp_path), rules=[rule]) == []
    lines = target.read_text().splitlines()
    at = next(i for i, ln in enumerate(lines) if anchor in ln)
    indent = lines[at][: len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at + 1, indent + seed)
    target.write_text("\n".join(lines) + "\n")
    found = lint(str(target), root=str(tmp_path), rules=[rule])
    assert [(f.rule, f.line) for f in found] == [(rule, at + 2)], found


def test_a_dead_key_is_reported_on_full_tree_runs_only(tmp_path):
    pkg = tmp_path / "xflow_tpu_torch"
    pkg.mkdir()
    with open(os.path.join(REPO_ROOT, "xflow_tpu_torch", "config.py")) as f:
        src = f.read()
    (pkg / "config.py").write_text(src.replace(
        "class TrainConfig:\n", "class TrainConfig:\n    zz_never_read: int = 0\n", 1))
    (pkg / "reader.py").write_text("def f(cfg):\n    return cfg.train.epochs\n")
    full = run_passes(Project.load(str(tmp_path)), only_rules={"XF402"})
    dead = {f.message.split("`")[1] for f in full}
    assert "train.zz_never_read" in dead and "train.epochs" not in dead
    assert run_passes(Project.load(str(tmp_path), [str(pkg / "reader.py")]),
                      only_rules={"XF402"}) == []


def test_the_default_source_set_is_the_ports_own():
    rels = {m.relpath for m in Project.load(REPO_ROOT).modules}
    assert "chip_smoke.py" in rels and "xflow_tpu_torch/tools/xflowlint.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("xflow_tpu_torch/") for r in rels)
    assert not any(part in r for r in rels for part in ("/_build/", "/csrc/", "/native/"))


# ----------------------------------------------------- baseline and CLI


def _finding(rule="XF301", path="a.py", line=3, message="m"):
    return Finding(rule=rule, path=path, line=line, message=message)


def test_baseline_split_new_known_stale():
    base = Baseline([BaselineEntry("XF301", "a.py", "m", reason="kept")])
    new, known, stale = base.split([_finding(), _finding(line=9)])
    assert not new and len(known) == 2 and not stale  # lines are not the fingerprint
    new, known, stale = base.split([_finding(message="other")])
    assert len(new) == 1 and not known and len(stale) == 1
    # staleness is scoped to the rules that ran
    assert base.split([], only_rules={"XF401"})[2] == []
    assert len(base.split([], only_rules={"XF301"})[2]) == 1


def test_cli_exit_codes(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "bad_lockset.py")
    clean = os.path.join(FIXTURES, "good_clean.py")
    bl = str(tmp_path / "bl.json")
    assert run_cli(bad, "--no-baseline") == 1 and "XF301" in capsys.readouterr().out
    # new entries need a reason; a refused write leaves no file
    assert run_cli(bad, "--write-baseline", "--baseline", bl) == 3
    assert "--reason" in capsys.readouterr().err and not os.path.exists(bl)
    # a partial scan never overwrites the tree's baseline
    assert run_cli(bad, "--write-baseline", "--reason", "r") == 3
    assert "PARTIAL" in capsys.readouterr().err
    assert run_cli(bad, "--write-baseline", "--baseline", bl, "--reason", "drill") == 0
    assert all(e.reason == "drill" for e in Baseline.load(bl).entries)
    assert run_cli(bad, "--baseline", bl) == 0
    assert "suppressed by baseline" in capsys.readouterr().out
    assert run_cli(clean, "--baseline", bl) == 2
    assert "STALE baseline entry" in capsys.readouterr().out
    assert run_cli(bad, "--no-baseline", "--json") == 1
    data = json.loads(capsys.readouterr().out)
    assert data["new"] and data["stale_baseline"] == [] and data["baselined"] == 0
    # an audited reason survives regeneration
    base = Baseline.load(bl)
    base.entries[0].reason = "audited"
    base.save(bl)
    assert run_cli(bad, "--write-baseline", "--baseline", bl, "--reason", "regen") == 0
    assert any(e.reason == "audited" for e in Baseline.load(bl).entries)
    # the placeholder reason fails the audit
    Baseline([BaselineEntry("XF301", "a.py", "m", reason="TODO: justify or fix")]).save(bl)
    assert run_cli(bad, "--baseline", bl) == 3
    assert "placeholder" in capsys.readouterr().err
    assert run_cli("--rules", "XF999") == 3
    assert run_cli("--rules", "XF301", "--write-baseline") == 3
    assert run_cli("--list-rules") == 0
    assert "lockset: XF301" in capsys.readouterr().out


def test_the_live_tree_is_clean_against_the_committed_baseline(capsys):
    assert run_cli() == 0, capsys.readouterr()
    entries = Baseline.load(cli.DEFAULT_BASELINE).entries
    assert all(e.reason.strip() and e.reason != cli.REASON_PLACEHOLDER for e in entries)


def test_every_inline_suppression_in_the_port_says_why():
    """A `# xflowlint: disable=` line carries its reason after the rule
    list, or on the comment line just above it."""
    sites = 0
    for mod in Project.load(REPO_ROOT).modules:
        for i, line in enumerate(mod.lines):
            m = re.search(r"#\s*xflowlint:\s*disable(-file)?=[A-Za-z0-9_, ]+(.*)$", line)
            if not m:
                continue
            sites += 1
            above = mod.lines[i - 1].strip() if i else ""
            assert m.group(2).strip() or above.startswith("#"), f"{mod.relpath}:{i + 1}"
    assert sites >= 1


def test_the_lint_runs_with_jax_xflow_tpu_and_torch_blocked():
    code = ("import runpy, sys\n"
            "for name in ('jax', 'xflow_tpu', 'torch'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path.insert(0, {REPO_ROOT!r})\n"
            "sys.argv = ['xflowlint', *sys.argv[1:]]\n"
            "runpy.run_module('xflow_tpu_torch.tools.xflowlint', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "0 new" in r.stderr
    r = subprocess.run([sys.executable, "-c", code, "--list-rules"], cwd=REPO_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.split("\n")[:4] == [
        "config-cross-check: XF401, XF402", "host-sync: XF110, XF111", "lockset: XF301",
        "schema-drift: XF501, XF502"], r.stdout
