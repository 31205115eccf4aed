"""The port's trace attribution (`python -m xflow_tpu_torch.tools.trace_attrib`),
held against the JAX package's `tools/trace_attrib.py`:

- a Chrome trace in `torch.profiler`'s format, with scope ranges on the
  fit loop's thread (the fused step's four, then the two-pass step's
  `grad` around `gather` and `loss`, and `optimizer`), a backward kernel
  launched from an autograd worker inside `grad`, a prefetch thread's
  copy inside `grad` that must fall under `other`, a kernel joined by its
  `ac2g` flow alone, a device event with no launch inside a
  `gpu_user_annotation` span, host events and a zero-length kernel, is
  attributed event by event as stated;
- with no scope range at all the kernel-name keywords decide;
- exit codes 0 / 1 / 2, and the `--json` shape and the table's header
  equal the JAX tool's on its own fixture;
- a real CPU trace of the port trainer's trace window holds, for each step
  form, the scope labels the JAX step's compiled ops carry (their
  `op_name` paths, `jvp(...)`/`transpose(...)` components included) for
  the same configuration, a superset of the JAX `CompileRecorder`'s
  `op_scopes` labels.
"""

import json
import os
import re
import subprocess
import sys

import pytest

import xflow_tpu.ops.sorted_table as jst
import xflow_tpu.telemetry as jtel
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.telemetry import SCOPE_LABELS
from xflow_tpu_torch.tools import trace_attrib as ta
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURE = os.path.join(REPO_ROOT, "tests", "data", "minimal.trace.json.gz")
FIT, AUTOGRAD, PREFETCH = 100, 200, 300  # the host threads' tids
DEV, STREAM = 0, 7  # the card's pid and stream row


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, FIT, tid, ts, 3, correlation=corr)


def _kernel(name, ts, dur, corr=None, cat="kernel"):
    args = {} if corr is None else {"correlation": corr}
    return _x(cat, name, DEV, STREAM, ts, dur, **args)


# (name, scope it must take, device us)
EXPECTED = [
    ("void xf_gather_flat::gather_flat<false>(xf_gather_flat::Args)", "gather", 40),
    ("(anonymous namespace)::row_sums_count_kernel(float const*, int)", "loss", 30),
    ("void at::native::vectorized_elementwise_kernel<4>", "grad", 5),
    ("void at::native::elementwise_kernel<128, 2> (autograd)", "grad", 20),
    ("Memcpy HtoD (Pageable -> Device)", "other", 50),
    ("Memset (Device)", "scatter_optimizer", 1),
    ("void (anonymous namespace)::scatter_ftrl_kernel<4>(float const*)", "scatter_optimizer",
     70),
    ("Memcpy DtoH (Device -> Pinned)", "other", 3),
    ("void xf_gather_flat::gather_flat<false> (by its flow)", "gather", 12),
    ("void at::native::reduce_kernel<512, 1>", "loss", 10),
    ("void xf_staged::staged_scatter_kernel<11>(float const*)", "grad", 25),
    ("void at::native::vectorized_elementwise_kernel<4> (optimizer)", "optimizer", 15),
    ("void at::native::index_add_kernel (no launch)", "grad", 4),
]


def torch_fixture(ranges: bool = True) -> dict:
    """A trace as `torch.profiler` exports it: two steps (the fused
    step's ranges, then the two-pass step's nested ones)."""
    n = {name: i for i, (name, _, _) in enumerate(EXPECTED)}
    dur = {name: d for name, _, d in EXPECTED}
    ev = [
        {"ph": "M", "name": "process_name", "pid": FIT, "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": FIT, "tid": FIT,
         "args": {"name": f"thread {FIT} (python)"}},
        {"ph": "M", "name": "thread_name", "pid": FIT, "tid": AUTOGRAD,
         "args": {"name": f"thread {AUTOGRAD} (pt_autograd_0)"}},
        {"ph": "M", "name": "thread_name", "pid": FIT, "tid": PREFETCH,
         "args": {"name": f"thread {PREFETCH} (python)"}},
        {"ph": "M", "name": "thread_name", "pid": DEV, "tid": STREAM,
         "args": {"name": "stream 7 "}},
        # host events: never device time
        _x("cpu_op", "aten::mul", FIT, FIT, 0, 5000),
        _x("python_function", "train_step", FIT, FIT, 0, 5000),
        # the autograd worker's backward ops, each around its launch
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", FIT, AUTOGRAD, 250,
           30, **{"Fwd thread id": 1}),
        _x("cpu_op", "autograd::engine::evaluate_function: IndexBackward0", FIT, AUTOGRAD,
           1205, 45),
    ]
    if ranges:
        for name, ts, d in (("gather", 0, 100), ("loss", 100, 100), ("grad", 200, 300),
                            ("scatter_optimizer", 500, 100), ("grad", 1000, 400),
                            ("gather", 1000, 100), ("loss", 1100, 100),
                            ("optimizer", 1400, 100)):
            ev.append(_x("user_annotation", name, FIT, FIT, ts, d))
        ev.append(_x("gpu_user_annotation", "grad", DEV, STREAM, 1990, 20))
    launches = [  # (expected row, launching thread, host ts)
        (0, FIT, 10), (1, FIT, 120), (2, FIT, 210), (3, AUTOGRAD, 260), (4, PREFETCH, 270),
        (5, FIT, 505), (6, FIT, 510), (7, FIT, 700), (9, FIT, 1150), (10, AUTOGRAD, 1210),
        (11, FIT, 1410)]
    for i, tid, ts in launches:
        name = EXPECTED[i][0]
        cat = ("gpu_memcpy" if name.startswith("Memcpy")
               else "gpu_memset" if name.startswith("Memset") else "kernel")
        ev.append(_launch(tid, ts, 1000 + i, "cudaMemcpyAsync" if cat != "kernel"
                          else "cudaLaunchKernel"))
        ev.append(_kernel(name, 3000 + 100 * i, dur[name], corr=1000 + i, cat=cat))
    # joined by its flow alone: the runtime event and the kernel lack the arg
    flow = EXPECTED[n["void xf_gather_flat::gather_flat<false> (by its flow)"]]
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", FIT, FIT, 1050, 3))
    ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 77, "pid": FIT, "tid": FIT,
               "ts": 1050})
    ev.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 77, "pid": DEV, "tid": STREAM,
               "ts": 4000, "bp": "e"})
    ev.append(_kernel(flow[0], 4000, flow[2]))
    # no launch in the trace: the device-side span decides
    ev.append(_kernel(EXPECTED[-1][0], 2000, EXPECTED[-1][2]))
    ev.append(_kernel("void zero_length_kernel", 5000, 0, corr=999))
    return {"schemaVersion": 1, "traceEvents": ev}


def _write(tmp_path, trace, name="trace_100_0.json"):
    path = tmp_path / name
    path.write_text(json.dumps(trace))
    return path


def _run(*args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=REPO_ROOT, timeout=120)


def test_scope_opens_a_profiler_range_of_a_known_label_only(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xflow_tpu_torch.telemetry import scope

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with scope("grad"), scope("gather"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = [e["name"] for e in ta.load_trace(str(tmp_path / "t.json"))
             if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["gather", "grad"]
    with pytest.raises(ValueError, match="expected one of"):
        scope("forward")


def test_each_device_event_takes_its_launchs_innermost_scope():
    got = [(e["name"], s) for e, s in ta.event_scopes(torch_fixture()["traceEvents"])]
    assert sorted(got) == sorted((name, scope) for name, scope, _ in EXPECTED)


def test_the_cli_totals_the_fixture(tmp_path):
    path = _write(tmp_path, torch_fixture())
    out = tmp_path / "a.json"
    r = _run("-m", "xflow_tpu_torch.tools.trace_attrib", str(tmp_path), "--json", str(out))
    assert r.returncode == 0, r.stderr
    got = json.loads(out.read_text())
    want = {}
    for _, scope, us in EXPECTED:
        ms, k = want.get(scope, (0, 0))
        want[scope] = (ms + us, k + 1)
    assert {s: (round(v["ms"] * 1e3), v["events"]) for s, v in got["scopes"].items()} == want
    assert got["total_ms"] == pytest.approx(sum(d for _, _, d in EXPECTED) / 1e3)
    assert f"# trace: {path}" in r.stdout and "grad" in r.stdout and "total" in r.stdout


def test_the_prefetch_copy_inside_grad_stays_other():
    ev = torch_fixture()["traceEvents"]
    scopes = dict((e["name"], s) for e, s in ta.event_scopes(ev))
    assert scopes["Memcpy HtoD (Pageable -> Device)"] == "other"
    assert scopes["void at::native::elementwise_kernel<128, 2> (autograd)"] == "grad"
    # without its thread name, the autograd launch is still known by its op
    ev = [e for e in ev if not (e.get("ph") == "M" and e.get("tid") == AUTOGRAD)]
    scopes = dict((e["name"], s) for e, s in ta.event_scopes(ev))
    assert scopes["void at::native::elementwise_kernel<128, 2> (autograd)"] == "grad"
    assert scopes["void xf_staged::staged_scatter_kernel<11>(float const*)"] == "grad"


def test_without_any_range_the_kernel_names_decide():
    got = dict((e["name"], s) for e, s in ta.event_scopes(torch_fixture(ranges=False)
                                                          ["traceEvents"]))
    want = {name: "other" for name, _, _ in EXPECTED}
    for name in want:
        if "gather_flat" in name:
            want[name] = "gather"
        elif "row_sums_" in name:
            want[name] = "loss"
        elif "scatter_ftrl" in name:
            want[name] = "scatter_optimizer"
        elif "staged_scatter" in name:
            want[name] = "grad"
    assert got == want


def test_exit_codes(tmp_path):
    tool = ("-m", "xflow_tpu_torch.tools.trace_attrib")
    assert _run(*tool, str(_write(tmp_path, torch_fixture()))).returncode == 0
    cpu = {"traceEvents": [_x("cpu_op", "aten::add", 1, 1, 0, 10),
                           _x("user_annotation", "grad", 1, 1, 0, 10)]}
    r = _run(*tool, str(_write(tmp_path, cpu, "trace_1_0.json")))
    assert r.returncode == 1 and "no device-op events" in r.stderr
    assert _run(*tool, str(tmp_path / "empty_dir_that_is_not_there")).returncode == 2
    (tmp_path / "empty").mkdir()
    assert _run(*tool, str(tmp_path / "empty")).returncode == 2
    bad = tmp_path / "bad" / "trace_1_0.json"
    bad.parent.mkdir()
    bad.write_text("{not json")
    assert _run(*tool, str(bad.parent)).returncode == 2


def test_find_trace_takes_the_newest_trace_under_a_directory(tmp_path):
    old = _write(tmp_path, {"traceEvents": []}, "trace_1_0.json")
    new = _write(tmp_path, torch_fixture(), "trace_1_1.json")
    os.utime(old, (1, 1))
    assert ta.find_trace(str(tmp_path)) == str(new)
    assert ta.find_trace(str(old)) == str(old)


def test_json_shape_and_table_equal_the_jax_tools(tmp_path):
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    jr = _run(os.path.join(REPO_ROOT, "tools", "trace_attrib.py"), JAX_FIXTURE, "--json",
              str(jout), env_extra={"JAX_PLATFORMS": "cpu"})
    tr = _run("-m", "xflow_tpu_torch.tools.trace_attrib", str(_write(tmp_path, torch_fixture())),
              "--json", str(tout))
    assert jr.returncode == tr.returncode == 0, (jr.stderr, tr.stderr)
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert set(j) == set(t) == {"total_ms", "scopes"}
    for got in (j, t):
        assert isinstance(got["total_ms"], float)
        for v in got["scopes"].values():
            assert set(v) == {"ms", "pct", "events"}
            assert isinstance(v["ms"], float) and isinstance(v["events"], int)
        assert sum(v["pct"] for v in got["scopes"].values()) == pytest.approx(100.0, abs=0.05)
    jlines, tlines = jr.stdout.splitlines(), tr.stdout.splitlines()
    assert jlines[1:3] == tlines[1:3]  # the header under the "# trace:" line
    assert jlines[-1].startswith("total") and tlines[-1].startswith("total")
    # the same --json to stdout
    r = _run("-m", "xflow_tpu_torch.tools.trace_attrib", str(tmp_path / "trace_100_0.json"),
             "--json", "-")
    assert json.loads(r.stdout.splitlines()[-1]) == t


# -------------------------------------------- real CPU traces of each step form

FORMS = {
    "lr": {"model.name": "lr"},
    "fm_fused": {"model.name": "fm"},
    "fm_two_pass": {"model.name": "fm", "optim.fused_scatter": "off"},
    "mvm_product": {"model.name": "mvm"},
    "mvm_segment": {"model.name": "mvm", "model.mvm_exclusive": "off"},
    "ffm_aligned": {"model.name": "ffm"},
}
BASE = {"model.v_dim": 4, "model.num_fields": 6, "data.max_nnz": 8, "data.batch_size": 64,
        "data.log2_slots": 14, "train.epochs": 1, "train.log_every": 0}


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    work = tmp_path_factory.mktemp("trace_forms")
    jgenerate_shards(str(work / "train"), 1, 128, num_fields=6, ids_per_field=40, seed=2)
    return work


def _jax_labels(monkeypatch, shard, form) -> tuple[set, set]:
    """(every scope label in the compiled JAX step's op_name paths, the
    CompileRecorder's op_scopes labels) for the form."""
    texts = []
    orig = jtel.CompileRecorder._op_scopes

    def spy(self, compiled):
        texts.append(compiled.as_text())
        return orig(self, compiled)

    monkeypatch.setattr(jtel.CompileRecorder, "_op_scopes", spy)
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")
    metrics = shard / f"j_{form}.jsonl"
    cfg = joverride(JConfig(), **BASE, **FORMS[form], **{
        "data.train_path": str(shard / "train"), "train.metrics_path": str(metrics),
        "data.use_native_parser": False})
    JTrainer(cfg).fit()
    paths = [n for t in texts for n in re.findall(r'op_name="([^"]+)"', t)]
    # a component may merge several ops' names with ";"; `jit(train_step)`
    # names the program, not a scope
    opened = {w for p in paths for comp in p.split("/")[:-1] for part in comp.split(";")
              if not part.startswith("jit(")
              for w in re.findall(r"\w+", part) if w in SCOPE_LABELS}
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    mapped = {s for r in recs if r.get("kind") == "compile" and r.get("program") == "train_step"
              for s in r["op_scopes"].values()}
    return opened, mapped


@pytest.mark.parametrize("form", sorted(FORMS))
def test_a_cpu_trace_holds_the_jax_steps_labels(monkeypatch, shard, form):
    opened, mapped = _jax_labels(monkeypatch, shard, form)
    prof = shard / f"prof_{form}"
    cfg = override(Config(), **BASE, **FORMS[form], **{
        "data.train_path": str(shard / "train"), "train.profile_dir": str(prof)})
    Trainer(cfg, device="cpu").fit()
    events = ta.load_trace(ta.find_trace(str(prof)))
    labels = {e["name"] for e in events if e.get("cat") == "user_annotation"
              and e["name"] in SCOPE_LABELS}
    assert labels == opened and mapped <= labels
    assert ("scatter_optimizer" in labels) == (form in ("fm_fused", "ffm_aligned"))
    # a CPU trace has no device events: the tool says so
    r = _run("-m", "xflow_tpu_torch.tools.trace_attrib", str(prof))
    assert r.returncode == 1
