"""The trainer's observability in the port, held against the JAX package:

- `StepTimer` (the split, its sum against the elapsed wall, an abandoned
  iterator closed), `HealthMonitor` (the EMA oracle, one step behind,
  off inert, the occupancy gauges), `HangWatchdog` (one dump a stall,
  off at 0) and `TraceWindow` (start and stop through the seam): the JAX
  tests of `tests/test_telemetry.py` and `tests/test_health.py`, run
  against both packages' telemetry;
- every config field both packages share has the JAX default;
- `estimate_collision_rate` and `pipeline_verdict` equal to JAX's on a
  grid of inputs;
- `health_norms`: the port's step against JAX's on the same state and
  batches, fused and two-pass, within 1e-5 relative;
- a `fit` in both packages on the same shard with every observability
  flag on (FM on the sorted path, then LR): the record kinds and key
  sets equal (less the roofline gauges and JAX's compile records), the
  logged losses within 1e-5, the final occupancy equal, the `eval_auc`
  within 1/buckets, the heartbeats' events equal, `pred_0_0.txt` rows
  within 1e-5 a pCTR; the reference's `tools/metrics_report.py --check`
  passes on the port's streams;
- with the guard off no loss is read before the next step's dispatch;
  StepTimer waits on each step's own event, one step behind, and the
  loop never synchronizes the device; the trace window writes a
  `torch.profiler` trace of its steps; the profiler off leaves the
  stream without pipeline records; the cache counters count as JAX's.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
import xflow_tpu.telemetry as jtel
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.pipeline import batch_iterator as jbatch_iterator
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu.train.step import make_train_step as jmake_train_step
from xflow_tpu.train.trainer import Trainer as JTrainer
import xflow_tpu_torch.telemetry as ttel
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data import pipeline
from xflow_tpu_torch.data import shardcache as tsc
from xflow_tpu_torch.evaluate import to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train.step import health_mode, make_train_step, metrics_keys
from xflow_tpu_torch.train.trainer import Trainer
from xflow_tpu_torch.weights import state_from_jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 6
S = 1 << LOG2_S
ROWS, TEST_ROWS = 640, 256
LOSS_RTOL, NORM_RTOL, PCTR_ATOL = 1e-5, 1e-5, 1e-5
PACKAGES = {"jax": jtel, "torch": ttel}
ROOFLINE = {"achieved_flops_per_s", "achieved_hbm_gbps"}


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


# ------------------------------------------------------------------ config


def _leaves(obj, prefix=""):
    import dataclasses

    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


NEW_TRAIN_FIELDS = ("eval_every", "pred_dump", "eval_buckets", "eval_window_decay",
                    "metrics_max_bytes", "health_metrics", "health_ema_decay", "heartbeat_path",
                    "heartbeat_every", "hang_timeout_s", "pipeline_metrics", "profile_dir",
                    "trace_start_step", "trace_num_steps", "compile_metrics")


def test_every_shared_config_field_has_the_jax_default():
    port, ref = _leaves(Config()), _leaves(JConfig())
    assert set(port) <= set(ref)
    for key, v in port.items():
        assert v == ref[key] and type(v) is type(ref[key]), key
    assert {f"train.{k}" for k in NEW_TRAIN_FIELDS} <= set(port)
    # every train leaf, compile_metrics (the work count's switch) included;
    # the sync tier whole
    assert {k for k in ref if k.startswith("train.")} == {k for k in port if k.startswith("train.")}
    assert {k for k in ref if k.startswith("sync.")} == {k for k in port if k.startswith("sync.")}
    assert len([k for k in port if k.startswith("sync.")]) == 9


# ------------------------------------------------------ the JAX unit tests


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_step_timer_decomposition_synthetic(pkg):
    tel = PACKAGES[pkg]
    st = tel.StepTimer(registry=tel.Registry())

    def feed():
        for i in range(30):
            time.sleep(0.002)
            yield i

    t0 = time.perf_counter()
    for _ in st.batches(feed()):
        time.sleep(0.001)
        st.dispatched({"loss": np.float32(0.5)}, rows=64)
    st.flush()
    elapsed = time.perf_counter() - t0
    assert (st.steps, st.rows) == (30, 30 * 64)
    rec = st.window_record()
    assert set(rec) == {"steps_per_s", "rows_per_s", "step_time_p50_ms", "step_time_p99_ms",
                        "data_wait_ms", "dispatch_ms", "device_ms"}
    assert rec["data_wait_ms"] >= 2.0 and rec["dispatch_ms"] >= 1.0
    assert rec["step_time_p99_ms"] >= rec["step_time_p50_ms"] > 0
    assert st.steps / max(rec["steps_per_s"], 1e-9) == pytest.approx(elapsed, rel=0.25)
    assert st.window_record() == {}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_step_timer_sum_matches_elapsed(pkg):
    tel = PACKAGES[pkg]
    st = tel.StepTimer(registry=tel.Registry())
    t0 = time.perf_counter()
    for _ in st.batches(iter(range(10))):
        time.sleep(0.003)
        st.dispatched({"loss": 0.0}, rows=1)
    st.flush()
    elapsed = time.perf_counter() - t0
    assert st._reg.timer("step.time").count == 10
    assert st._reg.timer("step.time").total_s == pytest.approx(elapsed, rel=0.2)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_step_timer_closes_abandoned_iterator(pkg):
    tel = PACKAGES[pkg]
    closed = {}

    def feed():
        try:
            while True:
                yield 0
        finally:
            closed["yes"] = True

    st = tel.StepTimer(registry=tel.Registry())
    for i, _ in enumerate(st.batches(feed())):
        st.dispatched({}, rows=1)
        if i == 2:
            break
    import gc

    gc.collect()
    assert closed.get("yes")


class FakeProfiler:
    def __init__(self):
        self.events = []

    def start_trace(self, d):
        self.events.append(("start", d))

    def stop_trace(self):
        self.events.append(("stop", None))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_trace_window_respects_step_range(pkg):
    tel = PACKAGES[pkg]
    prof = FakeProfiler()
    tw = tel.TraceWindow("dir", start_step=5, num_steps=3, profiler=prof)
    tw.maybe_start_run()
    assert prof.events == []
    for step in range(1, 13):
        tw.before_step(step)
        if step < 5:
            assert prof.events == []
    tw.close()
    assert prof.events == [("start", "dir"), ("stop", None)]
    tw2 = tel.TraceWindow("dir", 5, 3, profiler=FakeProfiler())
    for step in range(1, 8):
        tw2.before_step(step)
    assert tw2._running
    tw2.close()
    assert not tw2._running


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_trace_window_whole_run_and_disabled(pkg):
    tel = PACKAGES[pkg]
    prof = FakeProfiler()
    tw = tel.TraceWindow("dir", start_step=0, profiler=prof)
    tw.maybe_start_run()
    for step in range(1, 5):
        tw.before_step(step)
    tw.close()
    assert prof.events == [("start", "dir"), ("stop", None)]
    off = tel.TraceWindow("", start_step=5, num_steps=3, profiler=FakeProfiler())
    off.maybe_start_run()
    off.before_step(5)
    off.close()
    assert off._prof.events == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_health_monitor_ema_numpy_oracle(pkg):
    tel = PACKAGES[pkg]
    mon = tel.HealthMonitor(mode="norms", ema_decay=0.9, registry=tel.Registry())
    ema = None
    for loss in [0.7, 0.6, float("nan"), 0.5, 0.4]:
        mon.staged({"loss": np.float32(loss), "grad_norm": np.float32(1.0),
                    "update_norm": np.float32(0.1), "param_norm": np.float32(2.0)})
        mon.collect()
        if loss == loss:
            ema = loss if ema is None else 0.9 * ema + 0.1 * loss
        assert mon.loss_ema == pytest.approx(ema, rel=1e-6)
    rec = mon.window_record()
    assert rec["loss_ema"] == pytest.approx(ema, rel=1e-6)
    assert rec["grad_norm"] == pytest.approx(1.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_health_monitor_runs_one_behind_and_off_is_inert(pkg):
    tel = PACKAGES[pkg]
    mon = tel.HealthMonitor(mode="norms", registry=tel.Registry())
    assert mon.window_record() == {}
    mon.staged({"loss": np.float32(0.5)})
    assert mon.window_record() == {}
    mon.collect()
    assert mon.window_record()["loss_ema"] == pytest.approx(0.5)
    off = tel.HealthMonitor(mode="off", registry=tel.Registry(), num_slots=128)
    off.staged({"loss": np.float32(0.5)})
    off.collect()
    off.observe_batch(np.zeros((2, 2), np.int32), np.ones((2, 2), np.float32))
    assert off.window_record() == {}
    with pytest.raises(ValueError, match="off|norms|full"):
        tel.HealthMonitor(mode="bogus")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_occupancy_gauges(pkg):
    tel = PACKAGES[pkg]
    reg = tel.Registry()
    mon = tel.HealthMonitor(mode="full", registry=reg, num_slots=256)
    mon.observe_batch(np.array([[1, 2], [3, 1]], np.int32),
                      np.array([[1, 1], [0, 1]], np.float32))
    mon.staged({"loss": np.float32(0.5), "grad_norm": np.float32(3.0),
                "grad_norm.w": np.float32(3.0), "update_norm.w": np.float32(1.0)})
    mon.collect()
    rec = mon.window_record()
    assert rec["slots_touched"] == 2
    assert rec["table_occupancy"] == pytest.approx(2 / 256, abs=1e-6)
    assert reg.gauge("health.table_occupancy").value == pytest.approx(2 / 256)
    assert rec["health_tables"] == {"w": {"grad_norm": 3.0, "update_norm": 1.0}}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_hang_watchdog_dumps_once_per_stall(pkg):
    tel = PACKAGES[pkg]
    out = io.StringIO()
    wd = tel.HangWatchdog(0.15, out=out)
    try:
        time.sleep(0.6)
        assert wd.dumps == 1
        assert "hang watchdog" in out.getvalue() and "thread" in out.getvalue()
        wd.tick()
        time.sleep(0.6)
        assert wd.dumps == 2
    finally:
        wd.close()
    off = tel.HangWatchdog(0.0)
    assert off._thread is None
    off.close()


def test_estimate_collision_rate_equals_jax_on_a_grid():
    for S_ in (2, 3, 64, 4096, 1 << 20):
        for d in sorted({0, 1, 2, S_ // 3, S_ // 2, S_ - 1, S_, S_ + 5}):
            got = ttel.estimate_collision_rate(d, S_)
            assert got == jtel.estimate_collision_rate(d, S_), (d, S_)
            assert 0.0 <= got <= 1.0
    assert ttel.estimate_collision_rate(5, 1) == jtel.estimate_collision_rate(5, 1) == 0.0


def test_pipeline_verdict_equals_jax_on_a_grid():
    rng = np.random.default_rng(0)
    assert ttel.pipeline_verdict({}, 0.0) == jtel.pipeline_verdict({}, 0.0)
    assert ttel.PIPELINE_STAGES == jtel.PIPELINE_STAGES
    for _ in range(200):
        stages = {s: float(rng.random()) * rng.choice([0.0, 0.05, 1.0])
                  for s in ttel.PIPELINE_STAGES}
        wall = float(rng.choice([0.5, 1.0, 3.0]))
        assert ttel.pipeline_verdict(stages, wall) == jtel.pipeline_verdict(stages, wall)
    seen = {ttel.pipeline_verdict({"queue_wait": 0.5, "parse": 0.4}, 1.0).split(":")[0],
            ttel.pipeline_verdict({"producer_wait": 0.5}, 1.0).split(":")[0],
            ttel.pipeline_verdict({"device": 0.05}, 1.0).split(":")[0]}
    assert seen == {"host-bound in parse", "device-bound", "balanced"}


# ------------------------------------------------------------ health norms


def _pairs(model="fm", **extra):
    return {"model.name": model, "model.v_dim": V, "model.num_fields": NF,
            "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ, **extra}


def _batch(seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, NNZ)).astype(np.int32)
    slots[:3] = slots[3:6]
    mask = (rng.random((B, NNZ)) < 0.8).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    row_mask = np.ones(B, np.float32)
    row_mask[-5:] = 0.0
    mask[-5:] = 0.0
    plan = jst.plan_sorted_batch(slots, mask, S)
    return jst.compact_plan_wire({
        "labels": labels, "row_mask": row_mask, "sorted_slots": plan.sorted_slots,
        "sorted_row": plan.sorted_row, "sorted_mask": plan.sorted_mask,
        "win_off": plan.win_off,
    }, rows_bound=B)


NORM_VARIANTS = {
    "fused_ftrl": {},
    "two_pass_ftrl": {"optim.fused_scatter": "off"},
    "two_pass_sgd": {"optim.name": "sgd"},
}


@pytest.mark.parametrize("mode", ["norms", "full"])
@pytest.mark.parametrize("variant", sorted(NORM_VARIANTS))
def test_health_norms_match_jax(variant, mode):
    pairs = _pairs(**NORM_VARIANTS[variant], **{"train.health_metrics": mode})
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    js = jinit_state(jget_model("fm"), jget_optimizer(jcfg.optim.name), jcfg)
    ts = state_from_jax(
        {k: np.asarray(v) for k, v in js.tables.items()},
        {k: {leaf: np.asarray(a) for leaf, a in d.items()} for k, d in js.opt_state.items()},
        js.step, tcfg, device="cpu",
    )
    jstep = jmake_train_step(jget_model("fm"), jget_optimizer(jcfg.optim.name), jcfg, jit=False)
    tstep = make_train_step(get_model("fm")(tcfg), get_optimizer(tcfg.optim.name), tcfg)
    for i in range(2):
        arrays = _batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in arrays.items()})
        ts, tm = tstep(ts, to_device(arrays, "cpu"))
        assert set(tm) == set(jm) == set(metrics_keys(tcfg))
        for key in tm:
            if key not in ("loss", "rows", "update_ok"):
                want = float(jm[key])
                assert abs(float(tm[key]) - want) <= NORM_RTOL * abs(want), (key, i)
    if variant == "two_pass_sgd":  # the update is -lr * grad
        assert float(tm["update_norm"]) == pytest.approx(
            tcfg.optim.sgd.lr * float(tm["grad_norm"]), rel=1e-4)


def test_health_off_keeps_the_step_metrics():
    tcfg = override(Config(), **_pairs())
    assert health_mode(tcfg) == "off" and metrics_keys(tcfg) == ("loss", "rows", "update_ok")
    step = make_train_step(get_model("fm")(tcfg), get_optimizer("ftrl"), tcfg)
    from xflow_tpu_torch.train.state import init_state

    _, m = step(init_state(get_model("fm")(tcfg), get_optimizer("ftrl"), tcfg, "cpu"),
                to_device(_batch(0), "cpu"))
    assert set(m) == {"loss", "rows", "update_ok"}
    with pytest.raises(ValueError, match="health_metrics"):
        make_train_step(get_model("fm")(tcfg), get_optimizer("ftrl"),
                        override(tcfg, **{"train.health_metrics": "bogus"}))


# ----------------------------------------------------- fit in both packages


OBS = {
    "train.epochs": 2, "train.log_every": 1, "train.eval_every": 1,
    "train.health_metrics": "norms", "train.health_ema_decay": 0.9,
    "train.heartbeat_every": 1, "train.hang_timeout_s": 30.0,
    "train.pipeline_metrics": True, "data.max_bad_rows": -1,
}
FIT_MODELS = {"fm": _pairs("fm"), "lr": _pairs("lr")}


def _category(rec):
    if "kind" in rec:
        return rec["kind"]
    for key in ("final", "eval_auc", "loss", "nonfinite_skipped", "interrupted"):
        if key in rec:
            return key
    return "other"


def _shape(recs):
    """(category, key set) of each record, less the roofline gauges and
    JAX's compile records."""
    return [(_category(r), frozenset(set(r) - ROOFLINE)) for r in recs
            if r.get("kind") != "compile"]


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", params=sorted(FIT_MODELS))
def fit_runs(request, tmp_path_factory):
    model = request.param
    work = tmp_path_factory.mktemp(f"observe_{model}")
    jgenerate_shards(str(work / "train"), 1, ROWS, num_fields=NF, ids_per_field=40, seed=5)
    jgenerate_shards(str(work / "test"), 1, TEST_ROWS, num_fields=NF, ids_per_field=40,
                     seed=6, truth_seed=5)
    common = {**FIT_MODELS[model], **OBS, "data.train_path": str(work / "train"),
              "data.test_path": str(work / "test")}
    side = {s: {"train.checkpoint_dir": str(work / s / "ck"),
                "train.metrics_path": str(work / s / "run" / "metrics_rank0.jsonl"),
                "train.heartbeat_path": str(work / s / "run" / "heartbeat_rank0.jsonl")}
            for s in "tj"}
    out = {"work": work, "model": model}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_NATIVE_PLAN", None)
        mp.setenv("XFLOW_NO_NATIVE_PLAN", "1")
        jt = JTrainer(joverride(JConfig(), **common, **side["j"],
                                **{"data.use_native_parser": False}))
        jt.save_checkpoint()  # the shared initial state, step 0
        shutil.copytree(work / "j" / "ck" / "step_0", work / "t" / "ck" / "step_0")
        tt = Trainer(override(Config(), **common, **side["t"]), device="cpu")
        assert tt.maybe_restore() and tt.state.step == 0
        jtel.default_registry().reset()
        ttel.default_registry().reset()
        out["jres"], out["tres"] = jt.fit(), tt.fit()
        for s, t in (("j", jt), ("t", tt)):
            mp.chdir(work / s)
            out[f"{s}eval"] = t.evaluate(dump=True)
    out["jt"], out["tt"] = jt, tt
    for s in "tj":
        out[f"{s}recs"] = _read(side[s]["train.metrics_path"])
        out[f"{s}hb"] = _read(side[s]["train.heartbeat_path"])
    # the JAX stream opens with the shared step-0 save's span
    assert out["jrecs"][0]["kind"] == "span" and out["jrecs"][0]["step"] == 0
    out["jrecs"] = out["jrecs"][1:]
    return out


def test_fit_records_have_the_jax_kinds_and_keys(fit_runs):
    t, j = _shape(fit_runs["trecs"]), _shape(fit_runs["jrecs"])
    assert t == j
    cats = [c for c, _ in t]
    steps = fit_runs["tres"].steps
    assert cats.count("loss") == steps == 20 and cats.count("final") == 1
    assert cats.count("eval_auc") == 2 and cats.count("pipeline") == steps
    windows = [r for r in fit_runs["trecs"] if "loss" in r]
    assert [r["step"] for r in windows] == list(range(1, steps + 1))
    for r in windows:
        for key in ("data_wait_ms", "dispatch_ms", "device_ms", "grad_norm", "loss_ema",
                    "slots_touched", "table_occupancy", "est_collision_rate", "counters"):
            assert key in r, key


def test_fit_losses_occupancy_and_evals_match_jax(fit_runs):
    tw = [r for r in fit_runs["trecs"] if "loss" in r]
    jw = [r for r in fit_runs["jrecs"] if "loss" in r]
    for a, b in zip(tw, jw):
        assert a["step"] == b["step"] and a["examples"] == b["examples"]
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"]), a["step"]
        assert abs(a["loss_ema"] - b["loss_ema"]) <= 1e-4 * abs(b["loss_ema"])
        assert a["slots_touched"] == b["slots_touched"]
    tres, jres = fit_runs["tres"], fit_runs["jres"]
    assert tres.last_loss == pytest.approx(jres.last_loss, rel=LOSS_RTOL)
    assert tw[-1]["loss"] == tres.last_loss
    (tf,) = [r for r in fit_runs["trecs"] if r.get("final")]
    (jf,) = [r for r in fit_runs["jrecs"] if r.get("final")]
    assert tf["occupancy"] == jf["occupancy"] == tres.occupancy
    te = [r for r in fit_runs["trecs"] if "eval_auc" in r]
    je = [r for r in fit_runs["jrecs"] if "eval_auc" in r]
    for a, b in zip(te, je):
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        assert abs(a["eval_auc"] - b["eval_auc"]) <= 1.0 / 65536
        assert a["eval_logloss"] == pytest.approx(b["eval_logloss"], rel=1e-5)
    assert fit_runs["teval"][0] == pytest.approx(fit_runs["jeval"][0], abs=1e-6)


def test_fit_heartbeats_match_jax(fit_runs):
    def events(hb):
        return [(r.get("event"), r.get("step")) for r in hb]

    t, j = events(fit_runs["thb"]), events(fit_runs["jhb"])
    assert t == j
    assert t[0] == ("start", 0) and t[-1] == ("final", 20)
    assert [e for e, _ in t].count("eval") == 2
    assert all(r["kind"] == "heartbeat" for r in fit_runs["thb"])


def test_fit_pred_dump_matches_jax(fit_runs):
    rows = {}
    for s in "tj":
        with open(fit_runs["work"] / s / "pred_0_0.txt") as f:
            rows[s] = [line.split("\t") for line in f.read().splitlines()]
    assert len(rows["t"]) == len(rows["j"]) == TEST_ROWS
    for a, b in zip(rows["t"], rows["j"]):
        assert a[1:] == b[1:] and len(a[0]) == len(b[0])
        assert abs(float(a[0]) - float(b[0])) <= PCTR_ATOL


def test_metrics_report_check_passes_on_the_port_streams(fit_runs):
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    try:
        import metrics_report
    finally:
        sys.path.pop(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = metrics_report.main([str(fit_runs["work"] / "t" / "run"), "--check"])
    assert rc == 0, out.getvalue()


def test_streaming_eval_and_its_decayed_window_match_jax(fit_runs):
    tt, jt = fit_runs["tt"], fit_runs["jt"]
    auc_exact, ll_exact = tt.evaluate(dump=False)
    auc_stream, ll_stream = tt.evaluate(dump=False, streaming=True)
    assert auc_stream == pytest.approx(auc_exact, abs=1e-3)
    assert ll_stream == pytest.approx(ll_exact, rel=1e-9)
    tcfg, jcfg = tt.cfg, jt.cfg
    try:
        tt.cfg = override(tcfg, **{"train.eval_window_decay": 0.5})
        jt.cfg = joverride(jcfg, **{"train.eval_window_decay": 0.5})
        for _ in range(2):  # the second pass folds the decayed first into it
            (ta, tl), (ja, jl) = (tt.evaluate(dump=False, streaming=True),
                                  jt.evaluate(dump=False, streaming=True))
            assert abs(ta - ja) <= 1.0 / 65536 and tl == pytest.approx(jl, rel=1e-5)
        assert tt._eval_window[2] == jt._eval_window[2] == 1.5 * TEST_ROWS
    finally:
        tt.cfg, jt.cfg = tcfg, jcfg


def test_bucket_auc_decay_and_the_bucket_rule_match_jax():
    from xflow_tpu.metrics import BucketAUC as JBucketAUC
    from xflow_tpu.train.trainer import resolve_eval_buckets as jresolve
    from xflow_tpu_torch.metrics import BucketAUC, resolve_eval_buckets

    rng = np.random.default_rng(0)
    p, y = rng.random(500), (rng.random(500) < 0.3).astype(np.float64)
    t = BucketAUC.init(64).update(p, y).decay(0.25)
    j = JBucketAUC.init(64).update(p, y).decay(0.25)
    np.testing.assert_array_equal(t.pos, j.pos)
    np.testing.assert_array_equal(t.neg, j.neg)
    assert t.compute() == j.compute()
    for v in (-1, 0, 7):
        assert resolve_eval_buckets(v) == jresolve(v, False)


# ------------------------------------------------------- the loop's timing


class _Probe:
    """A scalar whose host read is recorded."""

    def __init__(self, value, step, log):
        self.value, self.step, self.log = float(value), step, log

    def __float__(self):
        self.log.append(("read", self.step))
        return self.value


@pytest.fixture(scope="module")
def small_shard(tmp_path_factory):
    work = tmp_path_factory.mktemp("observe_small")
    jgenerate_shards(str(work / "train"), 1, 6 * B, num_fields=NF, ids_per_field=40, seed=1)
    return work


@pytest.mark.parametrize("health", ["off", "norms"])
def test_guard_off_reads_no_loss_before_the_next_dispatch(small_shard, health):
    cfg = override(Config(), **_pairs(**{
        "data.train_path": str(small_shard / "train"), "train.epochs": 1,
        "train.log_every": 1, "train.nonfinite_guard": "off",
        "train.health_metrics": health}))
    t = Trainer(cfg, device="cpu")
    log = []
    step = t.train_step

    def recording(state, batch):
        new, m = step(state, batch)
        i = len([e for e in log if e[0] == "dispatch"]) + 1
        log.append(("dispatch", i))
        return new, {k: _Probe(v, i, log) if k != "rows" else v for k, v in m.items()}

    t.train_step = recording
    with contextlib.redirect_stderr(io.StringIO()):
        res = t.fit()
    assert res.steps == 6
    for i in range(1, 7):
        first_read = next(n for n, e in enumerate(log) if e == ("read", i))
        dispatched = [n for n, e in enumerate(log) if e[0] == "dispatch" and e[1] > i]
        if i < 6:
            assert dispatched and dispatched[0] < first_read, (i, log)


class _FakeEvent:
    def __init__(self, step, log):
        self.step, self.log = step, log

    def synchronize(self):
        self.log.append(("wait", self.step))


def test_step_timer_waits_on_each_steps_event_one_behind():
    log = []
    st = ttel.StepTimer(registry=ttel.Registry())
    for i in st.batches(iter(range(1, 5))):
        m = ttel.StagedMetrics(loss=np.float32(0.1))
        m.ready = _FakeEvent(i, log)
        log.append(("dispatch", i))
        st.dispatched(m, rows=1)
    st.flush()
    assert log == [("dispatch", 1), ("dispatch", 2), ("wait", 1), ("dispatch", 3), ("wait", 2),
                   ("dispatch", 4), ("wait", 3), ("wait", 4)]
    plain = {"loss": np.float32(0.1)}
    assert ttel.stage_metrics(plain) is plain  # CPU metrics: nothing to stage


def test_the_loop_never_synchronizes_the_device():
    for mod in ("telemetry.py", os.path.join("train", "trainer.py")):
        with open(os.path.join(REPO_ROOT, "xflow_tpu_torch", mod)) as f:
            assert "cuda.synchronize" not in f.read(), mod


def test_trace_window_writes_a_torch_profiler_trace(small_shard, tmp_path):
    cfg = override(Config(), **_pairs(**{
        "data.train_path": str(small_shard / "train"), "train.epochs": 1,
        "train.log_every": 0, "train.profile_dir": str(tmp_path / "prof"),
        "train.trace_start_step": 2, "train.trace_num_steps": 2}))
    assert Trainer(cfg, device="cpu").fit().steps == 6
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_profiler_off_writes_no_pipeline_record(small_shard, tmp_path):
    ttel.default_registry().reset()
    cfg = override(Config(), **_pairs(**{
        "data.train_path": str(small_shard / "train"), "train.epochs": 1,
        "train.log_every": 2, "train.metrics_path": str(tmp_path / "m.jsonl")}))
    with contextlib.redirect_stderr(io.StringIO()):
        Trainer(cfg, device="cpu").fit()
    recs = _read(tmp_path / "m.jsonl")
    assert [r["step"] for r in recs if "loss" in r] == [2, 4, 6]
    assert all(r.get("kind") != "pipeline" for r in recs)
    assert not any(k.startswith("pipeline.") for r in recs for k in r.get("counters", {}))
    assert not any(k in r for r in recs for k in ("grad_norm", "loss_ema", "hbm_bytes_in_use"))


def test_profiled_stream_is_the_unprofiled_one(small_shard):
    cfg = override(Config(), **_pairs()).data
    path = str(small_shard / "train-00000")
    prof = ttel.PipelineProfiler(registry=ttel.Registry())
    plain = list(pipeline.batch_iterator(path, cfg))
    got = list(pipeline.prefetch(pipeline.batch_iterator(path, cfg, profiler=prof),
                                 profiler=prof))
    assert len(got) == len(plain) == 6
    for a, b in zip(got, plain):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    rec = prof.window_record()
    assert rec["batches"] == 6 and rec["rows"] == 6 * B and rec["parse_s"] > 0
    assert rec["queue_cap"] == 2


def test_a_stage_across_a_window_boundary_is_split_between_the_windows():
    prof = ttel.PipelineProfiler(registry=ttel.Registry())
    prof.start()
    prof.count_batch(B)
    with prof.stage("producer_wait"):  # a put blocked across a record
        time.sleep(0.03)
        first = prof.window_record()
        time.sleep(0.01)
    with prof.stage("plan"):
        time.sleep(0.002)
    second = prof.window_record()
    assert 0.03 <= first["producer_wait_s"] <= first["wall_s"]
    assert 0.01 <= second["producer_wait_s"]
    assert second["producer_wait_s"] + second["plan_s"] <= second["wall_s"]
    blocked = prof._reg.snapshot()["pipeline.producer_blocked_s"]
    assert blocked == pytest.approx(first["producer_wait_s"] + second["producer_wait_s"],
                                    abs=1e-5)


def test_cache_counters_count_as_jax(small_shard, tmp_path):
    shutil.copy(small_shard / "train-00000", tmp_path / "c-00000")
    path = str(tmp_path / "c-00000")
    tcfg = override(Config(), **_pairs(**{"data.cache": "on"})).data
    jcfg = joverride(JConfig(), **_pairs(**{"data.cache": "on"})).data
    tsc.build_cache(str(tmp_path / "c"), tcfg)
    counts = []
    for flip in (False, True):
        if flip:
            with open(tsc.cache_path_for(path), "r+b") as f:
                f.seek(100)
                b = f.read(1)
                f.seek(100)
                f.write(bytes([b[0] ^ 0x01]))
        for tel, run in ((ttel, lambda: list(pipeline.batch_iterator(path, tcfg))),
                         (jtel, lambda: list(jbatch_iterator(path, jcfg)))):
            tel.default_registry().reset()
            with contextlib.redirect_stderr(io.StringIO()):
                run()
            snap = tel.default_registry().snapshot()
            counts.append((snap.get("data.cache_shards", 0), snap.get("data.cache_fallbacks", 0)))
    assert counts == [(1, 0), (1, 0), (0, 1), (0, 1)]
