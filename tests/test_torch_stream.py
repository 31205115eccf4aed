"""PyTorch port, the online training loop held against the JAX package:

- `TailFollower` over the same appends as JAX's follower seals the same
  segments (spool bytes, rows, offsets, seq, ingest record keys) across
  a truncated trailing row that is deferred, a rotation that restarts
  from the top, conversion on arrival (the `.xfc` bytes equal JAX's)
  and the idle end (an injected clock: no wait on the wall clock);
- a tail fit of fused FM on a pre-seeded shard, the port against the
  JAX trainer from the same initial state: the same step count, losses
  within 1e-5 relative and wv / n / z within the FTRL tolerance of
  `test_torch_train.py`, publications at the same steps with the same
  seq, each sidecar committed, and the port's `ServeRunner` reading the
  newest publication and its freshness;
- SIGTERM during a tail `train` (a subprocess, async saves, a replica)
  commits the step reached and exits 0 with `interrupted`, without
  waiting out `stream_idle_s`; a resumed `train` restores that step;
- `data.stream` "bogus" raises as in JAX, and `stream=off` writes no
  ingest or publish record and no publication sidecar.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.pipeline import TailFollower as JTailFollower
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.pipeline import TailFollower, stream_dir_for
from xflow_tpu_torch.serve.runner import ServeRunner
from xflow_tpu_torch.telemetry import default_registry
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = "1\t0:3:1.0 1:7:1.0 2:9:1.0 3:2:1.0 4:5:1.0 5:8:1.0\n"
LINE0 = "0\t0:4:1.0 1:6:1.0 2:1:1.0 3:3:1.0 4:2:1.0 5:9:1.0\n"
LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
ROWS = 200  # three full batches and a padded one
LOSS_RTOL = 1e-5
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4
WAIT_S = 120.0  # the bound of every wait on a subprocess


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


class _App:
    """An appender that keeps what the follower records."""

    def __init__(self):
        self.recs = []

    def append(self, rec):
        self.recs.append(dict(rec))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.05  # every read moves the clock on
        return self.t


def _data_pairs(spool, **extra):
    return {"data.cache": "off", "data.stream": "tail", "data.stream_poll_s": 0.01,
            "data.stream_idle_s": 0.2, "data.stream_dir": str(spool),
            "model.num_fields": 6, "data.max_nnz": 8, **extra}


def _followers(tmp_path, src, **extra):
    t = TailFollower(str(src), override(Config(), **_data_pairs(tmp_path / "t", **extra)).data,
                     appender=_App(), clock=_Clock())
    j = JTailFollower(str(src), joverride(JConfig(), **_data_pairs(tmp_path / "j", **extra)).data,
                      appender=_App(), clock=_Clock())
    return t, j


def _same_segments(tsegs, jsegs):
    assert len(tsegs) == len(jsegs)
    for a, b in zip(tsegs, jsegs):
        assert (a.seq, a.source, a.offset, a.rows, a.bytes) == (
            b.seq, b.source, b.offset, b.rows, b.bytes)
        assert os.path.basename(a.path) == os.path.basename(b.path)
        assert open(a.path, "rb").read() == open(b.path, "rb").read()
        assert bool(a.cache) == bool(b.cache)
        if a.cache:
            assert os.path.basename(a.cache) == os.path.basename(b.cache)
            assert open(a.cache, "rb").read() == open(b.cache, "rb").read()


def _poll_both(t, j):
    tsegs, jsegs = t.poll(), j.poll()
    _same_segments(tsegs, jsegs)
    return tsegs


def test_tail_follower_seals_what_jax_seals(tmp_path):
    src = tmp_path / "shard"
    src.write_text(LINE + LINE0[:-9])  # the second row is still being written
    t, j = _followers(tmp_path, src)
    segs = _poll_both(t, j)
    assert len(segs) == 1 and (segs[0].offset, segs[0].rows, segs[0].bytes) == (0, 1, len(LINE))
    assert _poll_both(t, j) == []  # the torn row is deferred, not quarantined
    with open(src, "a") as f:
        f.write(LINE0[-9:] + LINE * 2)  # the writer finishes the row and adds two
    segs = _poll_both(t, j)
    assert (segs[0].seq, segs[0].offset, segs[0].rows) == (1, len(LINE), 3)
    assert open(segs[0].path).read() == LINE0 + LINE * 2
    src.write_text(LINE0)  # rotated: shorter than the offset
    segs = _poll_both(t, j)
    assert (segs[0].offset, segs[0].rows) == (0, 1)
    with open(src, "a") as f:
        f.write("\n\n")  # blank lines: the offset moves, no segment
    assert _poll_both(t, j) == []
    assert [r["kind"] for r in t._app.recs] == ["ingest"] * 3
    keys = lambda recs: [sorted(r) for r in recs]  # noqa: E731
    assert keys(t._app.recs) == keys(j._app.recs)
    assert len({r["trace"] for r in t._app.recs}) == 3  # one trace a segment
    # the idle end: no new rows for stream_idle_s, read off the injected clock
    with open(src, "a") as f:
        f.write(LINE)
    tail = list(t.segments())
    jtail = list(j.segments())
    _same_segments(tail, jtail)
    assert [s.rows for s in tail] == [1]


def test_tail_follower_converts_on_arrival_as_jax(tmp_path):
    src = tmp_path / "shard"
    src.write_text((LINE + LINE0) * 40)
    reg = default_registry()
    before = (reg.counter("data.ingest_segments").value, reg.counter("data.ingest_rows").value)
    t, j = _followers(tmp_path, src, **{"data.cache": "on"})
    (seg,) = _poll_both(t, j)
    assert seg.cache == seg.path + ".xfc" and os.path.exists(seg.cache)
    assert t._app.recs[0]["cache"] == seg.cache
    assert (reg.counter("data.ingest_segments").value,
            reg.counter("data.ingest_rows").value) == (before[0] + 1, before[1] + 80)
    cfg = override(Config(), **_data_pairs(tmp_path, **{"data.stream_dir": ""})).data
    assert stream_dir_for(str(tmp_path / "sub" / "train"), cfg) == str(
        tmp_path / "sub" / ".xfstream")


def test_follower_stop_predicate_ends_the_wait(tmp_path):
    src = tmp_path / "shard"
    src.write_text(LINE)
    cfg = override(Config(), **_data_pairs(tmp_path / "s", **{"data.stream_idle_s": 0})).data
    f = TailFollower(str(src), cfg)
    flag = {}
    segs = []
    for seg in f.segments(lambda: "sig" in flag):  # idle 0 follows forever
        segs.append(seg)
        flag["sig"] = signal.SIGTERM
    assert len(segs) == 1


# ------------------------------------------------- the tail fit, vs JAX
def _fm_pairs(**extra):
    return {"model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
            "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ, **extra}


def _recording(step, losses):
    def wrapped(state, batch):
        new, m = step(state, batch)
        losses.append(float(m["loss"]))
        return new, m

    return wrapped


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / (np.abs(want) + FTRL_FLOOR)) <= FTRL_RTOL


def _recs(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


@pytest.fixture(scope="module")
def tail_case(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_tail")
    jgenerate_shards(str(work / "stream"), 1, ROWS, num_fields=NF, ids_per_field=40, seed=5)
    common = _fm_pairs(**{
        "data.train_path": str(work / "stream"), "data.stream": "tail",
        "data.stream_poll_s": 0.02, "data.stream_idle_s": 0.5, "data.cache": "on",
        "train.publish_every": 2})
    side = {s: {"data.stream_dir": str(work / f"spool_{s}"),
                "train.checkpoint_dir": str(work / f"ck_{s}"),
                "train.metrics_path": str(work / f"m_{s}.jsonl")} for s in "tj"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_NATIVE_PLAN", None)
        mp.setenv("XFLOW_NO_NATIVE_PLAN", "1")
        jt = JTrainer(joverride(JConfig(), **common, **side["j"], **{
            "train.pred_dump": False, "data.use_native_parser": False}))
        jt.save_checkpoint()  # the shared initial state, step 0
        shutil.copytree(work / "ck_j" / "step_0", work / "ck_t" / "step_0")
        tcfg = override(Config(), **common, **side["t"])
        tt = Trainer(tcfg, device="cpu")
        assert tt.maybe_restore() and tt.state.step == 0
        jlosses, tlosses = [], []
        jt.train_step = _recording(jt.train_step, jlosses)
        tt.train_step = _recording(tt.train_step, tlosses)
        jres, tres = jt.fit(), tt.fit()
    return {"work": work, "jt": jt, "tt": tt, "jres": jres, "tres": tres, "tcfg": tcfg,
            "jlosses": jlosses, "tlosses": tlosses}


def test_tail_fit_steps_and_losses_match_jax(tail_case):
    tres, jres = tail_case["tres"], tail_case["jres"]
    assert (tres.steps, tres.examples, tres.epochs) == (jres.steps, jres.examples, 1) == (
        4, ROWS, 1)
    assert tres.interrupted == jres.interrupted == 0
    np.testing.assert_allclose(tail_case["tlosses"], tail_case["jlosses"], rtol=LOSS_RTOL)
    ts, js = tail_case["tt"].state, tail_case["jt"].state
    S = 1 << LOG2_S
    _close(ts.tables["wv"].numpy(), np.asarray(js.tables["wv"]).reshape(S, -1))
    for leaf in ("n", "z"):
        _close(ts.opt_state["wv"][leaf].numpy(), np.asarray(js.opt_state["wv"][leaf]).reshape(S, -1))


def test_tail_fit_publishes_where_jax_publishes(tail_case):
    work = tail_case["work"]
    tpub, jpub = _recs(work / "m_t.jsonl", "publish"), _recs(work / "m_j.jsonl", "publish")
    assert [(p["step"], p["seq"]) for p in tpub] == [(p["step"], p["seq"]) for p in jpub] == [
        (2, 1), (4, 2), (4, 3)]
    assert [sorted(p) for p in tpub] == [sorted(p) for p in jpub]
    tin, jin = _recs(work / "m_t.jsonl", "ingest"), _recs(work / "m_j.jsonl", "ingest")
    assert [(r["rows"], r["bytes"]) for r in tin] == [(r["rows"], r["bytes"]) for r in jin]
    assert {p["trace"] for p in tpub} <= {r["trace"] for r in tin}
    spans = [r for r in _recs(work / "m_t.jsonl", "span") if r["name"] == "publish"]
    assert [(s["trace"], s["step"], s["seq"]) for s in spans] == [
        (p["trace"], p["step"], p["seq"]) for p in tpub]
    ck = str(work / "ck_t")
    for p in tpub:
        assert p["step"] in tckpt.committed_steps(ck)
    pub = tckpt.read_publication(ck, 4)
    assert pub["seq"] == 3 and pub["published_ts"] >= pub["consumed_ts"] >= pub["ingest_ts"]
    assert jckpt.read_publication(ck, 4) == pub  # JAX's reader reads the port's sidecar
    gen = ServeRunner(tail_case["tcfg"], device="cpu").load()
    assert gen.step == 4 and gen.publication == pub
    assert gen.freshness_s() is not None and gen.freshness_s() >= 0.0
    ds = tckpt.read_data_state(ck, 4)
    jds = jckpt.read_data_state(str(work / "ck_j"), 4)
    skip = ("quarantined_rows",)
    assert {k: v for k, v in ds.items() if k not in skip} == {
        k: v for k, v in jds.items() if k not in skip}


# ------------------------------------------------------ SIGTERM, stream off
def _train_argv(prefix, ck, *sets):
    argv = [sys.executable, "-m", "xflow_tpu_torch", "train", "--train", prefix,
            "--model", "fm", "--batch-size", str(B), "--log2-slots", str(LOG2_S),
            "--checkpoint-dir", ck, "--device", "cpu",
            "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
            "--set", f"data.max_nnz={NNZ}", "--set", "data.stream=tail",
            "--set", "data.stream_poll_s=0.05"]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_sigterm_during_a_tail_train_commits_and_exits_0(tmp_path):
    jgenerate_shards(str(tmp_path / "stream"), 1, 2 * B, num_fields=NF, ids_per_field=40,
                     seed=6)
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    proc = subprocess.Popen(
        _train_argv(str(tmp_path / "stream"), ck, "data.stream_idle_s=600",
                    "train.publish_every=1", "train.ckpt_async=true",
                    f"train.ckpt_replica_dir={tmp_path / 'rep'}",
                    f"train.metrics_path={metrics}"),
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            # step 2 (the shard's last) published or its save skipped as busy
            if os.path.exists(metrics) and any(r["step"] == 2 for r in _recs(metrics, "ckpt")):
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        # the follower waits for rows that never come (idle 600 s): the
        # signal ends the wait
        out, err = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    assert proc.returncode == 0, err
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["interrupted"] == signal.SIGTERM and summary["steps"] == 2
    assert "auc" not in summary
    (rec,) = [r for r in map(json.loads, open(metrics)) if "interrupted" in r]
    assert rec["interrupted"] == signal.SIGTERM and rec["step"] == 2
    assert tckpt.committed_steps(ck)[0] == 2
    assert tckpt.committed_steps(str(tmp_path / "rep"))[0] == 2
    r = subprocess.run(_train_argv(str(tmp_path / "stream"), ck, "data.stream_idle_s=0.3"),
                       cwd=REPO_ROOT, capture_output=True, text=True, timeout=WAIT_S)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 2" in r.stderr


def test_bogus_stream_raises_as_jax(tmp_path):
    (path,) = jgenerate_shards(str(tmp_path / "train"), 1, 64, num_fields=NF,
                               ids_per_field=40, seed=0)
    pairs = _fm_pairs(**{"data.train_path": str(tmp_path / "train"), "data.stream": "bogus"})
    with pytest.raises(ValueError, match="data.stream"):
        Trainer(override(Config(), **pairs), device="cpu").fit()
    with pytest.raises(ValueError, match="data.stream"):
        JTrainer(joverride(JConfig(), **pairs)).fit()


def test_stream_off_writes_no_ingest_or_publish_record(tmp_path):
    jgenerate_shards(str(tmp_path / "train"), 1, 4 * B, num_fields=NF, ids_per_field=40,
                     seed=0)
    metrics = tmp_path / "m.jsonl"
    t = Trainer(override(Config(), **_fm_pairs(**{
        "data.train_path": str(tmp_path / "train"), "train.epochs": 1,
        "train.publish_every": 2, "train.checkpoint_dir": str(tmp_path / "ck"),
        "train.metrics_path": str(metrics)})), device="cpu")
    assert t.fit().steps == 4
    recs = [json.loads(line) for line in open(metrics)]
    # the run's one record without a kind is its final record (log_every
    # 100 stages no window over 4 steps)
    assert {r.get("kind") for r in recs} == {"span", None}
    assert [r["final"] for r in recs if "kind" not in r] == [True]
    assert {r["name"] for r in recs if "kind" in r} == {"checkpoint_save"}
    assert tckpt.committed_steps(str(tmp_path / "ck")) == [4]
    assert tckpt.read_publication(str(tmp_path / "ck"), 4) is None
