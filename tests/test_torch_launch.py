"""PyTorch port, the launch layer on the CPU against the JAX package:
`launch-local` worlds of 2 gloo ranks (LR, and FM on the fully-sharded
engine) against one process on the composed data, ragged and missing
shards, the supervised restart after `XFLOW_FAULT_KILL_STEP`,
`launch-dist` through a fake ssh at two "hosts" and its `--dry-run`
contract, ranks that die with the launcher, the coordinated preemption
(a SIGTERM to rank 1 alone stops both ranks at one step), the watchdog's
fold, classify and on_dead policy and the supervision helpers to the
JAX package's on the same inputs, and the record stamp of a rank started
with `--process-id` flags, to the JAX CLI's on the same shards.
"""

import json
import os
import random
import signal
import socket
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import xflow_tpu.launch.supervise as jsup
import xflow_tpu.launch.watchdog as jwd
import xflow_tpu.testing.faults as jfaults
import xflow_tpu_torch.launch.supervise as tsup
import xflow_tpu_torch.launch.watchdog as twd
import xflow_tpu_torch.testing.faults as tfaults
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train import checkpoint as tckpt

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
LR_ARGS = ["--model", "lr", "--epochs", "2", "--log2-slots", "10", "--device", "cpu",
           "--set", "model.num_fields=4", "--set", "data.max_nnz=8",
           "--set", "train.pred_dump=false"]


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    for k in list(env):
        if k.startswith("XFLOW_") and k != "XFLOW_NUM_CPU_DEVICES":
            env.pop(k)
    env.pop("XFLOW_NUM_CPU_DEVICES", None)
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    env.update(extra or {})
    return env


def port_cli(args, cwd, extra_env=None, timeout=240):
    return subprocess.run([sys.executable, "-m", "xflow_tpu_torch", *args], cwd=cwd,
                          env=_env(extra_env), capture_output=True, text=True, timeout=timeout)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _summaries(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.strip().splitlines() if ln.startswith("{")]


def _interleave_shards(paths, block_rows, out_path):
    """The one-process analog of a 2-rank stream: step i's batch is
    [rank 0's rows | rank 1's rows]."""
    shard_lines = [open(p).read().splitlines() for p in paths]
    n_blocks = max(len(ls) for ls in shard_lines) // block_rows
    out = []
    for b in range(n_blocks):
        for lines in shard_lines:
            out.extend(lines[b * block_rows:(b + 1) * block_rows])
    with open(out_path, "w") as f:
        f.write("\n".join(out) + "\n")


def _fake_ssh(tmp_path) -> str:
    """An ssh-shaped shim that runs the remote command here."""
    path = tmp_path / "fakessh"
    path.write_text('#!/bin/bash\nshift\nexec bash -c "$1"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _one_process(tmp_path, name, extra_args, steps):
    """A one-process port run on the composed train shards."""
    _interleave_shards([tmp_path / "train-00000", tmp_path / "train-00001"], B,
                       tmp_path / "comb-00000")
    r = port_cli(["train", "--train", str(tmp_path / "comb"), "--batch-size", str(2 * B),
                  "--checkpoint-dir", str(tmp_path / name), *extra_args], tmp_path)
    assert r.returncode == 0, r.stderr
    assert _summaries(r.stdout)[-1]["steps"] == steps
    return np.load(tmp_path / name / f"step_{steps}" / "state.npz")


# --------------------------------------------------------- launch-local
FM_ARGS = ["--model", "fm", "--epochs", "2", "--log2-slots", "12", "--device", "cpu",
           "--set", "model.v_dim=4", "--set", "model.num_fields=4", "--set", "data.max_nnz=8",
           "--set", "train.pred_dump=false", "--set", "optim.fused_scatter=off"]


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_launch_local_two_process_matches_single_process(tmp_path, model):
    """2 gloo ranks of `launch-local --device cpu` (LR: the row-major
    sharded step; FM: the fully-sharded engine) against one process on
    the batch-composed data, after `tests/test_launch_local.py`."""
    rows = 96  # 3 batches a rank an epoch
    generate_shards(str(tmp_path / "train"), 2, rows, num_fields=4, ids_per_field=50)
    args = LR_ARGS if model == "lr" else FM_ARGS
    r2 = port_cli(["launch-local", "--num-processes", "2", "--run-dir", str(tmp_path / "run"),
                   "--", "--train", str(tmp_path / "train"), "--batch-size", str(B),
                   "--checkpoint-dir", str(tmp_path / "ck2"), "--set", "train.log_every=1",
                   *args], tmp_path)
    assert r2.returncode == 0, r2.stderr
    (s2,) = _summaries(r2.stdout)  # rank 0's alone
    assert (s2["rank"], s2["world"], s2["steps"], s2["examples"]) == (0, 2, 6, 4 * rows)
    run_ids = set()
    for rank in (0, 1):
        recs = [json.loads(ln) for ln in open(tmp_path / "run" / f"metrics_rank{rank}.jsonl")]
        assert recs and all((r["rank"], r["world"]) == (rank, 2) for r in recs)
        run_ids |= {r["run_id"] for r in recs}
    assert len(run_ids) == 1
    d1 = _one_process(tmp_path, "ck1", args, 6)
    d2 = np.load(tmp_path / "ck2" / "step_6" / "state.npz")
    assert sorted(d1.files) == sorted(d2.files)
    for k in d1.files:
        np.testing.assert_allclose(d2[k], d1[k], rtol=0, atol=1e-5 if model == "fm" else 1e-6,
                                   err_msg=k)


def test_launch_local_ragged_and_missing_shards(tmp_path):
    generate_shards(str(tmp_path / "train"), 1, 3 * B, num_fields=4, ids_per_field=50)
    generate_shards(str(tmp_path / "short"), 1, B, num_fields=4, ids_per_field=50, seed=3)
    os.rename(tmp_path / "short-00000", tmp_path / "train-00001")
    argv = ["launch-local", "--num-processes", "2", "--", "--train", str(tmp_path / "train"),
            "--batch-size", str(B), *LR_ARGS, "--epochs", "1"]
    r = port_cli(argv, tmp_path)
    assert r.returncode == 0, r.stderr
    assert _summaries(r.stdout)[-1]["steps"] == 3  # rank 0's 3 batches drive the epoch
    assert _summaries(r.stdout)[-1]["examples"] == 4 * B
    os.remove(tmp_path / "train-00001")
    r = port_cli(argv, tmp_path)
    assert r.returncode == 0, r.stderr
    assert _summaries(r.stdout)[-1]["steps"] == 3


def test_launch_local_supervised_auto_restart(tmp_path):
    """Rank 1 SIGKILLs itself once step 4 committed; the launcher tears
    the world down, relaunches generation 1 with train.resume=true, and
    the run ends with every row trained once, both generations in the
    streams."""
    rows = 96
    generate_shards(str(tmp_path / "train"), 2, rows, num_fields=4, ids_per_field=50)
    run_dir = tmp_path / "run"
    r = port_cli(["launch-local", "--num-processes", "2", "--max-restarts", "1",
                  "--restart-backoff", "0.2", "--run-dir", str(run_dir), "--",
                  "--train", str(tmp_path / "train"), "--batch-size", str(B),
                  "--checkpoint-dir", str(tmp_path / "ckpt"),
                  "--set", "train.checkpoint_every=2", "--set", "train.heartbeat_every=1",
                  "--set", "train.log_every=1", *LR_ARGS], tmp_path,
                 extra_env={"XFLOW_FAULT_KILL_STEP": "4", "XFLOW_FAULT_KILL_RANK": "1"})
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "hard-killing rank 1 at step 4" in r.stderr
    assert "restarting generation 1" in r.stderr
    assert "resumed from step 4" in r.stderr
    assert "resuming data stream at epoch 1, shard offsets [1, 1]" in r.stderr
    assert "succeeded after 1 restart(s)" in r.stderr
    assert _summaries(r.stdout)[-1]["steps"] == 2  # steps 5 and 6
    ck = str(tmp_path / "ckpt")
    assert tckpt.latest_step(ck) == 6
    ds = tckpt.read_data_state(ck, 6)
    assert ds["completed"] and ds["examples"] == 4 * rows
    assert ds["examples_per_rank"] == [2 * B, 2 * B]
    assert (ds["world_size"], ds["num_shards"]) == (2, 2)
    for rank in (0, 1):
        for stream in ("metrics", "heartbeat"):
            recs = [json.loads(ln) for ln in open(run_dir / f"{stream}_rank{rank}.jsonl")
                    if ln.strip().endswith("}")]
            assert {x["gen"] for x in recs} == {0, 1}, (stream, rank)
            assert len({x["run_id"] for x in recs}) == 1
    # the same rows as an uninterrupted world
    r = port_cli(["launch-local", "--num-processes", "2", "--", "--train",
                  str(tmp_path / "train"), "--batch-size", str(B), "--checkpoint-dir",
                  str(tmp_path / "whole"), *LR_ARGS], tmp_path)
    assert r.returncode == 0, r.stderr
    a = np.load(tmp_path / "ckpt" / "step_6" / "state.npz")
    b = np.load(tmp_path / "whole" / "step_6" / "state.npz")
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------- launch-dist
def test_dry_run_prints_env_contract(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("# comment\nnode-a\nuser@node-b\n\n")
    r = port_cli(["launch-dist", "--hosts", str(hosts), "--port", "12345", "--workdir",
                  "/w/{rank}", "--env", "FOO=bar r", "--dry-run", "--", "--train",
                  "/data/t x", "--model", "fm"], tmp_path)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "# rank 0 on node-a:" in out and "# rank 1 on user@node-b:" in out
    assert out.count("XFLOW_COORDINATOR=node-a:12345") == 2
    assert "XFLOW_NUM_PROCESSES=2" in out
    assert "XFLOW_PROCESS_ID=0" in out and "XFLOW_PROCESS_ID=1" in out
    assert "XFLOW_ORIG_WORLD=2" in out and "XFLOW_RUN_ID=" in out
    assert "/w/0" in out and "/w/1" in out
    assert "FOO=" in out and "bar r" in out and "/data/t x" in out
    assert "ssh node-a" in out and "ssh user@node-b" in out
    assert out.count("-m xflow_tpu_torch train") == 2 and "JAX_PLATFORMS" not in out


def test_rank_command_matches_jax_less_the_module():
    from xflow_tpu.launch.dist import rank_command as jrank
    from xflow_tpu_torch.launch.dist import rank_command as trank

    args = ("u@h1", 1, ["h0", "u@h1"], ["--train", "/d/t x", "--model", "fm"], 29431,
            "/w/{rank}/{host}", "py3", {"A": "b c"})
    want = jrank(*args, run_dir="/r").replace("-m xflow_tpu train", "-m xflow_tpu_torch train")
    assert trank(*args, run_dir="/r") == want


def test_launch_dist_two_hosts_bitmatch(tmp_path):
    """Two "hosts" through a fake ssh, separate workdirs, the XFLOW_*
    contract: the tables bit-match `launch-local`'s world of 2."""
    rows = 96
    generate_shards(str(tmp_path / "train"), 2, rows, num_fields=4, ids_per_field=50)
    hosts = tmp_path / "hosts"
    hosts.write_text("127.0.0.1\n127.0.0.1\n")
    r2 = port_cli(["launch-dist", "--hosts", str(hosts), "--port", str(_free_port()),
                   "--ssh-cmd", _fake_ssh(tmp_path), "--workdir", str(tmp_path / "rank{rank}"),
                   "--python", sys.executable, "--env", "PYTHONPATH=" + REPO_ROOT, "--",
                   "--train", str(tmp_path / "train"), "--batch-size", str(B),
                   "--checkpoint-dir", "ckpt", *LR_ARGS], tmp_path)
    assert r2.returncode == 0, (r2.stdout, r2.stderr)
    (s2,) = _summaries(r2.stdout)
    assert s2["steps"] == 6 and (tmp_path / "rank1").is_dir()
    d2 = np.load(tmp_path / "rank0" / "ckpt" / "step_6" / "state.npz")
    d1 = _one_process(tmp_path, "ck1", LR_ARGS, 6)
    for k in d1.files:
        np.testing.assert_allclose(d2[k], d1[k], rtol=0, atol=1e-6, err_msg=k)


def _pids_with_env(key: bytes) -> list:
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if key in f.read():
                    out.append(int(pid))
        except OSError:
            continue
    return out


def test_launch_dist_ranks_die_with_launcher(tmp_path):
    """SIGKILL the launcher: the held ssh stdin closes, each remote
    watcher TERMs its rank, and no rank outlives it."""
    generate_shards(str(tmp_path / "train"), 2, 4000, num_fields=4, ids_per_field=50)
    hosts = tmp_path / "hosts"
    hosts.write_text("127.0.0.1\n127.0.0.1\n")
    marker = f"XFLOW_DIEWITH_{os.getpid()}"
    p = subprocess.Popen(
        [sys.executable, "-m", "xflow_tpu_torch", "launch-dist", "--hosts", str(hosts),
         "--port", str(_free_port()), "--ssh-cmd", _fake_ssh(tmp_path),
         "--workdir", str(tmp_path / "rank{rank}"), "--python", sys.executable,
         "--env", "PYTHONPATH=" + REPO_ROOT, "--env", marker + "=1", "--",
         "--train", str(tmp_path / "train"), "--batch-size", "20", *LR_ARGS,
         "--epochs", "100000"],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        ranks = []
        deadline = time.time() + 120
        while time.time() < deadline:
            ranks = [x for x in _pids_with_env(marker.encode()) if x != p.pid]
            if len(ranks) >= 2:
                break
            assert p.poll() is None, "launcher died before the ranks started"
            time.sleep(0.3)
        assert len(ranks) >= 2, f"ranks never started: {ranks}"
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        alive = ranks
        deadline = time.time() + 30
        while time.time() < deadline:
            alive = [x for x in _pids_with_env(marker.encode()) if x != p.pid]
            if not alive:
                break
            time.sleep(0.5)
        assert not alive, f"rank pids outlived the launcher: {alive}"
    finally:
        for pid in _pids_with_env(marker.encode()):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


# ------------------------------------------------ the coordinated signal
def _children_by_rank(parent_pid: int) -> dict:
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != parent_pid:
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
            rank = env.get(b"XFLOW_PROCESS_ID")
            if rank is not None:
                out[int(rank)] = int(pid)
        except (OSError, ValueError, IndexError):
            continue
    return out


def test_coordinated_preemption_two_process(tmp_path):
    """A SIGTERM to rank 1 alone: the all_reduce(MAX) every
    train.signal_sync_every steps stops both ranks at one step, the save
    is collective, and rank 0's summary reports the adopted signal."""
    generate_shards(str(tmp_path / "train"), 2, 2000, num_fields=4, ids_per_field=50)
    run = tmp_path / "run"
    p = subprocess.Popen(
        [sys.executable, "-m", "xflow_tpu_torch", "launch-local", "--num-processes", "2",
         "--run-dir", str(run), "--", "--train", str(tmp_path / "train"), *LR_ARGS,
         "--epochs", "100000", "--batch-size", "20", "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--set", "train.log_every=1", "--set", "train.signal_sync_every=2"],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        metrics = run / "metrics_rank1.jsonl"
        deadline = time.time() + 120
        while time.time() < deadline and not (metrics.exists() and metrics.stat().st_size):
            assert p.poll() is None, p.communicate()
            time.sleep(0.1)
        kids = _children_by_rank(p.pid)
        assert 1 in kids, f"children found: {kids}"
        os.kill(kids[1], signal.SIGTERM)  # not rank 0: the agreement spreads it
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, (out, err)
    (summary,) = _summaries(out)
    assert summary["interrupted"] == int(signal.SIGTERM) and summary["steps"] > 0
    stops = []
    for rank in (0, 1):
        recs = [json.loads(ln) for ln in open(run / f"metrics_rank{rank}.jsonl")]
        (stop,) = [r for r in recs if "interrupted" in r]
        assert stop["interrupted"] == int(signal.SIGTERM)
        stops.append(stop["step"])
    assert stops[0] == stops[1] == summary["steps"]
    assert stops[0] % 2 == 0  # at the cadence
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == stops[0]


def test_signal_handler_rules():
    """A world with signal_sync_every=0 installs no handler (every rank
    skips the agreement); off the main thread a mesh rank installs none
    but still takes part (an empty flag)."""
    from types import SimpleNamespace

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.train.trainer import Trainer

    t = Trainer.__new__(Trainer)
    t.cfg = override(Config(), **{"train.checkpoint_dir": "/nonexistent",
                                  "train.signal_sync_every": 0})
    t.mesh = SimpleNamespace(size=2)
    assert t._install_signal_checkpoint()[0] is None
    t.mesh = None
    flag, restore = t._install_signal_checkpoint()
    restore()
    assert flag == {}
    t.cfg = override(t.cfg, **{"train.signal_sync_every": 2})
    t.mesh = SimpleNamespace(size=2)
    got = []
    th = threading.Thread(target=lambda: got.append(t._install_signal_checkpoint()[0]))
    th.start()
    th.join()
    assert got == [{}]


# ------------------------------------------------------ the watchdog
def _beat(rank, ts, step=None, event=None, gen=0, run_id="r"):
    rec = {"ts": ts, "rank": rank, "run_id": run_id, "kind": "heartbeat", "gen": gen}
    if step is not None:
        rec["step"] = step
    if event is not None:
        rec["event"] = event
    return rec


HEARTBEATS = {
    "healthy": [_beat(0, 10.0, 5), _beat(1, 10.5, 5)],
    "one_dead": [_beat(0, 100.0, 40), _beat(1, 10.0, 4)],
    "straggler": [_beat(0, 100.0, 40), _beat(1, 99.0, 8)],
    "finished_and_starting": [_beat(0, 10.0, 9, "final"), _beat(1, 99.0, 0, "start")],
    "interrupted": [_beat(0, 50.0, 9, "interrupted"), _beat(1, 1.0, 3)],
    "step_less_event": [_beat(0, 10.0, 7), _beat(0, 11.0, None, "checkpoint")],
    "stale_generation": [_beat(0, 900.0, 9, gen=0), _beat(0, 1000.0, 3, gen=1)],
    "other_run": [_beat(0, 1000.0, 3), _beat(1, 1000.0, 3, run_id="old")],
    "damaged_gen": [{"ts": 1.0, "rank": 0, "run_id": "r", "gen": "x", "step": 1},
                    {"ts": 2.0, "rank": 0, "run_id": "r", "gen": float("nan"), "step": 2},
                    {"ts": 3.0, "rank": 0, "run_id": "r", "gen": 1, "step": 3}],
    "malformed": [{"ts": "x", "rank": 0}, {"ts": 1.0, "rank": "0"}, _beat(1, 5.0, 2)],
}


@pytest.mark.parametrize("case", sorted(HEARTBEATS))
@pytest.mark.parametrize("filters", [(None, None), ("r", None), ("r", 1), (None, 0)])
def test_fold_and_classify_match_jax(case, filters):
    recs = HEARTBEATS[case]
    run_id, gen = filters
    got = twd.fold_heartbeats(recs, run_id=run_id, gen=gen)
    want = jwd.fold_heartbeats(recs, run_id=run_id, gen=gen)
    assert got == want
    for now in (50.0, 1005.0):
        for expect in (None, 3):
            assert (twd.classify(got, now, 2.0, 60.0, expect)
                    == jwd.classify(want, now, 2.0, 60.0, expect))


def _watchdog_run(mod, run_dir, on_dead_raises=False):
    fired = []

    def on_dead(row):
        if on_dead_raises:
            raise RuntimeError("policy bug")
        fired.append(row)

    wd = mod.RunWatchdog(str(run_dir), num_ranks=2, dead_after_s=10.0, run_id="r",
                         out=open(os.devnull, "w"), on_dead=on_dead, gen=1)
    try:
        rows = [wd.poll_once(now=t) for t in (1005.0, 1100.0, 1101.0)]
    finally:
        wd.stop()
    events = [json.loads(ln) for ln in open(run_dir / "watchdog.jsonl")]
    for e in events:
        e.pop("ts")
    return rows, fired, events, dict(wd.flagged)


@pytest.mark.parametrize("raises", [False, True])
def test_watchdog_on_dead_policy_matches_jax(tmp_path, raises):
    """The gen-1 watchdog ignores gen 0's stale beat, fires on_dead once
    a transition (a failing policy does not stop the scan), and stamps
    its events with the launcher's gen and world, as the JAX one."""
    out = {}
    for name, mod in (("jax", jwd), ("torch", twd)):
        d = tmp_path / name
        d.mkdir()
        with open(d / "heartbeat_rank0.jsonl", "w") as f:
            f.write(json.dumps(_beat(0, 900.0, 9, gen=0)) + "\n")
            f.write(json.dumps(_beat(0, 1000.0, 3, gen=1)) + "\n")
        with open(d / "heartbeat_rank1.jsonl", "w") as f:
            f.write(json.dumps(_beat(1, 1099.0, 12, gen=1)) + "\n")
            f.write('{"ts": 1099.5, "rank": 1, "trunc')  # a torn append
        out[name] = _watchdog_run(mod, d, raises)
    assert out["torch"] == out["jax"]
    rows, fired, events, _ = out["torch"]
    assert rows[0][0]["step"] == 3
    assert [r["rank"] for r in fired] == ([] if raises else [0])
    assert events and all((e["gen"], e["world"], e["rank"]) == (1, 2, -1) for e in events)


# ---------------------------------------------------- supervision helpers
def test_dead_host_tracker_matches_jax():
    def script(mod):
        t = mod.DeadHostTracker(allow_shrink=True)
        t.record("hostB")
        out = [t.shrunk_world(3), t.survivors(["a", "hostB", "c"])]
        rec = t.attempt_recorder(labels=["a", "c"])
        rec({"rank": 1, "status": "dead"})
        rec({"rank": 0, "status": "dead"})  # a victim: not recorded
        out += [sorted(t.lost), t.shrunk_world(3)]
        t.revive("c")
        local = t.attempt_recorder(gen=2)
        local({"rank": "x"})
        local({"rank": 1})
        out += [sorted(map(str, t.lost)), t.shrunk_world(3, floor=2)]
        off = mod.DeadHostTracker()
        off.record("x")
        out += [off.shrunk_world(3), off.survivors(["x", "y"])]
        return out

    assert script(tsup) == script(jsup)


class _FakeProc:
    def __init__(self, codes):
        self.codes = list(codes)
        self.rc = None
        self.terminated = False

    def poll(self):
        if self.rc is None and self.codes:
            self.rc = self.codes.pop(0)
        return self.rc

    def terminate(self):
        self.terminated = True
        self.rc = -15

    def kill(self):
        self.rc = -9


@pytest.mark.parametrize("script", ["clean", "one_fails", "verdict"])
def test_wait_fail_fast_matches_jax(script):
    import io

    plans = {"clean": [[None, 0], [None, None, 0]], "one_fails": [[None, 3], [None] * 50],
             "verdict": [[None] * 50, [None] * 50]}
    out = {}
    for name, mod in (("jax", jsup), ("torch", tsup)):
        procs = [_FakeProc(c) for c in plans[script]]
        verdict = threading.Event()
        if script == "verdict":
            verdict.set()
        torn = []
        rc = mod.wait_fail_fast(procs, lambda ps: (torn.append(1), [p.terminate() for p in ps
                                                                   if p.poll() is None]),
                                dead_verdict=verdict, poll_s=0.001, out=io.StringIO())
        out[name] = (rc, torn, [p.terminated for p in procs])
    assert out["torch"] == out["jax"]
    assert tsup.resume_forward_args(["--x"]) == jsup.resume_forward_args(["--x"])
    assert tsup.EX_TEMPFAIL == jsup.EX_TEMPFAIL == 75


def test_launch_local_shrinks_after_dead_host_verdict(monkeypatch):
    """Generation 0's first dead verdict shrinks generation 1 to the
    survivors under --allow-shrink (the victims' verdicts do not count);
    without it the relaunch keeps the shape."""
    from xflow_tpu_torch.launch import local as ll

    worlds = []

    def fake_once(n, args, on_dead_row=None, gen=0, orig_world=0, **kw):
        worlds.append((n, orig_world, args[-1]))
        if gen == 0:
            on_dead_row({"rank": 1, "status": "dead"})
            on_dead_row({"rank": 0, "status": "dead"})
            return 75
        return 0

    monkeypatch.setattr(ll, "_launch_local_once", fake_once)
    assert ll.launch_local(2, ["--", "--train", "x"], max_restarts=2, restart_backoff=0.0,
                           allow_shrink=True) == 0
    assert worlds == [(2, 2, "x"), (1, 2, "train.resume=true")]
    worlds.clear()
    assert ll.launch_local(2, ["--train", "x"], max_restarts=2, restart_backoff=0.0) == 0
    assert [w[0] for w in worlds] == [2, 2]


FAULT_ENVS = {
    "unset": {},
    "kill_all": {"XFLOW_FAULT_KILL_STEP": "7"},
    "kill_rank1": {"XFLOW_FAULT_KILL_STEP": "7", "XFLOW_FAULT_KILL_RANK": "1"},
    "kill_junk": {"XFLOW_FAULT_KILL_STEP": "x"},
    "kill_relaunch": {"XFLOW_FAULT_KILL_STEP": "7", "XFLOW_RESTART_GEN": "1"},
    "kill_gen1": {"XFLOW_FAULT_KILL_STEP": "7", "XFLOW_RESTART_GEN": "1",
                  "XFLOW_FAULT_KILL_GEN": "1"},
    "delays": {"XFLOW_FAULT_STEP_DELAY_S": "0.25", "XFLOW_FAULT_STALL_S": "2",
               "XFLOW_FAULT_STALL_STEP": "3"},
    "delays_rank1": {"XFLOW_FAULT_STEP_DELAY_S": "0.25", "XFLOW_FAULT_DELAY_RANK": "1"},
}


@pytest.mark.parametrize("case", sorted(FAULT_ENVS))
def test_fit_fault_injectors_match_jax(monkeypatch, case):
    for k in list(os.environ):
        if k.startswith("XFLOW_"):
            monkeypatch.delenv(k)
    for k, v in FAULT_ENVS[case].items():
        monkeypatch.setenv(k, v)
    for rank in (0, 1):
        assert tfaults.kill_step_from_env(rank) == jfaults.kill_step_from_env(rank)
        assert tfaults.fit_delays_from_env(rank) == jfaults.fit_delays_from_env(rank)


def test_abort_after_step_resumes_exactly(tmp_path):
    """`abort_after_step` crashes the fit after step 3; a resume from the
    step-2 checkpoint trains the rest, and the tables equal a run
    without the crash."""
    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.train.trainer import Trainer

    generate_shards(str(tmp_path / "t"), 1, 6 * B, num_fields=4, ids_per_field=50)
    pairs = {"data.train_path": str(tmp_path / "t"), "data.batch_size": B,
             "data.log2_slots": 10, "data.max_nnz": 8, "model.num_fields": 4,
             "train.epochs": 1, "train.pred_dump": False}
    whole = Trainer(override(Config(), **pairs), device="cpu")
    whole.fit()
    cfg = override(Config(), **pairs, **{"train.checkpoint_dir": str(tmp_path / "ck"),
                                         "train.checkpoint_every": 2})
    t = Trainer(cfg, device="cpu")
    tfaults.abort_after_step(t, 3)
    with pytest.raises(RuntimeError, match="injected abort after step 3"):
        t.fit()
    t = Trainer(cfg, device="cpu")
    assert t.maybe_restore() and t.state.step == 2
    res = t.fit()
    assert (res.steps, res.examples, t.state.step) == (4, 4 * B, 6)
    for n in whole.state.tables:
        np.testing.assert_array_equal(t.state.tables[n].numpy(), whole.state.tables[n].numpy())


# ----------------------------------------------------- the stamp repair
def test_flag_started_rank_stamps_rank_and_world_as_jax(tmp_path):
    """Two ranks started with --process-id flags and no XFLOW_PROCESS_ID,
    a feature-less row in rank 1's shard: rank 1's quarantine, heartbeat
    and metrics records carry rank 1 and world 2, as the JAX CLI's
    quarantine record does on the same shards."""
    rows = 2 * B
    generate_shards(str(tmp_path / "train"), 2, rows, num_fields=4, ids_per_field=50)
    with open(tmp_path / "train-00001", "a") as f:
        f.write("1\tgarbage\n")
    out = {}
    for pkg in ("xflow_tpu_torch", "xflow_tpu"):
        port = _free_port()
        procs = []
        for r in range(2):
            d = tmp_path / pkg / f"r{r}"
            argv = [sys.executable, "-m", pkg, "train", "--train", str(tmp_path / "train"),
                    "--model", "lr", "--epochs", "1", "--batch-size", str(B),
                    "--log2-slots", "10", "--set", "model.num_fields=4",
                    "--set", "data.max_nnz=8", "--set", "train.pred_dump=false",
                    "--set", f"data.quarantine_path={d}/quarantine.jsonl",
                    "--set", f"train.metrics_path={d}/metrics.jsonl",
                    "--set", f"train.heartbeat_path={d}/heartbeat.jsonl",
                    "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                    "--process-id", str(r)]
            if pkg == "xflow_tpu_torch":
                argv += ["--device", "cpu"]
            procs.append(subprocess.Popen(argv, cwd=tmp_path, env=_env(),
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, (pkg, err)
        out[pkg] = {s: [json.loads(ln) for ln in open(tmp_path / pkg / "r1" / f"{s}.jsonl")]
                    for s in ("quarantine", "metrics", "heartbeat")}
    (tq,), (jq,) = out["xflow_tpu_torch"]["quarantine"], out["xflow_tpu"]["quarantine"]
    stamp = ("rank", "world", "gen")
    assert [tq[k] for k in stamp] == [jq[k] for k in stamp] == [1, 2, 0]
    assert {k: v for k, v in tq.items() if k not in ("ts", "run_id")} == \
        {k: v for k, v in jq.items() if k not in ("ts", "run_id")}
    for s in ("metrics", "heartbeat"):
        assert out["xflow_tpu_torch"][s]
        for rec in out["xflow_tpu_torch"][s] + out["xflow_tpu"][s]:
            assert (rec["rank"], rec["world"]) == (1, 2), (s, rec)
