"""PyTorch port, the elastic resume on the CPU (gloo ranks): a checkpoint
written by a world of 2 resumes on one process, and one written by one
process resumes on a world of 2; each trains every remaining row once
(the per-shard positions, the examples, and the tables against a port
run that reads the same rows from the same checkpoint). A resumed shard
whose file is missing is warned in the JAX trainer's words, and
`launch-local --allow-shrink` relaunches a world whose rank wedged (the
watchdog's dead verdict) at the smaller world, stamped so, after
`tests/test_elastic.py` and `tests/test_topology.py`.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
ROWS = 4 * B  # 4 batches a shard
ARGS = ["--model", "lr", "--epochs", "1", "--batch-size", str(B), "--log2-slots", "10",
        "--device", "cpu", "--set", "model.num_fields=4", "--set", "data.max_nnz=8",
        "--set", "train.pred_dump=false", "--set", "train.checkpoint_every=2"]


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in list(env):
        if k.startswith("XFLOW_"):
            env.pop(k)
    env.update(extra or {})
    return env


def port_cli(args, cwd, extra_env=None):
    return subprocess.run([sys.executable, "-m", "xflow_tpu_torch", *args], cwd=cwd,
                          env=_env(extra_env), capture_output=True, text=True, timeout=240)


def _lines(path, lo, hi):
    return open(path).read().splitlines()[lo:hi]


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fresh_copy(src, dst):
    """The checkpoint dir without its data_state: a run from it reads its
    stream from the top."""
    shutil.copytree(src, dst)
    for d in os.listdir(dst):
        p = os.path.join(dst, d, tckpt.DATA_STATE_FILE)
        if os.path.exists(p):
            os.remove(p)


def _final(ck):
    step = tckpt.latest_step(str(ck))
    return step, np.load(os.path.join(ck, f"step_{step}", "state.npz")), \
        tckpt.read_data_state(str(ck), step)


@pytest.fixture
def shards(tmp_path):
    generate_shards(str(tmp_path / "train"), 2, ROWS, num_fields=4, ids_per_field=50)
    return tmp_path


def test_two_ranks_resume_on_one_process(shards):
    tmp = shards
    r = port_cli(["launch-local", "--num-processes", "2", "--", "--train", str(tmp / "train"),
                  "--checkpoint-dir", str(tmp / "ck"), *ARGS], tmp,
                 extra_env={"XFLOW_FAULT_KILL_STEP": "2"})
    assert r.returncode != 0 and "hard-killing rank" in r.stderr
    assert tckpt.committed_steps(str(tmp / "ck")) == [2]
    ds = tckpt.read_data_state(str(tmp / "ck"), 2)
    assert (ds["shard_batches"], ds["num_shards"], ds["world_size"], ds["examples"]) == \
        ({"0": 2, "1": 2}, 2, 2, 4 * B)
    _fresh_copy(tmp / "ck", tmp / "ref")
    r = port_cli(["train", "--train", str(tmp / "train"), "--checkpoint-dir", str(tmp / "ck"),
                  *ARGS], tmp)
    assert r.returncode == 0, r.stderr
    assert "resuming data stream at epoch 0, shard offsets [2, 2] (restart generation 0); " \
           "resharding 2 shard(s) from 2 rank(s) onto 1" in r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert (summary["steps"], summary["examples"]) == (4, 4 * B)  # the rest, once
    step, got, ds = _final(tmp / "ck")
    assert step == 6 and ds["completed"] and ds["examples"] == 2 * ROWS
    # the same rows from the same state: shard 0's last 2 batches, then shard 1's
    _write(tmp / "rest-00000", _lines(tmp / "train-00000", 2 * B, ROWS)
           + _lines(tmp / "train-00001", 2 * B, ROWS))
    r = port_cli(["train", "--train", str(tmp / "rest"), "--checkpoint-dir", str(tmp / "ref"),
                  *ARGS], tmp)
    assert r.returncode == 0, r.stderr
    _, want, _ = _final(tmp / "ref")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_one_process_resumes_on_two_ranks(shards):
    tmp = shards
    r = port_cli(["train", "--train", str(tmp / "train"), "--checkpoint-dir", str(tmp / "ck"),
                  *ARGS], tmp, extra_env={"XFLOW_FAULT_KILL_STEP": "2"})
    assert r.returncode != 0 and "hard-killing rank 0 at step 2" in r.stderr
    ds = tckpt.read_data_state(str(tmp / "ck"), 2)
    assert (ds["shard_batches"], ds["num_shards"], ds["world_size"]) == ({"0": 2}, 1, 1)
    _fresh_copy(tmp / "ck", tmp / "ref")
    r = port_cli(["launch-local", "--num-processes", "2", "--", "--train", str(tmp / "train"),
                  "--checkpoint-dir", str(tmp / "ck"), *ARGS], tmp)
    assert r.returncode == 0, r.stderr
    assert "shard offsets [2] (restart generation 0); resharding 1 shard(s) from 1 rank(s) " \
           "onto 2" in r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    # shard 0's last 2 batches beside shard 1's 4: 4 steps, 6 batches of rows
    assert (summary["steps"], summary["examples"], summary["world"]) == (4, 6 * B, 2)
    step, got, ds = _final(tmp / "ck")
    assert step == 6 and ds["completed"] and ds["examples"] == 2 * B + 6 * B
    assert (ds["num_shards"], ds["world_size"]) == (2, 2)
    _write(tmp / "rest-00000", _lines(tmp / "train-00000", 2 * B, ROWS))
    shutil.copy(tmp / "train-00001", tmp / "rest-00001")
    r = port_cli(["launch-local", "--num-processes", "2", "--", "--train", str(tmp / "rest"),
                  "--checkpoint-dir", str(tmp / "ref"), *ARGS], tmp)
    assert r.returncode == 0, r.stderr
    _, want, _ = _final(tmp / "ref")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_missing_resumed_shard_warns_as_jax(shards, capfd):
    """A resumed shard (a nonzero offset) whose file is gone: the JAX
    trainer's warning, word for word, and the other shard trains."""
    from xflow_tpu.config import Config as JConfig
    from xflow_tpu.config import override as joverride
    from xflow_tpu.train.trainer import Trainer as JTrainer

    tmp = shards
    os.remove(tmp / "train-00001")
    ds = {"version": 2, "epoch": 0, "batches": 2, "completed": False, "examples": 4 * B,
          "shard_batches": {"0": 2, "1": 2}, "num_shards": 2, "world_size": 2}
    pairs = {"data.train_path": str(tmp / "train"), "data.batch_size": B,
             "data.log2_slots": 10, "data.max_nnz": 8, "model.num_fields": 4,
             "train.epochs": 1, "train.pred_dump": False}
    warnings = {}
    for name, trainer in (("torch", Trainer(override(Config(), **pairs), device="cpu")),
                          ("jax", JTrainer(joverride(JConfig(), **pairs)))):
        trainer._resume_data_state = dict(ds)
        res = trainer.fit()
        assert (res.steps, res.examples) == (2, 2 * B)  # shard 0's rest alone
        err = capfd.readouterr().err
        warnings[name] = [ln for ln in err.splitlines() if "is missing from this host" in ln]
    assert len(warnings["torch"]) == 1 and warnings["torch"] == warnings["jax"]


def test_allow_shrink_relaunches_the_smaller_world(shards):
    """Rank 1 wedges after step 3 (a 60 s stall); with --dead-after-s 2
    the watchdog's verdict tears the world down, and --allow-shrink
    relaunches generation 1 as a world of 1 that resumes step 2's
    checkpoint and covers both shards (XFLOW_ORIG_WORLD), its records
    stamped world 1."""
    tmp = shards
    run = tmp / "run"
    r = port_cli(["launch-local", "--num-processes", "2", "--max-restarts", "1",
                  "--restart-backoff", "0.1", "--allow-shrink", "--dead-after-s", "2",
                  "--watchdog-poll-s", "0.2", "--run-dir", str(run), "--",
                  "--train", str(tmp / "train"), "--checkpoint-dir", str(tmp / "ck"),
                  "--set", "train.heartbeat_every=1", "--set", "train.log_every=1", *ARGS],
                 tmp, extra_env={"XFLOW_FAULT_STALL_S": "60", "XFLOW_FAULT_STALL_STEP": "3",
                                 "XFLOW_FAULT_DELAY_RANK": "1"})
    assert r.returncode == 0, (r.stdout, r.stderr[-4000:])
    assert "watchdog verdict: dead/missing rank" in r.stderr
    assert "relaunching generation 1 DEGRADED at 1/2 rank(s)" in r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert (summary["steps"], summary["examples"]) == (4, 4 * B)
    _, _, ds = _final(tmp / "ck")
    assert ds["completed"] and ds["examples"] == 2 * ROWS and ds["world_size"] == 1
    recs = [json.loads(ln) for ln in open(run / "metrics_rank0.jsonl")]
    assert {(x["gen"], x["world"]) for x in recs} == {(0, 2), (1, 1)}
    events = [json.loads(ln) for ln in open(run / "watchdog.jsonl")]
    assert any(e["event"] == "dead" and e["gen"] == 0 and e["world"] == 2 for e in events)
