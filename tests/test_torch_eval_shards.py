"""PyTorch port, one device's evaluate after an elastic resume (CPU, gloo
ranks): a world of 2 trains on two shards and is cut at step 2; the
checkpoint resumes on one device in both packages, and the exact pass,
the bucketed pass, the `eval_every` passes and the prediction dumps
cover both test shards and match the JAX trainer's, after
`xflow_tpu/train/trainer.py::evaluate` (`assign_shards` over the shard
set in play).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
ROWS = 4 * B
TEST_ROWS = 3 * B + 5  # a short last batch on each shard
AUC_ATOL, PCTR_ATOL = 1e-6, 1e-5  # the printed pctr has 6 decimals
ARGS = ["--model", "lr", "--epochs", "2", "--batch-size", str(B), "--log2-slots", "10",
        "--device", "cpu", "--set", "model.num_fields=4", "--set", "data.max_nnz=8",
        "--set", "train.pred_dump=false", "--set", "train.checkpoint_every=2"]
PAIRS = {"data.batch_size": B, "data.log2_slots": 10, "data.max_nnz": 8,
         "model.num_fields": 4, "train.epochs": 2, "train.eval_every": 1}


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["XFLOW_FAULT_KILL_STEP"] = "2"
    return env


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Both packages' trainers, resumed on one device from the 2-rank
    checkpoint and fitted to the end, each evaluated exact (block 0) and
    bucketed (block 1) with the dump on in its own directory."""
    work = tmp_path_factory.mktemp("eval_shards")
    generate_shards(str(work / "train"), 2, ROWS, num_fields=4, ids_per_field=50, seed=3)
    generate_shards(str(work / "test"), 2, TEST_ROWS, num_fields=4, ids_per_field=50,
                    seed=4)
    r = subprocess.run([sys.executable, "-m", "xflow_tpu_torch", "launch-local",
                        "--num-processes", "2", "--", "--train", str(work / "train"),
                        "--checkpoint-dir", str(work / "ck"), *ARGS],
                       cwd=work, env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and "hard-killing rank" in r.stderr
    assert tckpt.committed_steps(str(work / "ck")) == [2]
    assert tckpt.read_data_state(str(work / "ck"), 2)["num_shards"] == 2
    out = {"work": work}
    with pytest.MonkeyPatch.context() as mp:
        for side, (make, over) in {"t": (lambda c: Trainer(c, device="cpu"),
                                         lambda **kw: override(Config(), **kw)),
                                   "j": (JTrainer, lambda **kw: joverride(JConfig(), **kw))
                                   }.items():
            shutil.copytree(work / "ck", work / side / "ck")
            mp.chdir(work / side)
            t = make(over(**PAIRS, **{
                "data.train_path": str(work / "train"), "data.test_path": str(work / "test"),
                "train.checkpoint_dir": str(work / side / "ck"),
                "train.metrics_path": str(work / side / "metrics_rank0.jsonl")}))
            assert t.maybe_restore() and t.state.step == 2
            t.fit()
            out[f"{side}exact"] = t.evaluate(dump=True)
            # streaming (an eval_every pass's mode): 65,536 buckets under auto
            out[f"{side}bucketed"] = t.evaluate(dump=True, block=1, streaming=True)
            with open(t.cfg.train.metrics_path) as f:
                out[f"{side}evals"] = [json.loads(ln) for ln in f if '"eval_auc"' in ln]
    return out


@pytest.mark.parametrize("kind", ["exact", "bucketed"])
def test_resumed_evaluate_covers_both_test_shards_as_jax(resumed, kind):
    (ta, tl), (ja, jl) = resumed["t" + kind], resumed["j" + kind]
    assert np.isfinite([ta, tl]).all()
    assert ta == pytest.approx(ja, abs=AUC_ATOL) and tl == pytest.approx(jl, abs=AUC_ATOL)


@pytest.mark.parametrize("block", [0, 1])
def test_resumed_prediction_dump_walks_the_shards_as_jax(resumed, block):
    rows = {}
    for s in "tj":
        with open(resumed["work"] / s / f"pred_0_{block}.txt") as f:
            rows[s] = [ln.split("\t") for ln in f.read().splitlines()]
    assert len(rows["t"]) == len(rows["j"]) == 2 * TEST_ROWS  # both shards, in order
    for a, b in zip(rows["t"], rows["j"]):
        assert a[1:] == b[1:] and abs(float(a[0]) - float(b[0])) <= PCTR_ATOL


def test_resumed_eval_every_passes_match_jax(resumed):
    te, je = resumed["tevals"], resumed["jevals"]
    assert len(te) == len(je) == 2
    for a, b in zip(te, je):
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        assert a["eval_auc"] == pytest.approx(b["eval_auc"], abs=AUC_ATOL)
        assert a["eval_logloss"] == pytest.approx(b["eval_logloss"], abs=AUC_ATOL)


def test_an_explicit_test_file_is_read_alone(resumed, tmp_path, monkeypatch):
    """An explicit `test_path` keeps its meaning: that one file."""
    work = resumed["work"]
    cfg = override(Config(), **PAIRS, **{"data.test_path": str(work / "test"),
                                         "train.checkpoint_dir": str(work / "t" / "ck")})
    t = Trainer(cfg, device="cpu")
    assert t.maybe_restore()
    monkeypatch.chdir(tmp_path)
    t.evaluate(test_path=str(work / "test-00001"), dump=True)
    with open(tmp_path / "pred_0_0.txt") as f:
        assert len(f.read().splitlines()) == TEST_ROWS
