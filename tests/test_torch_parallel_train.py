"""PyTorch port, a multi-rank `train` on the CPU (gloo) held against one
process:

- `python -m xflow_tpu_torch train` as 2 ranks (`--coordinator`,
  `--num-processes`, `--process-id`) for LR, the default model (the
  row-major sharded step), and for FM (the fully-sharded engine), against
  a single-process port run and the JAX package's single-process
  `--no-mesh` run at 2B on the shards interleaved as
  `tests/test_launch_dist.py` composes them (step i's global batch is
  rank 0's rows then rank 1's). FM's three runs start from one step-0
  checkpoint. `tables/w` and `opt/w/n` within 1e-6 for LR, the
  fully-sharded tolerance (2e-4 relative over 1e-6) for FM; rank 0's
  checkpoint restores into the single-device port and evaluates as the
  single-process run's does;
- `Trainer(cfg, mesh).fit()` on 2 spawned ranks: a skewed shard at slack
  1.0 sends both ranks to the row-major step on the same batches (the
  per-batch all_reduce), and ragged shards (3 batches against 1) give
  both ranks the same step count, the short one padding.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parallel_ranks import fit_world
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, ROWS = 32, 96  # 3 batches a rank an epoch
LOG2 = 12  # 4096 slots: two fully-sharded blocks of one window each
COMMON = ["--epochs", "2", "--log2-slots", str(LOG2), "--set", "model.num_fields=4",
          "--set", "data.max_nnz=8", "--set", "train.pred_dump=false"]
FM = ["--model", "fm", "--set", "model.v_dim=4"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    for k in ("XFLOW_COORDINATOR", "XFLOW_NUM_PROCESSES", "XFLOW_PROCESS_ID"):
        env.pop(k, None)
    return env


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(pkg: str, args: list, cwd) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", pkg, *args], cwd=cwd, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(p: subprocess.Popen) -> tuple:
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, err[-3000:]
    return out, err


def _summary(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def _interleave(paths, block_rows, out_path):
    shard_lines = [open(p).read().splitlines() for p in paths]
    out = []
    for b in range(max(len(ls) for ls in shard_lines) // block_rows):
        for lines in shard_lines:
            out.extend(lines[b * block_rows : (b + 1) * block_rows])
    with open(out_path, "w") as f:
        f.write("\n".join(out) + "\n")


def _state(ck, step):
    return np.load(os.path.join(str(ck), f"step_{step}", "state.npz"))


def _seed_step0(ck_dirs, cfg):
    """One step-0 checkpoint of the port's seeded initial state in every
    dir: the three runs start from the same tables."""
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.state import init_state

    st = init_state(get_model(cfg.model.name)(cfg), get_optimizer("ftrl"), cfg, "cpu")
    for d in ck_dirs:
        tckpt.save_state(str(d), {n: t.numpy() for n, t in st.tables.items()},
                         {n: {k: v.numpy() for k, v in s.items()} for n, s in
                          st.opt_state.items()}, 0)


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_two_rank_cli_matches_single_process_and_jax(model, tmp_path):
    jgenerate_shards(str(tmp_path / "train"), 2, ROWS, num_fields=4, ids_per_field=50)
    _interleave([tmp_path / "train-00000", tmp_path / "train-00001"], B,
                tmp_path / "comb-00000")
    extra = FM if model == "fm" else []
    cks = [tmp_path / n for n in ("ck2", "ck1", "ckj")]
    if model == "fm":
        _seed_step0(cks, override(Config(), **{"model.name": "fm", "model.v_dim": 4,
                                               "model.num_fields": 4,
                                               "data.log2_slots": LOG2}))
    port = str(_free_port())
    ranks = [_cli("xflow_tpu_torch",
                  ["train", "--train", str(tmp_path / "train"), "--test",
                   str(tmp_path / "train"), "--batch-size", str(B), "--checkpoint-dir",
                   str(cks[0]), "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(r), *COMMON, *extra],
                  tmp_path) for r in range(2)]
    single = _cli("xflow_tpu_torch",
                  ["train", "--train", str(tmp_path / "comb"), "--test", str(tmp_path / "comb"),
                   "--batch-size", str(2 * B), "--checkpoint-dir", str(cks[1]),
                   "--device", "cpu", *COMMON, *extra], tmp_path)
    jax_run = _cli("xflow_tpu",
                   ["train", "--train", str(tmp_path / "comb"), "--batch-size", str(2 * B),
                    "--checkpoint-dir", str(cks[2]), "--no-mesh", *COMMON, *extra], tmp_path)
    outs = [_done(p)[0] for p in ranks]
    assert outs[1].strip() == ""  # rank 0 alone prints the summary
    s2 = _summary(outs[0])
    s1 = _summary(_done(single)[0])
    sj = _summary(_done(jax_run)[0])
    assert s2["world"] == 2 and s2["rank"] == 0
    assert s2["steps"] == s1["steps"] == sj["steps"] == 2 * (ROWS // B)
    assert s2["examples"] == s1["examples"] == 2 * 2 * ROWS
    steps = s2["steps"]
    assert tckpt.latest_step(str(cks[0])) == steps
    d2, d1, dj = (_state(c, steps) for c in cks)
    name = "w" if model == "lr" else "wv"
    if model == "lr":
        for key in ("tables/w", "opt/w/n"):
            np.testing.assert_allclose(d2[key], d1[key], rtol=0, atol=1e-6, err_msg=key)
            np.testing.assert_allclose(d2[key], dj[key], rtol=0, atol=1e-6, err_msg=key)
    else:
        from xflow_tpu_torch.weights import state_from_jax

        jcfg = override(Config(), **{"model.name": "fm", "model.v_dim": 4,
                                     "model.num_fields": 4, "data.log2_slots": LOG2})
        jst = state_from_jax({"wv": dj["tables/wv"]},
                             {"wv": {"n": dj["opt/wv/n"], "z": dj["opt/wv/z"]}}, steps, jcfg,
                             device="cpu")
        for key, want in (("tables/wv", d1["tables/wv"]), ("opt/wv/n", d1["opt/wv/n"]),
                          ("tables/wv", jst.tables["wv"].numpy()),
                          ("opt/wv/n", jst.opt_state["wv"]["n"].numpy())):
            np.testing.assert_allclose(d2[key], want, rtol=2e-4, atol=1e-6, err_msg=key)
    assert abs(s2["auc"] - s1["auc"]) <= 1e-6
    assert abs(s2["logloss"] - s1["logloss"]) <= 1e-5
    # rank 0's checkpoint restores on one device and evaluates as the
    # single-process run's checkpoint does
    pairs = {"model.name": model, "model.num_fields": 4, "data.max_nnz": 8,
             "data.log2_slots": LOG2, "data.batch_size": 2 * B, "model.v_dim": 4,
             "train.checkpoint_dir": str(cks[0]), "train.pred_dump": False}
    t = Trainer(override(Config(), **pairs), device="cpu")
    assert t.maybe_restore() and t.state.step == steps
    assert np.array_equal(t.state.tables[name].numpy(), d2[f"tables/{name}"])
    auc, ll = t.evaluate(test_path=str(tmp_path / "comb-00000"))
    assert abs(auc - s1["auc"]) <= 1e-6 and abs(ll - s1["logloss"]) <= 1e-5


def _uniform_rows(rng, n, fields=8):
    return [f"{int(rng.random() < 0.4)} " + " ".join(
        f"{f}:{int(rng.integers(0, 5000))}:1" for f in range(fields)) for _ in range(n)]


def test_skewed_and_ragged_shards_keep_the_ranks_in_step(tmp_path):
    """Rank 0's second batch is one feature in every occurrence; at slack
    1.0 its owner block overflows (2,048 occurrences over a capacity of
    1,536) while rank 1's uniform batch fits, and both ranks run that
    batch on the row-major step. Rank 0 has 3 batches, rank 1 one: both
    take 3 steps an epoch."""
    rng = np.random.default_rng(4)
    Bs = 256
    hot = ["1 " + " ".join("0:7:1" for _ in range(8))] * Bs
    with open(tmp_path / "d-00000", "w") as f:
        f.write("\n".join(_uniform_rows(rng, Bs) + hot + _uniform_rows(rng, Bs)) + "\n")
    with open(tmp_path / "d-00001", "w") as f:
        f.write("\n".join(_uniform_rows(rng, Bs)) + "\n")
    pairs = {"model.name": "fm", "model.v_dim": 4, "model.num_fields": 8,
             "data.max_nnz": 8, "data.log2_slots": LOG2, "data.batch_size": Bs,
             "data.train_path": str(tmp_path / "d"), "train.epochs": 2,
             "data.fullshard_slack": 1.0, "data.cache": "off"}
    got = fit_world(2, tmp_path, pairs)
    assert [g["engine"] for g in got] == ["fullshard", "fullshard"]
    assert got[0]["steps"] == got[1]["steps"] == 6
    assert got[0]["log"] == got[1]["log"]
    # the hot batch, and rank 1's padding batches (every masked occurrence
    # sits at slot 0, one block), take the row-major step
    assert got[0]["log"][:3] == ["fullshard", "row_major", "row_major"]
    assert got[0]["log"][3:] == got[0]["log"][:3]
    assert got[0]["examples"] == got[1]["examples"] == 2 * 4 * Bs
