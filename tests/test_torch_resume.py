"""The trainer's resume over both checkpoint tiers, held to the JAX trainer.

The JAX trainer trains FM with `train.ckpt_replica_dir` set, so every
committed step is mirrored into the replica tier. Then the tiers are
damaged two ways, and the JAX `Trainer.maybe_restore` and the port's run
on the same directories:

- the primary's step 7 is damaged (a flipped byte in `state.npz`: Bad
  CRC-32) while the replica's step 7 is good;
- step 7 is committed only in the replica tier.

Both must resume at step 7 with bitwise-equal tables and optimizer
state, and read the same `data_state`, from the tier that restored.
"""

import shutil

import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

LOG2_S, B, NNZ, V, NF = 12, 64, 8, 4, 8
S = 1 << LOG2_S
ROWS = 200  # four batches an epoch, the last one padded
STEP = 7  # a mid-epoch step of the second epoch


def _pairs(**extra):
    return {
        "model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ, **extra,
    }


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX run's two tiers: steps 7 and 8 committed in the primary and
    mirrored into the replica; step 8 is then removed from both, so step
    7 (mid-epoch, its data_state not `completed`) is the newest."""
    work = tmp_path_factory.mktemp("torch_resume")
    jgenerate_shards(str(work / "train"), 1, ROWS, num_fields=NF, ids_per_field=40, seed=5)
    common = _pairs(**{"data.train_path": str(work / "train"), "train.epochs": 2})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_NATIVE_PLAN", None)
        mp.setenv("XFLOW_NO_NATIVE_PLAN", "1")
        jt = JTrainer(joverride(JConfig(), **common, **{
            "train.checkpoint_dir": str(work / "p"), "train.ckpt_replica_dir": str(work / "r"),
            "train.checkpoint_every": STEP, "train.pred_dump": False,
            "data.use_native_parser": False,
        }))
        jt.fit()
    for tier in ("p", "r"):
        assert tckpt.committed_steps(str(work / tier)) == [8, STEP]
        shutil.rmtree(work / tier / "step_8")
    return {"work": work, "common": common}


def _damage_primary(p):
    """Flip one byte in the middle of the primary's step-7 npz: the zip
    member's CRC-32 no longer matches."""
    path = p / f"step_{STEP}" / "state.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _drop_primary(p):
    shutil.rmtree(p / f"step_{STEP}")


@pytest.mark.parametrize("damage", [_damage_primary, _drop_primary],
                         ids=["poisoned_primary", "replica_only"])
def test_resume_over_the_replica_tier_matches_jax(trained, tmp_path, damage):
    p, r = tmp_path / "p", tmp_path / "r"
    shutil.copytree(trained["work"] / "p", p)
    shutil.copytree(trained["work"] / "r", r)
    damage(p)
    tiers = {"train.checkpoint_dir": str(p), "train.ckpt_replica_dir": str(r)}
    jt = JTrainer(joverride(JConfig(), **trained["common"], **tiers,
                            **{"train.pred_dump": False, "data.use_native_parser": False}))
    assert jt.maybe_restore() and int(jt.state.step) == STEP
    tt = Trainer(override(Config(), **trained["common"], **tiers), device="cpu")
    assert tt.maybe_restore() and tt.state.step == STEP

    want = {"wv": jt.state.tables["wv"], **jt.state.opt_state["wv"]}
    got = {"wv": tt.state.tables["wv"], **tt.state.opt_state["wv"]}
    assert set(got) == set(want) == {"wv", "n", "z"}
    for name, x in got.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(want[name]).reshape(S, -1),
                                      err_msg=name)
    ds = tt._resume_data_state
    assert ds == jt._resume_data_state
    assert ds is not None and ds["epoch"] == 1 and not ds["completed"]
    assert ds == tckpt.read_data_state(str(r), STEP)


def test_restore_state_returns_the_tier_it_loaded(trained, tmp_path):
    p, r = tmp_path / "p", tmp_path / "r"
    shutil.copytree(trained["work"] / "p", p)
    shutil.copytree(trained["work"] / "r", r)
    shapes = {"wv": (S, 1 + V)}
    *_, step, src = tckpt.restore_state(str(p), shapes, ("n", "z"), replica_dir=str(r))
    assert (step, src) == (STEP, str(p))
    _damage_primary(p)
    *_, step, src = tckpt.restore_state(str(p), shapes, ("n", "z"), replica_dir=str(r))
    assert (step, src) == (STEP, str(r))
    # without the replica tier the damaged primary has nothing to load
    with pytest.raises(RuntimeError, match="no loadable checkpoint"):
        tckpt.restore_state(str(p), shapes, ("n", "z"))
