"""PyTorch port, the corruption helpers of `xflow_tpu_torch/testing/
faults.py` against `xflow_tpu/testing/faults.py`: from the same seed and
the same input, `truncate_file`, `bitflip_file`, `bitflip_npz_array`,
`corrupt_npz_checkpoint` and `write_malformed_libffm` leave the same
bytes and return the same values, and `poison_nan_batches` poisons the
same training steps (the non-finite guard skips them in both trainers).
The port's checkpoint reader refuses what each corruption breaks.
"""

import os
import shutil

import numpy as np
import pytest

import xflow_tpu.testing.faults as jf
import xflow_tpu_torch.testing.faults as tf
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer
from xflow_tpu_torch.weights import table_shapes

B = 32
PAIRS = {"data.batch_size": B, "data.log2_slots": 10, "data.max_nnz": 8,
         "model.num_fields": 4, "train.epochs": 1, "train.pred_dump": False}


def _both(tmp_path, src):
    """Two copies of `src`, one for each package's helper."""
    out = {}
    for pkg in ("j", "t"):
        dst = tmp_path / pkg / os.path.basename(src)
        dst.parent.mkdir(parents=True, exist_ok=True)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
        out[pkg] = str(dst)
    return out


def _tree_bytes(root):
    return {os.path.relpath(os.path.join(d, n), root): open(os.path.join(d, n), "rb").read()
            for d, _, names in os.walk(root) for n in names}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A committed LR checkpoint the port wrote (steps 2 and 4)."""
    work = tmp_path_factory.mktemp("faults")
    generate_shards(str(work / "t"), 1, 4 * B, num_fields=4, ids_per_field=50)
    cfg = override(Config(), **PAIRS, **{"data.train_path": str(work / "t"),
                                         "train.checkpoint_dir": str(work / "ck"),
                                         "train.checkpoint_every": 2})
    assert Trainer(cfg, device="cpu").fit().steps == 4
    return work


@pytest.mark.parametrize("kw", [{}, {"keep_frac": 0.3}, {"keep_bytes": 17},
                                {"keep_bytes": 10 ** 9}])
def test_truncate_file_matches_jax(ckpt, tmp_path, kw):
    p = _both(tmp_path, str(ckpt / "t-00000"))
    assert tf.truncate_file(p["t"], **kw) == jf.truncate_file(p["j"], **kw)
    assert open(p["t"], "rb").read() == open(p["j"], "rb").read()


@pytest.mark.parametrize("kw", [{}, {"seed": 5, "count": 20}, {"offset": 3, "seed": 1}])
def test_bitflip_file_matches_jax(ckpt, tmp_path, kw):
    p = _both(tmp_path, str(ckpt / "t-00000"))
    assert tf.bitflip_file(p["t"], **kw) == jf.bitflip_file(p["j"], **kw)
    assert open(p["t"], "rb").read() == open(p["j"], "rb").read()


@pytest.mark.parametrize("kw", [{}, {"member": "opt/w/n.npy", "seed": 3},
                                {"offset": 0, "count": 1}])
def test_bitflip_npz_array_matches_jax(ckpt, tmp_path, kw):
    p = _both(tmp_path, str(ckpt / "ck" / "step_4" / "state.npz"))
    assert tf.bitflip_npz_array(p["t"], **kw) == jf.bitflip_npz_array(p["j"], **kw)
    assert open(p["t"], "rb").read() == open(p["j"], "rb").read()
    with np.load(p["t"]) as z:  # the container still reads
        assert "tables/w" in z.files
    with pytest.raises(ValueError, match="outside"):
        tf.bitflip_npz_array(p["t"], offset=10 ** 9)


@pytest.mark.parametrize("target,mode", [("state", "truncate"), ("state", "bitflip"),
                                         ("data_state", "truncate"),
                                         ("data_state", "bitflip")])
def test_corrupt_npz_checkpoint_matches_jax(ckpt, tmp_path, target, mode):
    p = _both(tmp_path, str(ckpt / "ck"))
    got = {pkg: mod.corrupt_npz_checkpoint(p[pkg], mode=mode, target=target, seed=2)
           for pkg, mod in (("j", jf), ("t", tf))}
    assert os.path.relpath(got["t"], p["t"]) == os.path.relpath(got["j"], p["j"])
    assert _tree_bytes(p["t"]) == _tree_bytes(p["j"])
    assert tckpt.committed_steps(p["t"]) == [4, 2]  # the marker stays
    cfg = override(Config(), **PAIRS)
    if target == "state":  # the walk-back skips the damaged step
        _, step, _ = tckpt.restore_tiered(p["t"], table_shapes(cfg), verify="on")
        assert step == 2
    else:
        assert tckpt.read_data_state(p["t"], 4) is None


def test_corrupt_npz_checkpoint_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        tf.corrupt_npz_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="expected state\\|data_state"):
        tf.corrupt_npz_checkpoint(str(tmp_path), step=1, target="meta")


@pytest.mark.parametrize("kw", [{}, {"seed": 7, "truncated_tail": True},
                                {"n_good": 3, "n_bad": 0, "n_nonrows": 2, "seed": 1}])
def test_write_malformed_libffm_matches_jax(tmp_path, kw):
    got = {pkg: mod.write_malformed_libffm(str(tmp_path / pkg), **kw)
           for pkg, mod in (("j", jf), ("t", tf))}
    assert got["t"] == got["j"]
    assert open(tmp_path / "t", "rb").read() == open(tmp_path / "j", "rb").read()


def test_poison_nan_batches_poisons_the_jax_steps(ckpt):
    """Steps 2 and 3 of 4 poisoned, the guard skipping them: the same
    bad steps and losses in both trainers."""
    common = {**PAIRS, "data.train_path": str(ckpt / "t"), "train.log_every": 1}
    jt = JTrainer(joverride(JConfig(), **common))
    tt = Trainer(override(Config(), **common), device="cpu")
    jf.poison_nan_batches(jt, [2, 3])
    tf.poison_nan_batches(tt, [2, 3])
    jres, tres = jt.fit(), tt.fit()
    assert tres.bad_steps == jres.bad_steps == 2
    assert tres.steps == jres.steps == 4
    assert tres.last_loss == pytest.approx(jres.last_loss, rel=1e-5)
    np.testing.assert_allclose(tt.state.tables["w"].numpy(), np.asarray(jt.state.tables["w"]),
                               rtol=0, atol=1e-6)
