"""PyTorch port, single-device FM training (xflow_tpu_torch/train) held
against the JAX package:

- the train step against `xflow_tpu.train.step.make_train_step(jit=False)`
  from the same state (carried across with `weights.state_from_jax`),
  three steps of fused FTRL, two-pass FTRL (`optim.fused_scatter=off`)
  and two-pass SGD: loss within 1e-5 relative, tables and optimizer
  state within 1e-3 relative over a 1e-4 floor (kernel_parity's FTRL
  class);
- the fused step equals the two-pass step in the port, bf16 off and on;
- the non-finite guard under skip keeps the state and advances the step;
- `Trainer.fit` against the JAX `Trainer.fit` on one 200-row shard
  (three full batches and a padded one), 2 epochs, both from the step-0
  checkpoint the JAX trainer wrote: the per-step loss, the final
  wv / n / z, AUC and logloss of both packages' evaluate, and each
  package's final checkpoint restored by the other;
- a run interrupted at step 2 and resumed from its checkpoint ends
  bitwise equal to an uninterrupted run.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu.train.step import make_train_step as jmake_train_step
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.libffm import iter_batches, iter_examples
from xflow_tpu_torch.evaluate import batch_arrays, to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.train.trainer import Trainer
from xflow_tpu_torch.weights import state_from_jax

LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
S, K = 1 << LOG2_S, 1 + V
ROWS = 200  # three full batches and a padded one
LOSS_RTOL = 1e-5
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4


def _pairs(**extra):
    return {
        "model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ, **extra,
    }


def _close(got, want, rtol=FTRL_RTOL, floor=FTRL_FLOOR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / (np.abs(want) + floor)) <= rtol


def _host(x):
    return np.asarray(x).reshape(S, -1) if np.asarray(x).ndim == 2 else np.asarray(x)


def _jax_leaves(state):
    out = {"wv": _host(state.tables["wv"])}
    out.update({k: _host(v) for k, v in state.opt_state["wv"].items()})
    return out


def _port_leaves(state):
    out = {"wv": state.tables["wv"].numpy()}
    out.update({k: v.numpy() for k, v in state.opt_state["wv"].items()})
    return out


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _batch(seed, nan_labels=False):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, NNZ)).astype(np.int32)
    slots[:3] = slots[3:6]
    mask = (rng.random((B, NNZ)) < 0.8).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    if nan_labels:
        labels[0] = np.nan
    row_mask = np.ones(B, np.float32)
    row_mask[-5:] = 0.0
    mask[-5:] = 0.0
    plan = jst.plan_sorted_batch(slots, mask, S)
    return jst.compact_plan_wire({
        "labels": labels, "row_mask": row_mask, "sorted_slots": plan.sorted_slots,
        "sorted_row": plan.sorted_row, "sorted_mask": plan.sorted_mask,
        "win_off": plan.win_off,
    }, rows_bound=B)


VARIANTS = {
    "fused_ftrl": {},
    "two_pass_ftrl": {"optim.fused_scatter": "off"},
    "two_pass_sgd": {"optim.name": "sgd"},
}


def _both_states(pairs):
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    js = jinit_state(jget_model("fm"), jget_optimizer(jcfg.optim.name), jcfg)
    ts = state_from_jax(
        {k: np.asarray(v) for k, v in js.tables.items()},
        {k: {leaf: np.asarray(a) for leaf, a in d.items()} for k, d in js.opt_state.items()},
        js.step, tcfg, device="cpu",
    )
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_matches_jax(variant):
    jcfg, tcfg, js, ts = _both_states(_pairs(**VARIANTS[variant]))
    assert tuple(ts.tables["wv"].shape) == (S, K)  # packed JAX state unpacked
    jstep = jmake_train_step(jget_model("fm"), jget_optimizer(jcfg.optim.name), jcfg, jit=False)
    tstep = make_train_step(get_model("fm")(tcfg), get_optimizer(tcfg.optim.name), tcfg)
    for i in range(3):
        arrays = _batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in arrays.items()})
        ts, tm = tstep(ts, to_device(arrays, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        assert tm["update_ok"] and bool(jm["update_ok"])
        assert float(tm["rows"]) == float(jm["rows"]) == B - 5
    assert ts.step == int(js.step) == 3
    got, want = _port_leaves(ts), _jax_leaves(js)
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name])


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_step_equals_two_pass(bf16):
    pairs = _pairs(**{"data.sorted_bf16": bf16})
    _, tcfg, _, ts = _both_states(pairs)
    two_cfg = override(tcfg, **{"optim.fused_scatter": "off"})
    model, opt = get_model("fm")(tcfg), get_optimizer("ftrl")
    fused, two = make_train_step(model, opt, tcfg), make_train_step(model, opt, two_cfg)
    a = b = ts
    for i in range(3):
        batch = to_device(_batch(10 + i), "cpu")
        a, ma = fused(a, batch)
        b, mb = two(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for name, x in _port_leaves(a).items():
        np.testing.assert_array_equal(x, _port_leaves(b)[name], err_msg=name)


def test_nonfinite_step_is_skipped():
    _, tcfg, _, ts = _both_states(_pairs())
    step = make_train_step(get_model("fm")(tcfg), get_optimizer("ftrl"), tcfg)
    new, m = step(ts, to_device(_batch(20, nan_labels=True), "cpu"))
    assert not m["update_ok"] and not np.isfinite(float(m["loss"]))
    assert new.step == ts.step + 1
    assert new.tables["wv"] is ts.tables["wv"]
    assert new.opt_state["wv"]["n"] is ts.opt_state["wv"]["n"]
    off = override(tcfg, **{"train.nonfinite_guard": "off"})
    new_off, m_off = make_train_step(get_model("fm")(off), get_optimizer("ftrl"), off)(
        ts, to_device(_batch(20, nan_labels=True), "cpu")
    )
    assert "update_ok" not in m_off and not torch.isfinite(new_off.tables["wv"]).all()


def test_fused_scatter_on_rules():
    cfg = override(Config(), **_pairs(**{"optim.fused_scatter": "on", "optim.name": "sgd"}))
    with pytest.raises(ValueError, match="fused_scatter=on requires"):
        make_train_step(get_model("fm")(cfg), get_optimizer("sgd"), cfg)
    cfg = override(Config(), **_pairs(**{"optim.fused_scatter": "on"}))
    step = make_train_step(get_model("fm")(cfg), get_optimizer("ftrl"), cfg)
    _, _, _, ts = _both_states(_pairs())
    rng = np.random.default_rng(0)
    row_major = {
        "slots": rng.integers(0, S, (B, NNZ)).astype(np.int32),
        "mask": np.ones((B, NNZ), np.float32), "labels": np.zeros(B, np.float32),
        "row_mask": np.ones(B, np.float32),
    }
    with pytest.raises(ValueError, match="no flat fields-free sorted plan"):
        step(ts, to_device(row_major, "cpu"))
    bad = override(Config(), **_pairs(**{"optim.fused_scatter": "sometimes"}))
    with pytest.raises(ValueError, match="expected auto\\|on\\|off"):
        make_train_step(get_model("fm")(bad), get_optimizer("ftrl"), bad)


def _recording(step, losses):
    def wrapped(state, batch):
        new, m = step(state, batch)
        losses.append(float(m["loss"]))
        return new, m

    return wrapped


@pytest.fixture(scope="module")
def fit_case(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_fit")
    (path,) = jgenerate_shards(str(work / "train"), 1, ROWS, num_fields=NF,
                               ids_per_field=40, seed=5)
    jck, tck = work / "jck", work / "tck"
    common = _pairs(**{"data.train_path": str(work / "train"), "train.epochs": 2})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_NATIVE_PLAN", None)
        mp.setenv("XFLOW_NO_NATIVE_PLAN", "1")
        jcfg = joverride(JConfig(), **common, **{
            "train.checkpoint_dir": str(jck), "train.pred_dump": False,
            "data.use_native_parser": False,
        })
        jt = JTrainer(jcfg)
        assert jt._sorted
        jt.save_checkpoint()  # the shared initial state, step 0
        shutil.copytree(jck / "step_0", tck / "step_0")
        tt = Trainer(override(Config(), **common, **{"train.checkpoint_dir": str(tck)}),
                     device="cpu")
        assert tt.sorted and tt.maybe_restore() and tt.state.step == 0
        jlosses, tlosses = [], []
        jt.train_step = _recording(jt.train_step, jlosses)
        tt.train_step = _recording(tt.train_step, tlosses)
        jres, tres = jt.fit(), tt.fit()
        jeval = jt.evaluate(test_path=path, dump=False)
    return {
        "path": path, "jck": jck, "tck": tck, "jt": jt, "tt": tt, "jres": jres,
        "tres": tres, "jlosses": jlosses, "tlosses": tlosses, "jeval": jeval,
        "common": common,
    }


def test_fit_losses_match_jax_step_for_step(fit_case):
    j, t = fit_case["jlosses"], fit_case["tlosses"]
    assert len(t) == len(j) == 8  # 2 epochs x 4 batches
    np.testing.assert_allclose(t, j, rtol=LOSS_RTOL)
    jres, tres = fit_case["jres"], fit_case["tres"]
    assert (tres.steps, tres.epochs, tres.examples, tres.bad_steps) == (
        jres.steps, jres.epochs, jres.examples, jres.bad_steps) == (8, 2, 2 * ROWS, 0)
    assert tres.last_loss == pytest.approx(jres.last_loss, rel=LOSS_RTOL)
    assert tres.occupancy == pytest.approx(jres.occupancy)


def test_fit_final_state_matches_jax(fit_case):
    got, want = _port_leaves(fit_case["tt"].state), _jax_leaves(fit_case["jt"].state)
    for name in ("wv", "n", "z"):
        _close(got[name], want[name])
    assert fit_case["tt"].state.step == int(fit_case["jt"].state.step) == 8


def test_fit_evaluate_matches_jax(fit_case):
    auc, ll = fit_case["tt"].evaluate(fit_case["path"])
    jauc, jll = fit_case["jeval"]
    assert abs(auc - jauc) <= 1e-3 and auc > 0.5
    assert abs(ll - jll) <= 1e-5 * abs(jll)


def test_port_checkpoint_restores_in_jax(fit_case):
    jt, tt = fit_case["jt"], fit_case["tt"]
    assert tckpt.committed_steps(str(fit_case["tck"])) == [8, 0]
    state = jckpt.restore(str(fit_case["tck"]), jt.state)
    got, want = _jax_leaves(state), _port_leaves(tt.state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert int(state.step) == 8
    ds = jckpt.normalize_data_state(jckpt.read_data_state(str(fit_case["tck"]), 8))
    assert (ds["epoch"], ds["completed"], ds["examples"], ds["shard_batches"]) == (
        2, True, 2 * ROWS, {0: 0})


def test_jax_checkpoint_restores_in_port(fit_case):
    cfg = override(Config(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["jck"])})
    t = Trainer(cfg, device="cpu")
    assert t.maybe_restore() and t.state.step == 8
    got, want = _port_leaves(t.state), _jax_leaves(fit_case["jt"].state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert t._consume_resume_position() == (0, 0)  # completed: a fresh pass


def test_resume_from_interrupted_run_equals_uninterrupted(fit_case, tmp_path):
    common = fit_case["common"]
    whole = Trainer(override(Config(), **common, **{"train.checkpoint_dir": str(tmp_path / "a")}),
                    device="cpu")
    whole.fit()
    cfg_b = override(Config(), **common, **{
        "train.checkpoint_dir": str(tmp_path / "b"), "train.checkpoint_every": 2})
    cut = Trainer(cfg_b, device="cpu")
    calls = []

    def dies_at_step_3(state, batch, step=cut.train_step):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("killed")
        return step(state, batch)

    cut.train_step = dies_at_step_3
    with pytest.raises(RuntimeError, match="killed"):
        cut.fit()
    assert tckpt.committed_steps(str(tmp_path / "b")) == [2]
    with open(tmp_path / "b" / "step_2" / tckpt.DATA_STATE_FILE) as f:
        ds = json.load(f)
    assert (ds["epoch"], ds["shard_batches"], ds["completed"]) == (0, {"0": 2}, False)
    resumed = Trainer(cfg_b, device="cpu")
    assert resumed.maybe_restore() and resumed.state.step == 2
    res = resumed.fit()
    assert res.steps == 6 and resumed.state.step == whole.state.step == 8
    for name, x in _port_leaves(resumed.state).items():
        np.testing.assert_array_equal(x, _port_leaves(whole.state)[name], err_msg=name)
    final = tckpt.read_data_state(str(tmp_path / "b"), 8)
    assert final["examples"] == 2 * ROWS and final["completed"]


def test_iter_batches_skip_matches_the_consumed_prefix(fit_case):
    cfg = override(Config(), **fit_case["common"]).data
    every = list(iter_batches(fit_case["path"], cfg))
    rest = list(iter_batches(fit_case["path"], cfg, skip=2))
    assert len(every) == 4 and len(rest) == 2
    for a, b in zip(every[2:], rest):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert batch_arrays(rest[-1], override(Config(), **fit_case["common"]))["row_mask"].sum() == 8


def test_iter_examples_skip_counts_what_parse_line_yields(tmp_path):
    # blank lines, a line without a label separator and a label with only
    # a trailing tab yield no example, so a resumed run's skip passes them
    path = tmp_path / "mixed"
    path.write_text("\n".join([
        "1\t1:a:1 2:b:1", "", "   ", "0 1:c:1", "label_only", "1\t", "\t0\t3:d:1", "1\t2:e:1",
    ]) + "\n")
    every = list(iter_examples(str(path), LOG2_S))
    assert [label for label, _, _ in every] == [1.0, 0.0, 0.0, 1.0]
    for k in range(len(every) + 1):
        rest = list(iter_examples(str(path), LOG2_S, skip=k))
        assert len(rest) == len(every) - k
        for a, b in zip(every[k:], rest):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])


def test_sgd_occupancy_counts_the_touched_slots(fit_case, tmp_path):
    # both trainers from the JAX trainer's step-0 SGD state: the same
    # losses and the JAX rule (any column off v_init_sgd), which reads
    # 1.0 for the fused table whose column 0 starts at 0
    sgd = {**fit_case["common"], "optim.name": "sgd"}
    jt = JTrainer(joverride(JConfig(), **sgd, **{
        "train.checkpoint_dir": str(tmp_path / "j"), "train.pred_dump": False,
        "data.use_native_parser": False,
    }))
    jt.save_checkpoint()
    shutil.copytree(tmp_path / "j" / "step_0", tmp_path / "t" / "step_0")
    tt = Trainer(override(Config(), **sgd, **{"train.checkpoint_dir": str(tmp_path / "t")}),
                 device="cpu")
    assert tt.maybe_restore() and tt.state.step == 0
    jlosses, tlosses = [], []
    jt.train_step = _recording(jt.train_step, jlosses)
    tt.train_step = _recording(tt.train_step, tlosses)
    jres, tres = jt.fit(), tt.fit()
    assert len(tlosses) == len(jlosses) == 8
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tres.occupancy == pytest.approx(jres.occupancy)
    assert tres.occupancy == {"wv": 1.0}
