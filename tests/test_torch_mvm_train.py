"""PyTorch port, single-device MVM training held against the JAX package:

- the train step against `xflow_tpu.train.step.make_train_step(jit=False)`
  from the same state (carried across with `weights.state_from_jax`):
  product two-pass (the `auto` default for MVM), product fused
  (`optim.fused_scatter=on`), segment stacked two-pass
  (`mvm_exclusive=off`, NS = 4) with FTRL and with SGD, and a non-finite
  batch under `skip`: loss within 1e-6 relative, state within 1e-3
  relative over a 1e-4 floor (kernel_parity's FTRL class), w of
  lazy-init (never-touched) entries bitwise;
- `Trainer.fit` against the JAX `Trainer.fit` on a 200-row shard, 2
  epochs from the same step-0 checkpoint, on three shards: the synthetic
  one-feature-per-field shard (product row side), the same shard with
  `mvm_exclusive=off` and NS = 2 (segment row side, stacked plans), and a
  hand-written shard whose batches mix clean rows and rows that repeat a
  field under `auto` (both row sides in one run): per-step losses, the
  final v / n / z, both packages' evaluate AUC and logloss;
- checkpoints: each package's MVM checkpoint restores in the other with
  its optimizer state; an interrupted and resumed run ends bitwise equal
  to an uninterrupted one;
- serving: `ServeRunner.predict_rows` (row-major) against the port's
  evaluate (sorted) and the JAX serve runner, within 1e-5;
- the denormal difference of the plain form: XLA flushes a denormal
  gradient to 0, torch keeps it (a difference of the packages, pinned).

The plain form (mvm_plus_one off) runs at v_init_scale 0.1 with 8
fields, which keeps every gradient in float32's normal range.
Small shapes: S = 2^14, B = 64, 8 fields, v_dim = 4.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.models.mvm as jmvm
import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.serve.runner import ServeRunner as JServeRunner
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu.train.step import make_train_step as jmake_train_step
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.libffm import iter_batches
from xflow_tpu_torch.evaluate import batch_arrays, predict_batches, to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models import mvm as tmvm
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.serve.runner import ServeRunner
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.train.trainer import Trainer
from xflow_tpu_torch.weights import state_from_jax

LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
S = 1 << LOG2_S
ROWS = 200  # three full batches and a padded one
LOSS_RTOL = 1e-6
FIT_LOSS_RTOL = 1e-5
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _pairs(**extra):
    return {
        "model.name": "mvm", "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ,
        "optim.v_init_scale": 0.1, **extra,
    }


def _close(got, want, rtol=FTRL_RTOL, floor=FTRL_FLOOR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / (np.abs(want) + floor)
    assert err.max() <= rtol, err.max()


def _close_scaled(got, want):
    """Within FTRL_RTOL over a floor of 1e-2 of the largest |want|: the
    fixed 1e-4 floor is blind to a plain-form gradient of about 1e-9."""
    scale = float(np.abs(want).max())
    if scale > 0:
        _close(got, want, floor=1e-2 * scale)
    else:
        np.testing.assert_array_equal(got, want)


def _host(x):
    x = np.asarray(x)
    return x.reshape(S, -1) if x.ndim == 2 else x


def _jax_leaves(state):
    out = {"v": _host(state.tables["v"])}
    out.update({k: _host(a) for k, a in state.opt_state["v"].items()})
    return out


def _port_leaves(state):
    out = {"v": state.tables["v"].cpu().numpy()}
    out.update({k: a.cpu().numpy() for k, a in state.opt_state["v"].items()})
    return out


def _sparse_batch(seed, dup_rows=0, nan_label=False):
    """A SparseBatch of B rows with one feature per field, the first
    `dup_rows` rows repeating a field; the last 5 rows padding."""
    from xflow_tpu_torch.data.schema import make_batch

    rng = np.random.default_rng(seed)
    fields, slots = [], []
    for r in range(B - 5):
        n = int(rng.integers(3, NNZ + 1))
        f = rng.permutation(NF)[:n].astype(np.int32)
        if r < dup_rows:
            f[-1] = f[0]
        fields.append(f)
        slots.append(rng.integers(0, S, n).astype(np.int32))
    slots[1][0] = slots[40][0]  # a slot that two sub-batches share
    labels = list((rng.random(B - 5) < 0.4).astype(np.float32))
    if nan_label:
        labels[0] = np.nan
    return make_batch(fields, slots, labels, B, NNZ)


VARIANTS = {
    "product_two_pass": {},
    "product_fused": {"optim.fused_scatter": "on"},
    "segment_stacked_ftrl": {"model.mvm_exclusive": "off", "data.sorted_sub_batches": 4},
    # SGD's default init and rate move no v of an 8-factor product
    "segment_stacked_sgd": {"model.mvm_exclusive": "off", "data.sorted_sub_batches": 4,
                            "optim.name": "sgd", "optim.v_init_sgd": 0.5, "optim.sgd.lr": 0.5},
    "product_plus_one": {"model.mvm_plus_one": True},
    "segment_plus_one": {"model.mvm_exclusive": "off", "data.sorted_sub_batches": 2,
                         "model.mvm_plus_one": True},
}


def _both_states(pairs):
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    js = jinit_state(jget_model("mvm"), jget_optimizer(jcfg.optim.name), jcfg)
    ts = state_from_jax(
        {k: np.asarray(a) for k, a in js.tables.items()},
        {k: {leaf: np.asarray(a) for leaf, a in d.items()} for k, d in js.opt_state.items()},
        js.step, tcfg, device="cpu",
    )
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_matches_jax(variant):
    jcfg, tcfg, js, ts = _both_states(_pairs(**VARIANTS[variant]))
    js0 = js
    assert tuple(ts.tables["v"].shape) == (S, V)  # packed JAX state unpacked
    v0 = ts.tables["v"].clone()
    jstep = jmake_train_step(jget_model("mvm"), jget_optimizer(jcfg.optim.name), jcfg, jit=False)
    tstep = make_train_step(get_model("mvm")(tcfg), get_optimizer(tcfg.optim.name), tcfg)
    segment = tcfg.model.mvm_exclusive == "off"
    for i in range(3):
        arrays = batch_arrays(_sparse_batch(i), tcfg)
        assert ("sorted_fields" in arrays) == segment
        assert arrays["sorted_slots"].ndim == (2 if segment else 1)
        js, jm = jstep(js, {k: jnp.asarray(a) for k, a in arrays.items()})
        ts, tm = tstep(ts, to_device(arrays, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        assert tm["update_ok"] and bool(jm["update_ok"])
    assert ts.step == int(js.step) == 3
    got, want = _port_leaves(ts), _jax_leaves(js)
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name])
        _close_scaled(got[name], want[name])
    moved = "z" if tcfg.optim.name == "ftrl" else "v"
    assert not np.array_equal(want[moved], _jax_leaves(js0)[moved])
    if tcfg.optim.name == "ftrl":  # lazy init: never-touched entries keep w bitwise
        lazy = (want["n"] == 0)
        assert lazy.any() and (~lazy).any()
        np.testing.assert_array_equal(got["v"][lazy], v0.numpy()[lazy])
        np.testing.assert_array_equal(want["v"][lazy], v0.numpy()[lazy])
        np.testing.assert_array_equal(got["n"] == 0, lazy)


def test_fused_product_step_equals_two_pass():
    _, tcfg, _, ts = _both_states(_pairs())
    fused_cfg = override(tcfg, **{"optim.fused_scatter": "on"})
    model, opt = get_model("mvm")(tcfg), get_optimizer("ftrl")
    fused, two = make_train_step(model, opt, fused_cfg), make_train_step(model, opt, tcfg)
    a = b = ts
    for i in range(3):
        batch = to_device(batch_arrays(_sparse_batch(10 + i), tcfg), "cpu")
        a, ma = fused(a, batch)
        b, mb = two(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for name, x in _port_leaves(a).items():
        np.testing.assert_array_equal(x, _port_leaves(b)[name], err_msg=name)


def test_nonfinite_step_is_skipped():
    _, tcfg, _, ts = _both_states(_pairs(**{"model.mvm_exclusive": "off"}))
    step = make_train_step(get_model("mvm")(tcfg), get_optimizer("ftrl"), tcfg)
    new, m = step(ts, to_device(batch_arrays(_sparse_batch(20, nan_label=True), tcfg), "cpu"))
    assert not m["update_ok"] and not np.isfinite(float(m["loss"]))
    assert new.step == ts.step + 1
    assert new.tables["v"] is ts.tables["v"]
    assert new.opt_state["v"]["n"] is ts.opt_state["v"]["n"]


def test_step_routing_rules():
    tcfg = override(Config(), **_pairs())
    batch = _sparse_batch(30, dup_rows=3)
    arrays = batch_arrays(batch, tcfg)  # auto: a repeated field takes the segment side
    assert "sorted_fields" in arrays and arrays["sorted_slots"].ndim == 1
    with pytest.raises(ValueError, match="mvm_exclusive=off"):
        batch_arrays(batch, override(tcfg, **{"model.mvm_exclusive": "on"}))
    on = override(tcfg, **{"optim.fused_scatter": "on"})
    _, _, _, ts = _both_states(_pairs())
    step = make_train_step(get_model("mvm")(on), get_optimizer("ftrl"), on)
    with pytest.raises(ValueError, match="no flat fields-free sorted plan"):
        step(ts, to_device(arrays, "cpu"))
    stacked = override(on, **{"data.sorted_sub_batches": 2})
    with pytest.raises(ValueError, match="stacked sub-batch plans"):
        step(ts, to_device(batch_arrays(_sparse_batch(31), stacked), "cpu"))
    sgd = override(on, **{"optim.name": "sgd"})
    with pytest.raises(ValueError, match="fused_scatter=on requires"):
        make_train_step(get_model("mvm")(sgd), get_optimizer("sgd"), sgd)
    from xflow_tpu_torch.train.step import _fused_scatter_eligible

    assert not _fused_scatter_eligible(tcfg)  # auto does not fuse MVM
    with pytest.raises(ValueError, match="ffm is not ported"):
        _fused_scatter_eligible(override(tcfg, **{"model.name": "ffm"}))
    bad = _sparse_batch(32)
    bad.fields[0, 0] = NF
    with pytest.raises(ValueError, match="model.num_fields"):
        batch_arrays(bad, tcfg)


# ------------------------------------------------------------------- fit

def _mixed_shard(path):
    """200 libffm rows over 8 fields: batches 0 and 2 clean (one feature a
    field), batches 1 and 3 with rows that repeat a field."""
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for r in range(ROWS):
            n = int(rng.integers(4, NNZ + 1))
            fg = rng.permutation(NF)[:n]
            if (r // B) % 2 == 1 and r % 3 == 0:
                fg[-1] = fg[0]
            toks = " ".join(f"{g}:{g * 30 + int(rng.integers(0, 30))}:1" for g in fg)
            f.write(f"{int(rng.random() < 0.4)}\t{toks}\n")
    return path


SHARDS = {
    "synthetic_product": {},
    "synthetic_segment_stacked": {"model.mvm_exclusive": "off", "data.sorted_sub_batches": 2,
                                  "model.mvm_plus_one": True},
    "mixed_auto": {"model.mvm_plus_one": True},
}


def _recording(step, losses, routes):
    def wrapped(state, batch):
        new, m = step(state, batch)
        losses.append(float(m["loss"]))
        routes.append("sorted_fields" in batch)
        return new, m

    return wrapped


def _run_fit(work, name):
    extra = SHARDS[name]
    if name == "mixed_auto":
        path = _mixed_shard(str(work / "train-00000"))
    else:
        (path,) = jgenerate_shards(str(work / "train"), 1, ROWS, num_fields=NF,
                                   ids_per_field=40, seed=5)
    jck, tck = work / "jck", work / "tck"
    common = _pairs(**{"data.train_path": str(work / "train"), "train.epochs": 2}, **extra)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_NATIVE_PLAN", None)
        mp.setenv("XFLOW_NO_NATIVE_PLAN", "1")
        jt = JTrainer(joverride(JConfig(), **common, **{
            "train.checkpoint_dir": str(jck), "train.pred_dump": False,
            "data.use_native_parser": False,
        }))
        assert jt._sorted
        jt.save_checkpoint()  # the shared initial state, step 0
        shutil.copytree(jck / "step_0", tck / "step_0")
        tt = Trainer(override(Config(), **common, **{"train.checkpoint_dir": str(tck)}),
                     device="cpu")
        assert tt.sorted and tt.maybe_restore() and tt.state.step == 0
        jl, tl, jr, tr = [], [], [], []
        jt.train_step = _recording(jt.train_step, jl, jr)
        tt.train_step = _recording(tt.train_step, tl, tr)
        jres, tres = jt.fit(), tt.fit()
        jeval = jt.evaluate(test_path=path, dump=False)
    return {"path": path, "jck": jck, "tck": tck, "jt": jt, "tt": tt, "jres": jres,
            "tres": tres, "jl": jl, "tl": tl, "jr": jr, "tr": tr, "jeval": jeval,
            "common": common, "name": name}


@pytest.fixture(scope="module", params=sorted(SHARDS))
def fit_case(request, tmp_path_factory):
    return _run_fit(tmp_path_factory.mktemp(f"mvm_fit_{request.param}"), request.param)


def test_fit_matches_jax_step_for_step(fit_case):
    j, t = fit_case["jl"], fit_case["tl"]
    assert len(t) == len(j) == 8  # 2 epochs x 4 batches
    np.testing.assert_allclose(t, j, rtol=FIT_LOSS_RTOL)
    assert fit_case["tr"] == fit_case["jr"]  # the same row side, batch by batch
    assert set(fit_case["tr"]) == {
        "synthetic_product": {False}, "synthetic_segment_stacked": {True},
        "mixed_auto": {False, True},
    }[fit_case["name"]]
    jres, tres = fit_case["jres"], fit_case["tres"]
    assert (tres.steps, tres.epochs, tres.examples, tres.bad_steps) == (
        jres.steps, jres.epochs, jres.examples, jres.bad_steps) == (8, 2, 2 * ROWS, 0)
    assert tres.occupancy == pytest.approx(jres.occupancy)
    got, want = _port_leaves(fit_case["tt"].state), _jax_leaves(fit_case["jt"].state)
    for name in ("v", "n", "z"):
        _close(got[name], want[name])
        _close_scaled(got[name], want[name])
    auc, ll = fit_case["tt"].evaluate(fit_case["path"])
    jauc, jll = fit_case["jeval"]
    assert abs(auc - jauc) <= 1e-3
    assert abs(ll - jll) <= 1e-5 * abs(jll)


def test_mixed_shard_takes_both_row_sides(tmp_path):
    path = _mixed_shard(str(tmp_path / "m-00000"))
    cfg = override(Config(), **_pairs())
    sides = {"sorted_fields" in batch_arrays(b, cfg) for b in iter_batches(path, cfg.data)}
    assert sides == {True, False}


def test_checkpoints_cross_restore(fit_case):
    jt, tt = fit_case["jt"], fit_case["tt"]
    assert tckpt.committed_steps(str(fit_case["tck"])) == [8, 0]
    state = jckpt.restore(str(fit_case["tck"]), jt.state)  # JAX reads the port's
    assert np.asarray(state.tables["v"]).shape == (S // 8, 8 * V)  # JAX's packed layout
    got, want = _jax_leaves(state), _port_leaves(tt.state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert int(state.step) == 8
    cfg = override(Config(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["jck"])})
    t = Trainer(cfg, device="cpu")  # the port reads JAX's
    assert t.maybe_restore() and t.state.step == 8
    got, want = _port_leaves(t.state), _jax_leaves(fit_case["jt"].state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


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
    with open(tmp_path / "b" / "step_2" / tckpt.DATA_STATE_FILE) as f:
        assert json.load(f)["shard_batches"] == {"0": 2}
    resumed = Trainer(cfg_b, device="cpu")
    assert resumed.maybe_restore() and resumed.state.step == 2
    assert resumed.fit().steps == 6 and resumed.state.step == whole.state.step == 8
    for name, x in _port_leaves(resumed.state).items():
        np.testing.assert_array_equal(x, _port_leaves(whole.state)[name], err_msg=name)


def test_serve_matches_evaluate_and_jax(fit_case):
    cfg = override(Config(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["tck"]), "serve.max_batch": 32})
    runner = ServeRunner(cfg, device="cpu")
    gen = runner.load()
    assert gen.step == 8
    pctrs = np.concatenate([
        p[b.row_mask > 0] for b, p in predict_batches(cfg, gen.tables, fit_case["path"], "cpu")
    ])
    rows = [line.split("\t", 1)[1].strip()
            for line in open(fit_case["path"]).read().splitlines()[:80]]
    got, served = runner.predict_rows(rows)
    assert served is gen
    np.testing.assert_allclose(got, pctrs[:80], atol=1e-5, rtol=0)
    jcfg = joverride(JConfig(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["tck"]), "serve.max_batch": 32})
    jrunner = JServeRunner(jcfg)
    jrunner.load()
    want, _ = jrunner.predict_rows(rows)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


# -------------------------------------------------------------- denormals

def test_plain_form_denormal_gradient_differs_between_packages():
    """At the full MVM width (18 fields) and the default init scale 1e-2
    the product of a row's other 17 factors is about 1e-34, and times a
    loss cotangent of 1e-5 the gradient is about 1e-39: a float32
    denormal. XLA flushes it to 0 (so the JAX trainer's lazy-init guard
    keeps v); torch on the CPU, like the card, keeps it (so FTRL moves
    v). A difference of the packages, not a fault of the port: the JAX
    parity tests of the plain form stay in the normal range."""
    nf = 18
    rng = np.random.default_rng(40)
    occ = (rng.choice([-1.0, 1.0], size=(1, nf)) * 1e-2).astype(np.float32)
    occ = np.concatenate([occ, np.zeros((1, tst.CHUNK - nf), np.float32)], axis=1)
    mask = np.zeros(tst.CHUNK, np.float32)
    mask[:nf] = 1.0
    rows = np.zeros(tst.CHUNK, np.int32)
    dP = np.full((1, 1), 1e-5, np.float32)
    jop = jmvm.make_row_products(lambda st_, r: jst.row_sums_sorted(st_, r, 1), lambda a: a, 1)
    _, vjp = jax.vjp(lambda o: jop(o, jnp.asarray(mask), jnp.asarray(rows)), jnp.asarray(occ))
    jg = np.asarray(vjp(jnp.asarray(dP))[0])[0, :nf]
    tocc = torch.from_numpy(occ).requires_grad_(True)
    tmvm.row_products(tocc, torch.from_numpy(mask), torch.from_numpy(rows), 1, 1).backward(
        torch.from_numpy(dP))
    tg = tocc.grad.numpy()[0, :nf]
    tiny = np.finfo(np.float32).tiny
    assert (jg == 0).all()  # flushed
    assert (tg != 0).all() and (np.abs(tg) < tiny).all()  # kept, denormal
    np.testing.assert_allclose(np.abs(tg), 1e-5 * 1e-34, rtol=1e-2)
