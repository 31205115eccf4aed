"""PyTorch port, LR on the row-major path (the default model) held against
the JAX package:

- `Config()` names `model.name="lr"` in both packages, and the port's
  registry has it, with the JAX table spec (`w [S]`, zeros);
- `sorted_layout_on` keeps LR row-major under auto and raises under on,
  as the JAX trainer's rule does;
- `dedup_slots` gives the JAX package's (unique_slots, inverse) bit for
  bit, and `HostDedup` follows the JAX trainer's `_maybe_dedup` (the
  first batch decides; an unknown mode raises);
- the train step against `xflow_tpu.train.step.make_train_step(jit=False)`
  from the same zero state, three steps under FTRL and SGD, with
  `data.dedup` off and auto (the skewed batches fit the capacity, so the
  two-level gather runs): loss within 1e-5 relative, w, n and z within
  1e-3 relative over a 1e-4 floor (kernel_parity's FTRL class);
- a default `Config()` trains in the port (`Trainer.fit`, no override);
- `python -m xflow_tpu_torch train` with no `--model` against the JAX
  CLI with none, on one 200-row shard for 2 epochs, dedup off and auto:
  the per-step losses (1e-5), the final w, n and z, AUC and logloss of
  the port's `evaluate` command (no `--model` either), and each
  package's final checkpoint of table `w` restored by the other.
"""

import io
import json
from contextlib import redirect_stdout

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
from xflow_tpu_torch.__main__ import main as tmain
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.evaluate import HostDedup, batch_arrays, sorted_layout_on, to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops.sorted_table import dedup_slots
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.state import init_state
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.train.trainer import Trainer

LOG2_S, B, NNZ, NF = 14, 64, 8, 8
S = 1 << LOG2_S
ROWS = 200  # three full batches and a padded one
LOSS_RTOL = 1e-5
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4


def _pairs(**extra):
    return {"model.num_fields": NF, "data.log2_slots": LOG2_S, "data.batch_size": B,
            "data.max_nnz": NNZ, **extra}


def _close(got, want, rtol=FTRL_RTOL, floor=FTRL_FLOOR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / (np.abs(want) + floor)) <= rtol


def _batch(seed, pool=100):
    """A row-major batch whose slots come from `pool` slots of the table
    (skewed, so it fits the dedup capacity B * NNZ / 2), a few masked
    occurrences, five padded rows."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(S, pool, replace=False).astype(np.int32)
    slots = hot[rng.integers(0, pool, (B, NNZ))]
    mask = (rng.random((B, NNZ)) < 0.8).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    row_mask = np.ones(B, np.float32)
    row_mask[-5:] = 0.0
    mask[-5:] = 0.0
    fields = np.tile(np.arange(NNZ, dtype=np.int32), (B, 1))
    return {"slots": slots, "fields": fields, "mask": mask, "labels": labels,
            "row_mask": row_mask}


def test_default_config_is_lr_in_both_packages():
    assert Config().model.name == JConfig().model.name == "lr"
    model = get_model(Config().model.name)(Config())
    assert model.table_specs(Config()) == jget_model("lr").table_specs(JConfig()) == {"w": ()}
    tables = model.init_tables(torch.Generator().manual_seed(0), device="cpu")
    assert tuple(tables["w"].shape) == (Config().num_slots,) and not tables["w"].any()


def test_lr_takes_the_row_major_path():
    assert not sorted_layout_on(Config())
    with pytest.raises(ValueError, match="sorted_layout=on needs"):
        sorted_layout_on(override(Config(), **{"data.sorted_layout": "on"}))


@pytest.mark.parametrize("pool", [1, 100, 4000])
def test_dedup_slots_matches_jax(pool):
    slots = _batch(3, pool=pool)["slots"]
    cap = B * NNZ // 2
    got, want = dedup_slots(slots, cap), jst.dedup_slots(slots, cap)
    if pool == 4000:  # more uniques than the capacity: no dedup in either
        assert got is None and want is None
        return
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)
    u, inv = got
    assert u.shape == (cap,) and np.array_equal(u[inv], slots)


def test_host_dedup_first_batch_decides():
    cfg = override(Config(), **_pairs(**{"data.dedup": "auto"}))
    fits, overflows = _batch(0), _batch(1, pool=4000)
    d = HostDedup(cfg)
    assert d.cap == B * NNZ // 2
    out = d(dict(overflows))  # the first batch overflows: dedup stays off
    assert "slots" in out and "unique_slots" not in out and d.on is False
    assert "unique_slots" not in d(dict(fits))
    d = HostDedup(cfg)  # the first batch fits: later overflows ship row-major
    out = d(dict(fits))
    assert "slots" not in out and {"unique_slots", "inverse"} <= out.keys() and d.on
    assert "slots" in d(dict(overflows)) and d.on
    assert "unique_slots" not in HostDedup(override(cfg, **{"data.dedup": "off"}))(dict(fits))
    with pytest.raises(ValueError, match="expected auto\\|off"):
        HostDedup(override(cfg, **{"data.dedup": "on"}))


VARIANTS = {
    "ftrl": {},
    "ftrl_dedup": {"data.dedup": "auto"},
    "sgd": {"optim.name": "sgd"},
    "sgd_dedup": {"optim.name": "sgd", "data.dedup": "auto"},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_matches_jax(variant):
    pairs = _pairs(**VARIANTS[variant])
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    js = jinit_state(jget_model("lr"), jget_optimizer(jcfg.optim.name), jcfg)
    model, opt = get_model("lr")(tcfg), get_optimizer(tcfg.optim.name)
    ts = init_state(model, opt, tcfg, "cpu")
    assert np.array_equal(ts.tables["w"].numpy(), np.asarray(js.tables["w"]))
    jstep = jmake_train_step(jget_model("lr"), jget_optimizer(jcfg.optim.name), jcfg, jit=False)
    tstep = make_train_step(model, opt, tcfg)
    dedup = HostDedup(tcfg)
    for i in range(3):
        arrays = _batch(i)
        tarrays = dedup(dict(arrays))
        jarrays = dict(arrays)
        if jcfg.data.dedup == "auto":
            jarrays.pop("slots")
            jarrays["unique_slots"], jarrays["inverse"] = jst.dedup_slots(
                arrays["slots"], dedup.cap)
            assert tarrays.keys() == jarrays.keys()
        else:
            assert "unique_slots" not in tarrays
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in jarrays.items()})
        ts, tm = tstep(ts, to_device(tarrays, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        assert float(tm["rows"]) == float(jm["rows"]) == B - 5
    assert ts.step == int(js.step) == 3
    _close(ts.tables["w"].numpy(), np.asarray(js.tables["w"]))
    for leaf, t in ts.opt_state["w"].items():
        _close(t.numpy(), np.asarray(js.opt_state["w"][leaf]))
    assert np.abs(ts.tables["w"].numpy()).max() > 0  # the steps moved w


def test_default_config_trains(tmp_path):
    (path,) = jgenerate_shards(str(tmp_path / "train"), 1, ROWS, num_fields=NF,
                               ids_per_field=40, seed=5)
    t = Trainer(Config(), device="cpu")  # no override: LR, FTRL, 60 epochs of one batch
    assert not t.sorted and set(t.state.tables) == {"w"}
    res = t.fit(path)
    assert (res.steps, res.epochs, res.examples, res.bad_steps) == (60, 60, 60 * ROWS, 0)
    assert np.isfinite(res.last_loss) and 0.0 < res.occupancy["w"] < 1.0


def _run_cli(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tmain(list(argv))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _recording(step, losses):
    def wrapped(state, batch):
        new, m = step(state, batch)
        losses.append(float(m["loss"]))
        return new, m

    return wrapped


@pytest.fixture(scope="module", params=["off", "auto"])
def fit_case(request, tmp_path_factory):
    work = tmp_path_factory.mktemp(f"torch_lr_{request.param}")
    (path,) = jgenerate_shards(str(work / "train"), 1, ROWS, num_fields=NF,
                               ids_per_field=40, seed=5)
    prefix = str(work / "train")
    sets = [f"model.num_fields={NF}", f"data.max_nnz={NNZ}", f"data.dedup={request.param}",
            "data.dedup_cap_frac=1.0"]
    jck, tck = work / "jck", work / "tck"
    jcfg = joverride(JConfig(), **_pairs(**{
        "data.train_path": prefix, "train.epochs": 2, "train.checkpoint_dir": str(jck),
        "train.pred_dump": False, "data.use_native_parser": False,
        "data.dedup": request.param, "data.dedup_cap_frac": 1.0,
    }))
    jt = JTrainer(jcfg)
    jlosses = []
    jt.train_step = _recording(jt.train_step, jlosses)
    jres = jt.fit()
    jeval = jt.evaluate(test_path=path, dump=False)
    # the port's CLI with no --model, and its steps recorded
    tlosses = []
    real = Trainer.__init__

    def recording_init(self, *a, **k):
        real(self, *a, **k)
        self.train_step = _recording(self.train_step, tlosses)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "__init__", recording_init)
        summary = _run_cli(
            "train", "--train", prefix, "--epochs", "2", "--batch-size", str(B),
            "--log2-slots", str(LOG2_S), "--checkpoint-dir", str(tck), "--device", "cpu",
            *[a for s in sets for a in ("--set", s)])
    ev = _run_cli("evaluate", "--checkpoint-dir", str(tck), "--test", path, "--batch-size",
                  str(B), "--log2-slots", str(LOG2_S), "--device", "cpu",
                  *[a for s in sets for a in ("--set", s)])
    return {"mode": request.param, "path": path, "jck": jck, "tck": tck, "jt": jt,
            "jres": jres, "jeval": jeval, "jlosses": jlosses, "tlosses": tlosses,
            "summary": summary, "eval": ev, "jcfg": jcfg}


def test_cli_default_model_fit_matches_jax(fit_case):
    j, t = fit_case["jlosses"], fit_case["tlosses"]
    assert len(t) == len(j) == 8  # 2 epochs x 4 batches
    np.testing.assert_allclose(t, j, rtol=LOSS_RTOL)
    s, jres = fit_case["summary"], fit_case["jres"]
    assert (s["steps"], s["epochs"], s["examples"], s["bad_steps"]) == (
        jres.steps, jres.epochs, jres.examples, jres.bad_steps) == (8, 2, 2 * ROWS, 0)
    assert s["occupancy"] == pytest.approx(jres.occupancy) and set(s["occupancy"]) == {"w"}
    if fit_case["mode"] == "auto":  # the skew-free shard still fits a capacity of B * NNZ
        assert fit_case["jt"]._dedup_on is True


def test_cli_default_model_state_and_evaluate_match_jax(fit_case):
    tables, opt, step, _ = tckpt.restore_state(str(fit_case["tck"]), {"w": (S,)}, ("n", "z"))
    assert step == 8
    jstate = fit_case["jt"].state
    _close(tables["w"], np.asarray(jstate.tables["w"]))
    for leaf in ("n", "z"):
        _close(opt["w"][leaf], np.asarray(jstate.opt_state["w"][leaf]))
    ev, (jauc, jll) = fit_case["eval"], fit_case["jeval"]
    assert ev["step"] == 8 and abs(ev["auc"] - jauc) <= 1e-3 and ev["auc"] > 0.5
    assert abs(ev["logloss"] - jll) <= 1e-5 * abs(jll)


def test_lr_checkpoints_restore_across_packages(fit_case):
    jt = fit_case["jt"]
    # the port's checkpoint in the JAX package
    state = jckpt.restore(str(fit_case["tck"]), jt.state)
    tables, opt, _, _ = tckpt.restore_state(str(fit_case["tck"]), {"w": (S,)}, ("n", "z"))
    np.testing.assert_array_equal(np.asarray(state.tables["w"]), tables["w"])
    np.testing.assert_array_equal(np.asarray(state.opt_state["w"]["z"]), opt["w"]["z"])
    assert int(state.step) == 8
    # the JAX package's checkpoint in the port
    cfg = override(Config(), **_pairs(**{"train.checkpoint_dir": str(fit_case["jck"])}))
    t = Trainer(cfg, device="cpu")
    assert t.maybe_restore() and t.state.step == int(jt.state.step) == 8
    np.testing.assert_array_equal(t.state.tables["w"].numpy(), np.asarray(jt.state.tables["w"]))
    for leaf in ("n", "z"):
        np.testing.assert_array_equal(t.state.opt_state["w"][leaf].numpy(),
                                      np.asarray(jt.state.opt_state["w"][leaf]))


def test_batch_arrays_dedups_only_row_major_batches(fit_case):
    from xflow_tpu_torch.data.pipeline import batch_iterator

    cfg = override(Config(), **_pairs(**{"data.dedup": "auto", "data.dedup_cap_frac": 1.0}))
    batch = next(batch_iterator(fit_case["path"], cfg.data))
    arrays = batch_arrays(batch, cfg, HostDedup(cfg))
    assert {"unique_slots", "inverse"} <= arrays.keys() and "slots" not in arrays
    fm = override(cfg, **{"model.name": "fm", "model.v_dim": 4})
    assert "sorted_slots" in batch_arrays(batch, fm, HostDedup(fm))
    model = get_model("lr")(cfg)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=S).astype(np.float32))
    direct = model({"w": w}, to_device(batch_arrays(batch, cfg), "cpu"))
    deduped = model({"w": w}, to_device(arrays, "cpu"))
    assert torch.equal(direct, deduped)
