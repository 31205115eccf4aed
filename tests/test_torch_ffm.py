"""PyTorch port, single-device FFM held against the JAX package
(`xflow_tpu/models/ffm.py`), on the same seeded numpy inputs:

- the row-major forward against the JAX `forward` and the brute-force
  pair oracle of `tests/test_ffm.py`, with repeated fields and masks;
- the aligned hybrid: `ffm_invperm` against the JAX one (its real fields)
  and its raise on a duplicate; the logits and the occurrence cotangent
  against `jax.vjp` of `ffm_aligned_logits`, with the cotangent exactly 0
  at single-occupant self pairs and towards absent fields in both;
- 3 train steps against the JAX `make_train_step` from the same state
  (`state_from_jax`, JAX `packed_tables` off and auto): fused FTRL,
  two-pass FTRL and SGD, tolerances as in `tests/test_ffm.py` (loss rtol
  2e-5; w, n, z rtol 2e-4 over atol 1e-6); untouched slots bitwise
  initial;
- routing (aligned, repeated-field and forced-`on` batches, a field out
  of range, a sorted batch without a placement) and its counter;
- `Trainer.fit` against the JAX trainer on a shard whose batches mix
  aligned rows and rows that repeat a field; checkpoints across the two
  packages both ways (packed and logical `wv`); `ServeRunner.predict_rows`
  against the port's evaluate and the JAX serve runner;
- `train` / `evaluate --model ffm --device cpu` through the CLI with `jax`
  and `xflow_tpu` blocked.

Small shapes: 5 fields, k = 3, S = 2^12 (2^14 for the shards), B 16-64.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.models.ffm as jffm
import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.serve.runner import ServeRunner as JServeRunner
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.state import TrainState as JTrainState
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu.train.step import make_train_step as jmake_train_step
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.schema import SparseBatch
from xflow_tpu_torch.evaluate import batch_arrays, predict_batches, to_device
from xflow_tpu_torch.models import ffm as tffm
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.serve.runner import ServeRunner
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.train.trainer import Trainer
from xflow_tpu_torch.weights import state_from_jax

from tests.test_ffm import oracle_logits

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, V, LOG2_S = 5, 3, 12
S, K = 1 << LOG2_S, 1 + NF * V
LOSS_RTOL = 2e-5
STATE_RTOL, STATE_ATOL = 2e-4, 1e-6


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _pairs(**extra):
    return {"model.name": "ffm", "model.v_dim": V, "model.num_fields": NF,
            "data.log2_slots": LOG2_S, "data.max_nnz": NF, **extra}


def _rand_batch(rng, B=32, F=7):
    """tests/test_ffm.py's batch: random fields (repeats happen), masks."""
    return {
        "slots": rng.integers(0, S, (B, F)).astype(np.int32),
        "fields": rng.integers(0, NF, (B, F)).astype(np.int32),
        "mask": (rng.random((B, F)) < 0.8).astype(np.float32),
        "labels": (rng.random(B) < 0.4).astype(np.float32),
        "row_mask": np.ones((B,), np.float32),
    }


def _aligned_batch(rng, B=64, dup_rows=0):
    """One occurrence per field (columns == fields), a random subset masked;
    the first `dup_rows` rows repeat field 0 in column 1, unmasked."""
    fields = np.broadcast_to(np.arange(NF, dtype=np.int32), (B, NF)).copy()
    mask = (rng.random((B, NF)) < 0.7).astype(np.float32)
    fields[:dup_rows, 1] = 0
    mask[:dup_rows, :2] = 1.0
    return SparseBatch(
        slots=rng.integers(0, S, (B, NF)).astype(np.int32), fields=fields, mask=mask,
        labels=(rng.random(B) < 0.4).astype(np.float32), row_mask=np.ones((B,), np.float32),
    )


def _jax_arrays(arrays: dict) -> dict:
    """The port's host arrays for the JAX step: its own [B * nfp] placement
    in place of the port's [B, nf] one."""
    out = {k: jnp.asarray(v) for k, v in arrays.items() if k != "ffm_invperm"}
    if "ffm_invperm" in arrays:
        out["ffm_invperm"] = jnp.asarray(jffm.ffm_invperm(
            arrays["sorted_row"], arrays["sorted_fields"], arrays["sorted_mask"],
            arrays["labels"].shape[0], NF))
    return out


# ------------------------------------------------------------------ forward

def test_row_major_forward_matches_jax_and_pair_oracle():
    rng = np.random.default_rng(0)
    batch = _rand_batch(rng)
    assert tffm.has_field_duplicates(batch["fields"], batch["mask"])
    wv = rng.normal(0, 1, (S, K)).astype(np.float32)
    want = np.asarray(jget_model("ffm").forward(
        {"wv": jnp.asarray(wv)}, {k: jnp.asarray(v) for k, v in batch.items()},
        joverride(JConfig(), **_pairs())))
    model = get_model("ffm")(override(Config(), **_pairs()))
    got = model({"wv": torch.from_numpy(wv)},
                {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle_logits(wv, batch), rtol=1e-5, atol=1e-5)
    # the host-deduped two-level gather gives the same logits
    u, inv = tst.dedup_slots(batch["slots"], batch["slots"].size)
    deduped = {k: torch.from_numpy(v) for k, v in batch.items() if k != "slots"}
    deduped.update(unique_slots=torch.from_numpy(u), inverse=torch.from_numpy(inv))
    assert torch.equal(model({"wv": torch.from_numpy(wv)}, deduped), torch.from_numpy(got))


def test_block_transpose_perm_matches_jax():
    for nf, k in ((5, 3), (18, 4), (1, 2)):
        got = tffm.block_transpose_perm(nf, k).numpy()
        np.testing.assert_array_equal(got, np.asarray(jffm.block_transpose_perm(nf, k)))
        np.testing.assert_array_equal(got[got], np.arange(nf * nf * k))  # an involution


# ------------------------------------------------------------ aligned hybrid

def _aligned_plan(seed, B=64):
    b = _aligned_batch(np.random.default_rng(seed), B)
    plan = tst.plan_sorted_plain(b.slots, b.mask, S, fields=b.fields)
    return b, plan


def test_invperm_matches_jax_and_raises_on_a_duplicate():
    b, plan = _aligned_plan(1)
    B = len(b.labels)
    got = tffm.ffm_invperm(plan.sorted_row, plan.sorted_fields, plan.sorted_mask, B, NF)
    want = jffm.ffm_invperm(plan.sorted_row, plan.sorted_fields, plan.sorted_mask, B, NF)
    nfp = jffm.nf_padded(NF)
    assert got.dtype == np.int32 and got.shape == (B, NF)
    np.testing.assert_array_equal(got, want.reshape(B, nfp)[:, :NF])
    assert (want.reshape(B, nfp)[:, NF:] == len(plan.sorted_slots) - 1).all()  # TPU padding
    dup = _aligned_batch(np.random.default_rng(1), dup_rows=1)
    p = tst.plan_sorted_plain(dup.slots, dup.mask, S, fields=dup.fields)
    for fn in (tffm.ffm_invperm, jffm.ffm_invperm):
        with pytest.raises(ValueError, match="duplicate"):
            fn(p.sorted_row, p.sorted_fields, p.sorted_mask, B, NF)


def test_aligned_logits_and_cotangent_match_jax_vjp_with_exact_zeros():
    b, plan = _aligned_plan(2)
    B = len(b.labels)
    rng = np.random.default_rng(3)
    wv = rng.normal(0, 1, (S, K)).astype(np.float32)
    occ = tst.gather_sorted_plain(torch.from_numpy(wv), torch.from_numpy(plan.sorted_slots))
    keys = ("sorted_slots", "sorted_row", "sorted_mask", "sorted_fields", "win_off")
    host = {"labels": b.labels, **{k: getattr(plan, k) for k in keys}}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
    tbatch["ffm_invperm"] = torch.from_numpy(
        tffm.ffm_invperm(plan.sorted_row, plan.sorted_fields, plan.sorted_mask, B, NF))
    jcfg, tcfg = joverride(JConfig(), **_pairs()), override(Config(), **_pairs())
    dl = rng.normal(size=B).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jbatch["ffm_invperm"] = jnp.asarray(
        jffm.ffm_invperm(plan.sorted_row, plan.sorted_fields, plan.sorted_mask, B, NF))
    want, vjp = jax.vjp(lambda o: jffm.ffm_aligned_logits(o, jbatch, jcfg),
                        jnp.asarray(occ.numpy()))
    (want_d,) = vjp(jnp.asarray(dl))
    want, want_d = np.asarray(want), np.asarray(want_d)
    o = occ.clone().requires_grad_(True)
    got = tffm.ffm_aligned_logits(o, tbatch, tcfg)
    got.backward(torch.from_numpy(dl))
    got_d = o.grad.numpy()
    # within 1e-6 of the logits' scale: the two sum ~80 float32 terms of
    # up to that size in different orders
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=1e-6)
    assert got_d.shape == (tst._k8(K), len(plan.sorted_slots)) and not got_d[K:].any()
    # exact zeros: each real occurrence's own block (its self pair) and the
    # blocks of the fields its row lacks
    present = np.zeros((B, NF), bool)
    real = plan.sorted_mask > 0
    present[plan.sorted_row[real], plan.sorted_fields[real]] = True
    n_self = n_absent = 0
    for p in np.nonzero(real)[0]:
        r, f = plan.sorted_row[p], plan.sorted_fields[p]
        for c in range(NF):
            if c == f or not present[r, c]:
                block = slice(1 + c * V, 1 + (c + 1) * V)
                assert (got_d[block, p] == 0).all() and (want_d[block, p] == 0).all()
                n_self += c == f
                n_absent += c != f
    assert n_self == real.sum() and n_absent > 0
    # and nowhere else: the cross blocks of present fields carry gradient
    assert np.count_nonzero(got_d[:K, real]) == np.count_nonzero(want_d[:K, real]) > 0


def test_sorted_batch_without_a_placement_raises():
    """A sorted batch without its placement no longer raises: it takes the
    per-(row, field) segment row side (the fully-sharded engine's), whose
    logits and gradient agree with the aligned hybrid's and with JAX's
    segment row side on the same table."""
    b, plan = _aligned_plan(4)
    tcfg = override(Config(), **_pairs())
    arrays = to_device(batch_arrays(b, tcfg), "cpu")
    seg = {k: v for k, v in arrays.items() if k != "ffm_invperm"}
    rng = np.random.default_rng(5)
    wv = (rng.standard_normal((S, K)) * 0.1).astype(np.float32)
    model = get_model("ffm")(tcfg)
    grads = []
    for batch in (arrays, seg):
        t = torch.from_numpy(wv.copy()).requires_grad_(True)
        logits = model({"wv": t}, batch)
        logits.sum().backward()
        grads.append((logits.detach().numpy(), t.grad.numpy()))
    np.testing.assert_allclose(grads[1][0], grads[0][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-6)
    jcfg = joverride(JConfig(), **_pairs())
    jbatch = {k: jnp.asarray(np.asarray(v)) for k, v in seg.items()}
    want = jffm._forward_sorted({"wv": jnp.asarray(wv)}, jbatch, jcfg)
    np.testing.assert_allclose(grads[1][0], np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- steps

VARIANTS = {
    "fused_ftrl": {},
    "two_pass_ftrl": {"optim.fused_scatter": "off"},
    "sgd": {"optim.name": "sgd", "optim.v_init_sgd": 0.1, "optim.sgd.lr": 0.5},
}


def _both_states(pairs, packed):
    jcfg = joverride(JConfig(), **pairs, **{"data.packed_tables": packed})
    tcfg = override(Config(), **pairs)
    js = jinit_state(jget_model("ffm"), jget_optimizer(jcfg.optim.name), jcfg)
    ts = state_from_jax(
        {k: np.asarray(a) for k, a in js.tables.items()},
        {k: {leaf: np.asarray(a) for leaf, a in d.items()} for k, d in js.opt_state.items()},
        js.step, tcfg, device="cpu",
    )
    return jcfg, tcfg, js, ts


def _leaves(tables, opt):
    out = {"wv": np.asarray(tables["wv"]).reshape(-1, K)}
    out.update({k: np.asarray(a).reshape(-1, K) for k, a in opt.get("wv", {}).items()})
    return out


def _port_leaves(state):
    return _leaves({k: t.numpy() for k, t in state.tables.items()},
                   {k: {leaf: a.numpy() for leaf, a in d.items()}
                    for k, d in state.opt_state.items()})


@pytest.mark.parametrize("packed", ["off", "auto"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_steps_match_jax(variant, packed):
    pairs = _pairs(**{"data.batch_size": 64}, **VARIANTS[variant])
    jcfg, tcfg, js, ts = _both_states(pairs, packed)
    w0 = ts.tables["wv"].clone()
    jstep = jmake_train_step(jget_model("ffm"), jget_optimizer(jcfg.optim.name), jcfg,
                             jit=False)
    tstep = make_train_step(get_model("ffm")(tcfg), get_optimizer(tcfg.optim.name), tcfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        arrays = batch_arrays(_aligned_batch(rng), tcfg)
        assert arrays["sorted_slots"].ndim == 1 and "ffm_invperm" in arrays
        js, jm = jstep(js, _jax_arrays(arrays))
        ts, tm = tstep(ts, to_device(arrays, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got, want = _port_leaves(ts), _leaves(js.tables, js.opt_state)
    assert got.keys() == want.keys() == ({"wv"} if variant == "sgd" else {"wv", "n", "z"})
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    assert not np.array_equal(got["wv"], w0.numpy())


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_untouched_slots_keep_their_initial_weights_bitwise(fused):
    pairs = _pairs(**{"data.batch_size": 32, "optim.fused_scatter": fused})
    _, tcfg, _, ts = _both_states(pairs, "off")
    w0 = ts.tables["wv"].clone()
    b = _aligned_batch(np.random.default_rng(11), B=32)
    step = make_train_step(get_model("ffm")(tcfg), get_optimizer("ftrl"), tcfg)
    state, _ = step(ts, to_device(batch_arrays(b, tcfg), "cpu"))
    w1 = state.tables["wv"]
    touched = np.zeros(S, bool)
    touched[np.unique(b.slots[b.mask > 0])] = True
    touched = torch.from_numpy(touched)
    assert torch.equal(w1[~touched], w0[~touched]), "untouched slots moved"
    assert not torch.equal(w1[touched], w0[touched])
    # and within touched rows, the blocks of fields a slot never met
    assert (state.opt_state["wv"]["n"][touched] == 0).any()


def test_fused_step_equals_two_pass():
    _, tcfg, _, ts = _both_states(_pairs(**{"data.batch_size": 64}), "off")
    model, opt = get_model("ffm")(tcfg), get_optimizer("ftrl")
    fused = make_train_step(model, opt, tcfg)
    two = make_train_step(model, opt, override(tcfg, **{"optim.fused_scatter": "off"}))
    a = b = ts
    rng = np.random.default_rng(12)
    for _ in range(2):
        batch = to_device(batch_arrays(_aligned_batch(rng), tcfg), "cpu")
        a, ma = fused(a, batch)
        b, mb = two(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for name, x in _port_leaves(a).items():
        np.testing.assert_array_equal(x, _port_leaves(b)[name], err_msg=name)


# ----------------------------------------------------------------- routing

def test_routing_of_aligned_duplicate_and_forced_batches():
    tcfg = override(Config(), **_pairs(**{"data.batch_size": 16,
                                          "data.sorted_sub_batches": 2}))
    rng = np.random.default_rng(3)
    tffm.reset_routes()
    arrays = batch_arrays(_aligned_batch(rng, B=16), tcfg)
    # flat, whatever sorted_sub_batches says: the placement spans the batch
    assert "ffm_invperm" in arrays and arrays["sorted_slots"].ndim == 1
    assert arrays["ffm_invperm"].shape == (16, NF)
    dup = _aligned_batch(rng, B=16, dup_rows=3)
    arrays_dup = batch_arrays(dup, tcfg)
    assert "sorted_slots" not in arrays_dup and "slots" in arrays_dup
    assert tffm.ROUTES == {"aligned": 1, "row_major": 1}
    with pytest.raises(ValueError, match="aligned"):
        batch_arrays(dup, override(tcfg, **{"data.sorted_layout": "on"}))
    off = batch_arrays(_aligned_batch(rng, B=16), override(tcfg, **{"data.sorted_layout": "off"}))
    assert "slots" in off and tffm.ROUTES == {"aligned": 1, "row_major": 1}  # not a fallback
    bad = _aligned_batch(rng, B=16)
    bad.fields[0, 0] = NF
    with pytest.raises(ValueError, match="model.num_fields"):
        batch_arrays(bad, tcfg)
    # the duplicate batch trains row-major under auto; fused_scatter=on refuses it
    _, _, _, ts = _both_states(_pairs(**{"data.batch_size": 16}), "off")
    on = override(tcfg, **{"optim.fused_scatter": "on"})
    step = make_train_step(get_model("ffm")(on), get_optimizer("ftrl"), on)
    with pytest.raises(ValueError, match="FFM batch routed row-major"):
        step(ts, to_device(arrays_dup, "cpu"))
    from xflow_tpu_torch.train.step import _fused_scatter_eligible

    assert _fused_scatter_eligible(tcfg)  # auto fuses FFM under FTRL
    assert not _fused_scatter_eligible(override(tcfg, **{"optim.name": "sgd"}))
    with pytest.raises(ValueError, match="fused_scatter=on requires"):
        _fused_scatter_eligible(override(on, **{"optim.name": "sgd"}))


def test_duplicate_batch_step_matches_jax_row_major():
    pairs = _pairs(**{"data.batch_size": 32})
    jcfg, tcfg, js, ts = _both_states(pairs, "auto")
    arrays = batch_arrays(_aligned_batch(np.random.default_rng(5), B=32, dup_rows=4), tcfg)
    assert "slots" in arrays
    jstep = jmake_train_step(jget_model("ffm"), jget_optimizer("ftrl"), jcfg, jit=False)
    js, jm = jstep(js, _jax_arrays(arrays))
    ts, tm = make_train_step(get_model("ffm")(tcfg), get_optimizer("ftrl"), tcfg)(
        ts, to_device(arrays, "cpu"))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got, want = _port_leaves(ts), _leaves(js.tables, js.opt_state)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=STATE_RTOL, atol=STATE_ATOL)


# --------------------------------------------------------- fit, checkpoints

FIT_LOG2, FIT_B, FIT_ROWS = 14, 64, 200


def _mixed_shard(path):
    """200 libffm rows over NF fields, one feature a field, except that
    batches 1 and 3 hold rows that repeat a field."""
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for r in range(FIT_ROWS):
            n = int(rng.integers(3, NF + 1))
            fg = rng.permutation(NF)[:n]
            if (r // FIT_B) % 2 == 1 and r % 3 == 0:
                fg[-1] = fg[0]
            toks = " ".join(f"{g}:{g * 30 + int(rng.integers(0, 30))}:1" for g in fg)
            f.write(f"{int(rng.random() < 0.4)}\t{toks}\n")
    return path


def _fit_pairs(work, **extra):
    return _pairs(**{"data.log2_slots": FIT_LOG2, "data.batch_size": FIT_B,
                     "data.train_path": str(work / "train"), "train.epochs": 2}, **extra)


def _recording(step, losses, routes):
    def wrapped(state, batch):
        new, m = step(state, batch)
        losses.append(float(m["loss"]))
        routes.append("sorted_slots" in batch)
        return new, m

    return wrapped


@pytest.fixture(scope="module")
def fit_case(tmp_path_factory):
    work = tmp_path_factory.mktemp("ffm_fit")
    path = _mixed_shard(str(work / "train-00000"))
    jck, tck = work / "jck", work / "tck"
    common = _fit_pairs(work)
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
        tffm.reset_routes()
        jres, tres = jt.fit(), tt.fit()
        routes = dict(tffm.ROUTES)
        jeval = jt.evaluate(test_path=path, dump=False)
    return {"path": path, "jck": jck, "tck": tck, "jt": jt, "tt": tt, "jres": jres,
            "tres": tres, "jl": jl, "tl": tl, "jr": jr, "tr": tr, "jeval": jeval,
            "common": common, "routes": routes}


def test_fit_matches_jax_step_for_step(fit_case):
    assert len(fit_case["tl"]) == len(fit_case["jl"]) == 8  # 2 epochs x 4 batches
    np.testing.assert_allclose(fit_case["tl"], fit_case["jl"], rtol=LOSS_RTOL)
    # the same route batch by batch: aligned batches 0 and 2, row-major 1 and 3
    assert fit_case["tr"] == fit_case["jr"] == [True, False, True, False] * 2
    assert fit_case["routes"] == {"aligned": 4, "row_major": 4}
    jres, tres = fit_case["jres"], fit_case["tres"]
    assert (tres.steps, tres.epochs, tres.examples, tres.bad_steps) == (
        jres.steps, jres.epochs, jres.examples, jres.bad_steps) == (8, 2, 2 * FIT_ROWS, 0)
    got = _port_leaves(fit_case["tt"].state)
    want = _leaves(fit_case["jt"].state.tables, fit_case["jt"].state.opt_state)
    for name in ("wv", "n", "z"):
        np.testing.assert_allclose(got[name], want[name], rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    auc, ll = fit_case["tt"].evaluate(fit_case["path"], dump=False)
    jauc, jll = fit_case["jeval"]
    assert abs(auc - jauc) <= 1e-3 and abs(ll - jll) <= 1e-5 * abs(jll)


def test_checkpoints_cross_restore(fit_case):
    jt, tt = fit_case["jt"], fit_case["tt"]
    assert tckpt.committed_steps(str(fit_case["tck"])) == [8, 0]
    state = jckpt.restore(str(fit_case["tck"]), jt.state)  # JAX reads the port's
    want = _port_leaves(tt.state)
    got = _leaves(state.tables, state.opt_state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert int(state.step) == 8
    t = Trainer(override(Config(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["jck"])}), device="cpu")  # the port reads JAX's
    assert t.maybe_restore() and t.state.step == 8
    want = _leaves(jt.state.tables, jt.state.opt_state)
    for name, x in _port_leaves(t.state).items():
        np.testing.assert_array_equal(x, want[name], err_msg=name)


@pytest.mark.parametrize("packed", [True, False])
def test_jax_written_wv_restores_packed_or_logical(tmp_path, packed):
    wv = np.random.default_rng(9).normal(size=(S, K)).astype(np.float32)
    table = jst.pack_table(jnp.asarray(wv)) if packed else jnp.asarray(wv)
    zeros = jnp.zeros_like(table)
    jckpt.save(str(tmp_path), JTrainState(
        tables={"wv": table}, opt_state={"wv": {"n": zeros, "z": zeros + 1.0}},
        step=jnp.asarray(4, jnp.int32)), logical_widths={"wv": K})
    t = Trainer(override(Config(), **_pairs(**{"train.checkpoint_dir": str(tmp_path)})),
                device="cpu")
    assert t.maybe_restore() and t.state.step == 4
    assert tuple(t.state.tables["wv"].shape) == (S, K)
    np.testing.assert_array_equal(t.state.tables["wv"].numpy(), wv)
    assert (t.state.opt_state["wv"]["z"] == 1.0).all()
    gen = ServeRunner(override(Config(), **_pairs(**{
        "train.checkpoint_dir": str(tmp_path)})), device="cpu").load()
    np.testing.assert_array_equal(gen.tables["wv"].numpy(), wv)


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
            for line in open(fit_case["path"]).read().splitlines()[:96]]
    got, served = runner.predict_rows(rows)
    assert served is gen
    np.testing.assert_allclose(got, pctrs[:96], atol=1e-5, rtol=0)
    jrunner = JServeRunner(joverride(JConfig(), **fit_case["common"], **{
        "train.checkpoint_dir": str(fit_case["tck"]), "serve.max_batch": 32}))
    jrunner.load()
    want, _ = jrunner.predict_rows(rows)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


# --------------------------------------------------------------------- CLI

_NO_JAX = "import sys\nsys.modules['jax'] = None\nsys.modules['xflow_tpu'] = None\n"


def test_cli_train_and_evaluate_ffm_without_jax(fit_case, tmp_path):
    code = (
        _NO_JAX
        + "import json\n"
        "from xflow_tpu_torch.__main__ import main\n"
        "from xflow_tpu_torch.models import ffm\n"
        "rc = main(sys.argv[1:])\n"
        "print(json.dumps(ffm.ROUTES))\n"
        "sys.exit(rc)\n"
    )
    prefix = fit_case["path"][: -len("-00000")]
    common = ("--model", "ffm", "--batch-size", str(FIT_B), "--log2-slots", str(FIT_LOG2),
              "--device", "cpu", "--set", f"model.v_dim={V}", "--set",
              f"model.num_fields={NF}", "--set", f"data.max_nnz={NF}")
    outs = []
    for argv in (("train", "--train", prefix, "--epochs", "2",
                  "--checkpoint-dir", str(tmp_path / "ck")),
                 ("evaluate", "--checkpoint-dir", str(tmp_path / "ck"),
                  "--test", fit_case["path"])):
        r = subprocess.run([sys.executable, "-c", code, *argv, *common], cwd=REPO_ROOT,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr
        lines = r.stdout.strip().splitlines()
        outs.append((json.loads(lines[-2]), json.loads(lines[-1])))
    (summary, routes), (ev, ev_routes) = outs
    assert (summary["steps"], summary["epochs"], summary["bad_steps"]) == (8, 2, 0)
    assert set(summary["occupancy"]) == {"wv"} and np.isfinite(summary["last_loss"])
    assert routes == {"aligned": 4, "row_major": 4}
    assert ev["step"] == 8 and 0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["logloss"])
    assert ev_routes == {"aligned": 2, "row_major": 2}
