"""PyTorch port, FM forward and metrics (xflow_tpu_torch/models, metrics.py)
held against the JAX package on the same numpy tables and batches.

`predict_fn` is compared on row-major and sorted-plan batches, for the
three FM variants (standard with and without the 1/2, reference-coupled)
and for the fused `wv` and two-table layouts: pctr within atol 1e-6,
logits within rtol 1e-5 (the two frameworks sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu import metrics as jmetrics
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.models.predict import predict_fn as jpredict_fn
from xflow_tpu_torch import metrics as tmetrics
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.evaluate import to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models.predict import predict_fn
from xflow_tpu_torch.weights import tables_from_jax

LOG2_S, B, F, V = 14, 64, 8, 4
S = 1 << LOG2_S

VARIANTS = {
    "standard_half": {"model.fm_standard": True, "model.fm_half": True},
    "standard_full": {"model.fm_standard": True, "model.fm_half": False},
    "reference_coupled": {"model.fm_standard": False},
}


def _pairs(variant, fused):
    base = {
        "model.name": "fm", "model.v_dim": V, "model.num_fields": F,
        "model.fm_fused": fused, "data.log2_slots": LOG2_S,
        "data.batch_size": B, "data.max_nnz": F,
    }
    base.update(VARIANTS[variant])
    return base


def _tables(fused, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(S,)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(S, V)) * 0.3).astype(np.float32)
    if fused:
        return {"wv": np.concatenate([w[:, None], v], axis=1)}
    return {"w": w, "v": v}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:3] = slots[3:6]
    mask = (rng.random((B, F)) < 0.8).astype(np.float32)
    mask[-4:] = 0.0  # padded rows
    labels = (rng.random(B) < 0.3).astype(np.float32)
    return {
        "slots": slots,
        "fields": np.tile(np.arange(F, dtype=np.int32), (B, 1)),
        "mask": mask,
        "labels": labels,
        "row_mask": (mask.sum(1) > 0).astype(np.float32),
    }


def _sorted(batch, monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")
    plan = jst.plan_sorted_batch(batch["slots"], batch["mask"], S)
    monkeypatch.delenv("XFLOW_NO_NATIVE_PLAN")
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    arrays = {
        "labels": batch["labels"], "row_mask": batch["row_mask"],
        "sorted_slots": plan.sorted_slots, "sorted_row": plan.sorted_row,
        "sorted_mask": plan.sorted_mask, "win_off": plan.win_off,
    }
    return jst.compact_plan_wire(arrays, rows_bound=B)


def _both(variant, fused, arrays, packed=False):
    jcfg = joverride(JConfig(), **_pairs(variant, fused))
    tcfg = override(Config(), **_pairs(variant, fused))
    host = _tables(fused)
    jtables = {k: jnp.asarray(t) for k, t in host.items()}
    if packed:
        jtables = {k: jst.pack_table(t) if t.ndim == 2 else t for k, t in jtables.items()}
    jmodel = jget_model("fm")
    jb = {k: jnp.asarray(a) for k, a in arrays.items()}
    want_logits = np.asarray(jmodel.forward(jtables, jb, jcfg))
    want_p = np.asarray(jpredict_fn(jtables, jb, jmodel, jcfg))

    ttables = tables_from_jax({k: np.asarray(t) for k, t in jtables.items()}, tcfg, "cpu")
    model = get_model("fm")(tcfg)
    tb = to_device(arrays, "cpu")
    with torch.no_grad():
        got_logits = model(ttables, tb).numpy()
    got_p = predict_fn(ttables, tb, model).numpy()
    return got_logits, want_logits, got_p, want_p


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fused", [True, False])
def test_predict_row_major_matches_jax(variant, fused):
    got_l, want_l, got_p, want_p = _both(variant, fused, _batch())
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("packed", [False, True])
def test_predict_sorted_plan_matches_jax(variant, packed, monkeypatch):
    arrays = _sorted(_batch(), monkeypatch)
    got_l, want_l, got_p, want_p = _both(variant, True, arrays, packed=packed)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)


def test_sorted_and_row_major_agree_in_the_port(monkeypatch):
    batch = _batch(seed=5)
    cfg = override(Config(), **_pairs("standard_half", True))
    tables = tables_from_jax(_tables(True), cfg, "cpu")
    model = get_model("fm")(cfg)
    rm = predict_fn(tables, to_device(batch, "cpu"), model).numpy()
    so = predict_fn(tables, to_device(_sorted(batch, monkeypatch), "cpu"), model).numpy()
    np.testing.assert_allclose(so, rm, atol=1e-6, rtol=0)


def test_reference_pctr_clamps_match_jax():
    logits = np.array([-100.0, -30.5, -30.0, -3.0, 0.0, 2.5, 30.0, 30.5, 1e4], np.float32)
    want = np.asarray(jmetrics.reference_pctr(jnp.asarray(logits)))
    got = tmetrics.reference_pctr(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(1e-6) and got[-1] == 1.0


@pytest.mark.parametrize("log2", [False, True])
def test_auc_logloss_matches_jax(log2):
    rng = np.random.default_rng(3)
    p = rng.random(500).astype(np.float32)
    p[:50] = p[50:100]  # ties
    y = (rng.random(500) < p).astype(np.float32)
    assert tmetrics.auc_logloss(p, y, log2) == jmetrics.auc_logloss(p, y, log2)
    assert np.isnan(tmetrics.auc_logloss(p, np.ones_like(y))[0])


def test_bucket_auc_matches_jax():
    rng = np.random.default_rng(4)
    t, j = tmetrics.BucketAUC.init(256), jmetrics.BucketAUC.init(256)
    for _ in range(3):
        p = rng.random(300)
        y = (rng.random(300) < p).astype(np.float64)
        t, j = t.update(p, y), j.update(p, y)
    np.testing.assert_array_equal(t.pos, j.pos)
    np.testing.assert_array_equal(t.neg, j.neg)
    assert t.compute() == j.compute()


def test_init_tables_from_generator():
    cfg = override(Config(), **_pairs("standard_half", True))
    model = get_model("fm")(cfg)
    a = model.init_tables(torch.Generator().manual_seed(0), device="cpu")
    b = model.init_tables(torch.Generator().manual_seed(0), device="cpu")
    assert tuple(a["wv"].shape) == (S, 1 + V)
    assert torch.equal(a["wv"], b["wv"])
    assert torch.all(a["wv"][:, 0] == 0) and a["wv"][:, 1:].std() > 0
    two = get_model("fm")(override(cfg, **{"model.fm_fused": False}))
    t = two.init_tables(torch.Generator().manual_seed(0), device="cpu")
    assert tuple(t["w"].shape) == (S,) and torch.all(t["w"] == 0)
    assert tuple(t["v"].shape) == (S, V)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("nosuch")
