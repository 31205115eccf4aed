"""PyTorch port, the MVM model (xflow_tpu_torch/models/mvm.py) held
against `xflow_tpu.models.mvm` on the same numpy inputs:

- the routing helpers (`has_field_duplicates`, `resolve_mvm_product`)
  and their errors, equal;
- `mvm_product_channels`: counts bitwise, ln within 1e-6 relative;
- the product op (JAX `make_row_products` with `row_sums_sorted`),
  forward and the hand-written backward, plus 0 and 1, on rows that hold
  an exact-zero v entry: values within 1e-5 relative over a 1e-6 floor
  and the gradient's zero pattern bitwise equal;
- `segment_sum_channels`, forward and backward;
- the segment row side, forward and gradient, zero pattern included,
  plus 0 and 1;
- the full forward against JAX `forward` on four layouts (sorted
  product, sorted segment flat and stacked NS = 4, row-major): 1e-5
  relative over a 1e-6 floor;
- FM with data.sorted_sub_batches = 2 against FM at NS = 1 and JAX's FM.

Cases of the plain form (plus 0) keep every gradient in float32's normal
range (8 fields, factors of size 0.3): XLA flushes denormal results to
0, torch on the CPU keeps them, see `test_torch_mvm_train.py`.
Small shapes: S = 2^14, B = 64 rows of 8 occurrences, v_dim = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.models.mvm as jmvm
import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model as jget_model
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models import mvm as tmvm
from xflow_tpu_torch.ops import sorted_table as tst

S = 1 << 14
B, F, NF, V = 64, 8, 8, 4
RTOL, FLOOR = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, floor=FLOOR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / (np.abs(want) + floor)
    assert err.max() <= rtol, err.max()


def _same_zeros(got, want):
    np.testing.assert_array_equal(np.asarray(got) == 0, np.asarray(want) == 0)


def _pairs(**extra):
    return {"model.name": "mvm", "model.v_dim": V, "model.num_fields": NF,
            "data.log2_slots": 14, "data.batch_size": B, "data.max_nnz": F, **extra}


def _batch(seed, dup=False):
    """[B, F] slots, fields, mask. Without `dup` every row holds each field
    at most once (a permutation of 0..7); with it, fields repeat."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:3] = slots[40:43]  # slots shared across sub-batches
    if dup:
        fields = rng.integers(0, NF, (B, F)).astype(np.int32)
    else:
        fields = np.stack([rng.permutation(NF)[:F] for _ in range(B)]).astype(np.int32)
    mask = (rng.random((B, F)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-4:] = 0.0  # padded rows
    return slots, fields, mask


def _table(seed, scale=0.3, zero_rows=()):
    v = (np.random.default_rng(seed).normal(size=(S, V)) * scale).astype(np.float32)
    for s, c in zero_rows:
        v[s, c] = 0.0
    return v


# ---------------------------------------------------------------- routing

def test_has_field_duplicates_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(8):
        _, fields, mask = _batch(seed, dup=seed % 2 == 1)
        assert tmvm.has_field_duplicates(fields, mask) == jmvm.has_field_duplicates(fields, mask)
    wide = rng.integers(0, 200, (16, 6)).astype(np.int32)  # ids past 64: the sort path
    wide[3, 1] = wide[3, 4]
    m = np.ones_like(wide, np.float32)
    assert tmvm.has_field_duplicates(wide, m) is jmvm.has_field_duplicates(wide, m) is True
    m[3, 4] = 0.0  # a masked repeat is no repeat
    wide[wide == wide[3, 1]] = 199
    wide[3, 1] = 198
    assert tmvm.has_field_duplicates(wide, m) == jmvm.has_field_duplicates(wide, m)
    assert not tmvm.has_field_duplicates(np.zeros((0, 3), np.int32), np.zeros((0, 3)))


def test_resolve_mvm_product_matches_jax():
    for excl in ("auto", "on", "off", "sometimes"):
        for dup in (False, True):
            for procs in (1, 2):
                outcomes = []
                for fn in (tmvm.resolve_mvm_product, jmvm.resolve_mvm_product):
                    try:
                        outcomes.append(fn(excl, dup, procs))
                    except ValueError as e:
                        outcomes.append(str(e))
                assert outcomes[0] == outcomes[1], (excl, dup, procs)
    with pytest.raises(ValueError, match="mvm_exclusive=off"):
        tmvm.resolve_mvm_product("on", True, 1)


# ------------------------------------------------------------ product op

def _flat(seed, dup=False, ns=1):
    slots, fields, mask = _batch(seed, dup)
    plan = jst.plan_sorted_stacked(slots, mask, S, fields=fields if dup else None, num_sub=ns)
    return slots, fields, mask, plan


def test_product_channels_match_jax():
    v = _table(1, zero_rows=[(7, 0)])
    _, _, _, plan = _flat(1)
    occ = np.array(jst._gather_xla(jnp.asarray(v), jnp.asarray(plan.sorted_slots), None))[:V]
    occ[:, 3] = 0.0
    occ[:, 5] = -occ[:, 5]
    want = np.asarray(jmvm.mvm_product_channels(jnp.asarray(occ), jnp.asarray(plan.sorted_mask), V))
    got = tmvm.mvm_product_channels(_t(occ), _t(plan.sorted_mask), V).numpy()
    assert got.shape == want.shape == (tst._k8(3 * V), occ.shape[1])
    np.testing.assert_array_equal(got[V:], want[V:])
    _close(got[:V], want[:V], rtol=1e-6)


def _occ_with_zeros(seed, plan):
    """[V, Np] gathered factors with exact zeros: one row with a single
    zero, one with two (in different latent dims and in the same one)."""
    v = _table(seed)
    occ = np.array(jst._gather_xla(jnp.asarray(v), jnp.asarray(plan.sorted_slots), None))[:V]
    row = plan.sorted_row
    real = plan.sorted_mask > 0
    for r, cs in ((2, (0,)), (9, (1, 1)), (11, (2, 3))):
        js = np.flatnonzero((row == r) & real)
        for j, c in zip(js, cs):
            occ[c, j] = 0.0
    return np.ascontiguousarray(occ)


@pytest.mark.parametrize("plus", [0.0, 1.0])
def test_product_op_forward_and_backward_match_jax(plus):
    _, _, _, plan = _flat(2)
    occ = _occ_with_zeros(3, plan) + np.float32(plus)
    occ[0, 10] = 0.0  # an exact zero of the plus-one factor too
    mask, rows = plan.sorted_mask, plan.sorted_row
    dP = np.random.default_rng(4).normal(size=(B, V)).astype(np.float32)
    jop = jmvm.make_row_products(
        lambda st_, r: jst.row_sums_sorted(st_, r, B), lambda a: a, V)
    jP, vjp = jax.vjp(lambda o: jop(o, jnp.asarray(mask), jnp.asarray(rows)), jnp.asarray(occ))
    (jg,) = vjp(jnp.asarray(dP))
    tocc = _t(occ).requires_grad_(True)
    tP = tmvm.row_products(tocc, _t(mask), _t(rows), B, V)
    tP.backward(_t(dP))
    _close(tP.detach().numpy(), np.asarray(jP))
    _same_zeros(tP.detach().numpy(), np.asarray(jP))
    _close(tocc.grad.numpy(), np.asarray(jg))
    _same_zeros(tocc.grad.numpy(), np.asarray(jg))
    g = tocc.grad.numpy()
    assert (g[:, plan.sorted_mask == 0] == 0).all()  # masked and pads: exactly 0
    assert (g != 0).sum() > 0.5 * (plan.sorted_mask > 0).sum() * V


# ------------------------------------------------------- segment row side

def test_segment_sum_channels_forward_and_backward():
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(5, 300)).astype(np.float32)
    seg = rng.integers(0, 40, 300).astype(np.int32)
    d_out = rng.normal(size=(40, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jst.segment_sum_channels(x, jnp.asarray(seg), 40),
                        jnp.asarray(vals))
    tv = _t(vals).requires_grad_(True)
    got = tst.segment_sum_channels(tv, _t(seg), 40)
    got.backward(_t(d_out))
    _close(got.detach().numpy(), np.asarray(want), rtol=1e-5, floor=1e-2)
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(vjp(jnp.asarray(d_out))[0]))
    assert torch.autograd.gradcheck(
        lambda x: tst.segment_sum_channels(x, _t(seg), 40), (_t(vals).double().requires_grad_(),))


@pytest.mark.parametrize("plus", [0.0, 1.0])
def test_segment_row_side_matches_jax(plus):
    _, _, _, plan = _flat(6, dup=True)
    occ = _occ_with_zeros(7, plan)
    K8 = tst._k8(V)
    occ8 = np.concatenate([occ, np.zeros((K8 - V, occ.shape[1]), np.float32)])
    # a zero factor where plus-one is on: v = -1 in one (row, field)
    if plus:
        j = np.flatnonzero((plan.sorted_row == 20) & (plan.sorted_mask > 0))[0]
        occ8[1, j] = -1.0
    args = (plan.sorted_row, plan.sorted_mask, plan.sorted_fields)
    jl, vjp = jax.vjp(
        lambda o: jmvm._segment_row_side(o, *map(jnp.asarray, args), B, NF, V, plus),
        jnp.asarray(occ8))
    dl = np.random.default_rng(8).normal(size=B).astype(np.float32)
    (jg,) = vjp(jnp.asarray(dl))
    tocc = _t(occ8).requires_grad_(True)
    tl = tmvm._segment_row_side(tocc, *map(_t, args), B, NF, V, plus)
    tl.backward(_t(dl))
    _close(tl.detach().numpy(), np.asarray(jl))
    _close(tocc.grad.numpy(), np.asarray(jg))
    _same_zeros(tocc.grad.numpy(), np.asarray(jg))


# ----------------------------------------------------------- full forward

def _arrays(slots, fields, mask, layout, ns=1):
    labels = np.zeros(B, np.float32)
    row_mask = np.ones(B, np.float32)
    if layout == "row_major":
        return {"slots": slots, "fields": fields, "mask": mask, "labels": labels,
                "row_mask": row_mask}
    with_fields = layout == "segment"
    plan = jst.plan_sorted_stacked(slots, mask, S, fields=fields if with_fields else None,
                                   num_sub=ns)
    arrays = {"labels": labels, "row_mask": row_mask, "sorted_slots": plan.sorted_slots,
              "sorted_row": plan.sorted_row, "sorted_mask": plan.sorted_mask,
              "win_off": plan.win_off}
    if with_fields:
        arrays["sorted_fields"] = plan.sorted_fields
    return jst.compact_plan_wire(arrays, rows_bound=B // ns,
                                 fields_bound=NF if with_fields else 0)


LAYOUTS = [("product", 1), ("segment", 1), ("segment", 4), ("row_major", 1)]


@pytest.mark.parametrize("layout, ns", LAYOUTS)
@pytest.mark.parametrize("plus_one", [False, True])
def test_forward_matches_jax(layout, ns, plus_one):
    slots, fields, mask = _batch(9, dup=layout == "segment")
    v = _table(10, zero_rows=[(int(slots[1, 2]), 1)])
    arrays = _arrays(slots, fields, mask, layout, ns)
    pairs = _pairs(**{"model.mvm_plus_one": plus_one})
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    for jtab in (jnp.asarray(v), jst.pack_table(jnp.asarray(v))):
        want = np.asarray(jget_model("mvm").forward(
            {"v": jtab}, {k: jnp.asarray(a) for k, a in arrays.items()}, jcfg))
        got = get_model("mvm")(tcfg)({"v": _t(v)}, {k: _t(a) for k, a in arrays.items()})
        assert got.shape == (B,)
        _close(got.detach().numpy(), want)
        assert np.all(np.isfinite(want)) and np.abs(want).max() > 0


def test_forward_equal_across_layouts():
    """The product, segment (flat and stacked) and row-major forms of one
    exclusive-fields batch give the same logits."""
    slots, fields, mask = _batch(11)
    v = _table(12)
    model = get_model("mvm")(override(Config(), **_pairs()))
    out = {
        f"{lay}{ns}": model({"v": _t(v)}, {k: _t(a) for k, a in
                                          _arrays(slots, fields, mask, lay, ns).items()})
        .numpy()
        for lay, ns in LAYOUTS
    }
    for name, logits in out.items():
        _close(logits, out["row_major1"], rtol=1e-5, floor=1e-6)


def test_table_specs_and_init():
    cfg = override(Config(), **_pairs(**{"optim.v_init_scale": 0.5}))
    model = get_model("mvm")(cfg)
    assert model.table_specs(cfg) == jget_model("mvm").table_specs(joverride(JConfig(), **_pairs()))
    t = model.init_tables(torch.Generator().manual_seed(0), device="cpu")
    assert set(t) == {"v"} and tuple(t["v"].shape) == (S, V)
    assert abs(float(t["v"].std()) - 0.5) < 0.02
    sgd = model.init_tables.__self__.__class__(override(cfg, **{"optim.name": "sgd"}))
    assert bool((sgd.init_tables(torch.Generator(), device="cpu")["v"] == 1e-3).all())


def test_fm_stacked_equals_flat_and_jax():
    from xflow_tpu_torch.data.schema import make_batch
    from xflow_tpu_torch.evaluate import batch_arrays, to_device

    slots, fields, mask = _batch(13)
    rows_f = [fields[r][mask[r] > 0] for r in range(B)]
    rows_s = [slots[r][mask[r] > 0] for r in range(B)]
    batch = make_batch(rows_f, rows_s, [0.0] * B, B, F)
    wv = (np.random.default_rng(14).normal(size=(S, 1 + V)) * 0.3).astype(np.float32)
    pairs = {**_pairs(), "model.name": "fm"}
    logits = {}
    for ns in (1, 2):
        cfg = override(Config(), **pairs, **{"data.sorted_sub_batches": ns})
        arrays = batch_arrays(batch, cfg)
        assert arrays["sorted_slots"].ndim == (1 if ns == 1 else 2)
        logits[ns] = get_model("fm")(cfg)({"wv": _t(wv)}, to_device(arrays, "cpu")).numpy()
        jcfg = joverride(JConfig(), **pairs, **{"data.sorted_sub_batches": ns})
        want = np.asarray(jget_model("fm").forward(
            {"wv": jst.pack_table(jnp.asarray(wv))},
            {k: jnp.asarray(a) for k, a in arrays.items()}, jcfg))
        _close(logits[ns], want)
    _close(logits[2], logits[1])
