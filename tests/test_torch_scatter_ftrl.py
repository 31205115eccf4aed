"""PyTorch port, the fused scatter + FTRL pass (kernel #3,
`ops/sorted_table.scatter_ftrl_sorted`) and the non-finite guard that reads
its count, held against the JAX package on the CPU:

- the plain version's non-finite count (`nonfinite`, int32 [1]) equals the
  number of non-finite w', n', z' it returns, with NaN and +-Inf placed in
  d, w, n and z, bf16 off and on, and with bf16 off JAX's composition's
  (which does not round to bf16; the Pallas kernel's one-hot products
  spread a NaN term over its whole window, so it is no reference here); it adds to
  what the counter held; a counter of another dtype, shape or device is
  refused;
- the fused step under `train.nonfinite_guard` skip, halt and off, for FM
  and MVM's product side (`optim.fused_scatter=on`), against
  `xflow_tpu/train/step.py`'s step and `guard_nonfinite` on the same
  inputs: a NaN in one cotangent entry (the step's tail:
  `scatter_ftrl_sorted` with the counter, then `guard_nonfinite`), in one
  optimizer-state entry and in the loss (the whole step). The same
  `update_ok`; a skipped step hands the pre-step leaves through (the same
  tensors); an applied one matches JAX's within the FTRL tolerance, its
  non-finite entries at the same places. (Under `off` with a NaN label,
  JAX's packed [S/8, 8K] scatter also spreads each NaN gradient to the
  other 7 slots of its packed row, NaN x 0 in the packing; the port's
  logical [S, K] one does not. There the port's non-finite entries are
  JAX's inside the touched slots.);
- a hot-slot plan (one slot in every row's first field: a run of B) at K
  = 10, 11 and 73, bf16 off and on: `scatter_ftrl_plain` against JAX's
  `scatter_ftrl_sorted` composition (bf16 off) and `_scatter_ftrl_pallas`
  in interpret mode, 1e-3 relative over a 1e-4 floor (kernel_parity's
  scatter_ftrl_*), w of never-touched entries bitwise.

The hot plan's d are multiples of 2^-8 under 4 in magnitude: their bf16
roundings are multiples of 2^-8 too, so every float32 sum of a run is
exact in any order. The three versions sum a run in three orders, and on
unit normals FTRL magnifies the reorder of a long run whose sum is near 0
past its tolerance; exact sums leave no such slack.

Small shapes: S = 2^14, B = 64 rows of 8 occurrences (128 rows on the hot
plan), v_dim = 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import FTRLConfig as JFTRLConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.train.state import TrainState as JTrainState
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu.train.step import guard_nonfinite as jguard_nonfinite
from xflow_tpu.train.step import make_train_step as jmake_train_step
from xflow_tpu_torch.config import Config, FTRLConfig, override
from xflow_tpu_torch.evaluate import batch_arrays, to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train.state import TrainState
from xflow_tpu_torch.train.step import fused_cotangent, guard_nonfinite, make_train_step
from xflow_tpu_torch.weights import state_from_jax

LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
S = 1 << LOG2_S
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4
NAN, INF = float("nan"), float("inf")


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=FTRL_RTOL, floor=FTRL_FLOOR):
    """Within rtol over floor where finite; non-finite at the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    err = np.abs(got[finite] - want[finite]) / (np.abs(want[finite]) + floor)
    assert err.size == 0 or err.max() <= rtol, err.max()


def _plan(slots, mask=None):
    mask = np.ones(slots.shape, np.float32) if mask is None else mask
    return jst.plan_sorted_batch(slots, mask, S)


def _ftrl_state(k, seed):
    """(w, n, z) [S, k]: n and z 0 on the upper half (never touched)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((S, k)) * 0.01).astype(np.float32)
    n = (np.abs(rng.standard_normal((S, k))) * 0.1).astype(np.float32)
    z = (rng.standard_normal((S, k)) * 1e-4).astype(np.float32)
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    return w, n, z


def _n_nonfinite(leaves):
    return sum(int((~np.isfinite(np.asarray(a))).sum()) for a in leaves)


# --------------------------------------------------- the plain version's count


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_nonfinite_count_matches_the_outputs_and_jax(bf16):
    k = 1 + V
    rng = np.random.default_rng(1)
    plan = _plan(rng.integers(0, S, (B, NNZ)).astype(np.int32))
    ss = plan.sorted_slots
    d = rng.standard_normal((tst._k8(k), ss.shape[0])).astype(np.float32)
    d[0, 3] = NAN
    d[k - 1, 10] = INF
    d[1, 20] = -INF
    w, n, z = _ftrl_state(k, 2)
    w[int(ss[30]), 0] = NAN  # a touched slot
    n[S - 3, 2] = INF  # an untouched one
    z[S // 2 + 1, 1] = -INF
    counter = torch.full((1,), 7, dtype=torch.int32)  # the count adds to what it held
    got = tst.scatter_ftrl_sorted(_t(d), _t(ss), _t(plan.win_off), _t(w), _t(n), _t(z), k,
                                  FTRLConfig(), bf16, counter)
    count = _n_nonfinite([t.numpy() for t in got])
    assert count >= 6 and int(counter) - 7 == count
    if not bf16:
        want = jst.scatter_ftrl_sorted(*[jnp.asarray(a) for a in (d, ss, plan.win_off, w, n, z)],
                                       k, JFTRLConfig())
        assert _n_nonfinite(want) == count
        for a, b in zip(got, want):
            _close(a.numpy(), np.asarray(b))
    finite = [_t(np.where(np.isfinite(a), a, 0.0).astype(np.float32)) for a in (d, w, n, z)]
    clean = tst.scatter_ftrl_plain(finite[0], _t(ss), *finite[1:], k, FTRLConfig(), bf16,
                                   counter.zero_())
    assert int(counter) == 0 and _n_nonfinite([t.numpy() for t in clean]) == 0


def test_count_nonfinite_adds_without_a_host_read():
    counter = torch.zeros(1, dtype=torch.int32)
    tst.count_nonfinite([torch.tensor([1.0, NAN, INF]), torch.tensor([[-INF, 0.0]])], counter)
    tst.count_nonfinite([torch.tensor([NAN])], counter)
    assert counter.dtype == torch.int32 and counter.tolist() == [4]


@pytest.mark.parametrize("bad", [torch.zeros(1, dtype=torch.int64), torch.zeros(2, dtype=torch.int32),
                                 torch.zeros((1, 1), dtype=torch.int32)])
def test_a_bad_counter_is_refused(bad):
    k = 1 + V
    plan = _plan(np.arange(B * NNZ, dtype=np.int32).reshape(B, NNZ))
    d = torch.zeros((tst._k8(k), plan.sorted_slots.shape[0]))
    w = torch.zeros((S, k))
    with pytest.raises((TypeError, ValueError), match="nonfinite"):
        tst.scatter_ftrl_sorted(d, _t(plan.sorted_slots), _t(plan.win_off), w, w, w, k,
                                FTRLConfig(), False, bad)


# ------------------------------------------------------ the guard, against JAX


def _pairs(model, guard):
    pairs = {
        "model.name": model, "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ,
        "train.nonfinite_guard": guard,
    }
    if model == "mvm":
        pairs.update({"optim.fused_scatter": "on", "optim.v_init_scale": 0.1})
    return pairs


def _tname(model):
    return "v" if model == "mvm" else "wv"


def _batch(model, tcfg, seed, nan_label=False):
    """A flat sorted-plan batch: FM's sorted wire, or MVM's product side
    (one feature per field)."""
    from xflow_tpu_torch.data.schema import make_batch

    rng = np.random.default_rng(seed)
    fields, slots = [], []
    for _ in range(B - 5):
        f = rng.permutation(NF)[: int(rng.integers(3, NNZ + 1))].astype(np.int32)
        fields.append(f)
        slots.append(rng.integers(0, S // 2, f.size).astype(np.int32))  # the upper half untouched
    labels = list((rng.random(B - 5) < 0.4).astype(np.float32))
    if nan_label:
        labels[0] = np.nan
    arrays = batch_arrays(make_batch(fields, slots, labels, B, NNZ), tcfg)
    assert arrays["sorted_slots"].ndim == 1 and "sorted_fields" not in arrays
    return arrays


def _states(model, guard, poison=False):
    """(jcfg, tcfg, JAX state, port state): the JAX package's init, carried
    across; with `poison`, z of one never-touched entry is NaN in both."""
    pairs = _pairs(model, guard)
    jcfg, tcfg = joverride(JConfig(), **pairs), override(Config(), **pairs)
    js = jinit_state(jget_model(model), jget_optimizer("ftrl"), jcfg)
    tables = {k: np.asarray(a) for k, a in js.tables.items()}
    opt = {k: {leaf: np.array(a) for leaf, a in d.items()} for k, d in js.opt_state.items()}
    if poison:
        z = opt[_tname(model)]["z"]
        z.reshape(S, -1)[S - 7, 1] = np.nan  # logical [S, K] view of either layout
    js = JTrainState({k: jnp.asarray(a) for k, a in tables.items()},
                     {k: {leaf: jnp.asarray(a) for leaf, a in d.items()} for k, d in opt.items()},
                     js.step)
    return jcfg, tcfg, js, state_from_jax(tables, opt, int(js.step), tcfg, device="cpu")


def _leaves(state, tname, jax_side):
    leaves = [state.tables[tname], state.opt_state[tname]["n"], state.opt_state[tname]["z"]]
    if jax_side:
        return [np.asarray(a).reshape(S, -1) for a in leaves]
    return [a.numpy() for a in leaves]


def _check_guarded(tcfg, ts, tnew, tm, jnew, jm, tname, packed_spread=False):
    """The same update_ok; a skip hands the port's pre-step leaves
    through; an applied step matches JAX's (with `packed_spread`, JAX's
    NaN may also cover the other slots of a packed row the port's NaN
    lies in)."""
    guard = tcfg.train.nonfinite_guard
    if guard == "off":
        assert "update_ok" not in tm and "update_ok" not in jm
        applied = True
    else:
        assert tm["update_ok"] == bool(jm["update_ok"])
        applied = tm["update_ok"]
    assert tnew.step == ts.step + 1
    if not applied:
        assert tnew.tables[tname] is ts.tables[tname]
        for leaf in ("n", "z"):
            assert tnew.opt_state[tname][leaf] is ts.opt_state[tname][leaf]
    for a, b in zip(_leaves(tnew, tname, False), _leaves(jnew, tname, True)):
        if packed_spread:
            bad = ~np.isfinite(a)
            assert bad.any() and not (bad & np.isfinite(b)).any()
            rows = np.zeros(S // 8, bool)
            rows[np.nonzero(bad.any(axis=1))[0] // 8] = True
            spread = ~np.isfinite(b) & ~bad
            assert rows[np.nonzero(spread.any(axis=1))[0] // 8].all()
            keep = ~np.repeat(rows, 8)
            _close(a[keep], b[keep])
        else:
            _close(a, b)
    return applied


@pytest.mark.parametrize("model", ["fm", "mvm"])
@pytest.mark.parametrize("guard", ["skip", "halt", "off"])
def test_guard_on_a_nan_cotangent_matches_jax(model, guard):
    """The fused step's tail: one cotangent entry NaN, the loss finite."""
    jcfg, tcfg, js, ts = _states(model, guard)
    tname = _tname(model)
    arrays = _batch(model, tcfg, 3)
    batch = to_device(arrays, "cpu")
    table, st = ts.tables[tname], ts.opt_state[tname]
    loss, d = fused_cotangent(table, batch, tcfg)
    d = d.clone()
    d[0, 11] = NAN
    count = torch.zeros(1, dtype=torch.int32) if guard != "off" else None
    new = tst.scatter_ftrl_sorted(d, batch["sorted_slots"], batch["win_off"], table, st["n"],
                                  st["z"], table.shape[1], tcfg.optim.ftrl,
                                  tcfg.data.sorted_bf16, count)
    tnew, tm = guard_nonfinite(tcfg, ts, TrainState({tname: new[0]},
                                                    {tname: {"n": new[1], "z": new[2]}},
                                                    ts.step + 1), {"loss": loss}, count)
    jl = [jnp.asarray(a) for a in _leaves(js, tname, True)]
    jout = jst.scatter_ftrl_sorted(jnp.asarray(d.numpy()), jnp.asarray(arrays["sorted_slots"]),
                                   jnp.asarray(arrays["win_off"]), *jl, table.shape[1],
                                   jcfg.optim.ftrl, jcfg.data.sorted_bf16)
    jpre = JTrainState({tname: jl[0]}, {tname: {"n": jl[1], "z": jl[2]}}, js.step)
    jnew, jm = jguard_nonfinite(jcfg, jpre, JTrainState(
        {tname: jout[0]}, {tname: {"n": jout[1], "z": jout[2]}}, js.step + 1),
        {"loss": jnp.asarray(loss.numpy())})
    assert np.isfinite(float(loss))
    assert _check_guarded(tcfg, ts, tnew, tm, jnew, jm, tname) == (guard == "off")
    if guard != "off":
        assert int(count) == _n_nonfinite([a.numpy() for a in new]) > 0


@pytest.mark.parametrize("model", ["fm", "mvm"])
@pytest.mark.parametrize("guard", ["skip", "halt", "off"])
@pytest.mark.parametrize("where", ["state", "loss"])
def test_guarded_step_on_a_nan_matches_jax(model, guard, where):
    """The whole fused step: a NaN in z of one never-touched entry (the
    loss finite), or a NaN label (the loss NaN)."""
    jcfg, tcfg, js, ts = _states(model, guard, poison=where == "state")
    tname = _tname(model)
    arrays = _batch(model, tcfg, 4, nan_label=where == "loss")
    jstep = jmake_train_step(jget_model(model), jget_optimizer("ftrl"), jcfg, jit=False)
    tstep = make_train_step(get_model(model)(tcfg), get_optimizer("ftrl"), tcfg)
    jnew, jm = jstep(js, {k: jnp.asarray(a) for k, a in arrays.items()})
    tnew, tm = tstep(ts, to_device(arrays, "cpu"))
    assert np.isfinite(float(tm["loss"])) == (where == "state") == np.isfinite(float(jm["loss"]))
    spread = where == "loss" and guard == "off"
    assert _check_guarded(tcfg, ts, tnew, tm, jnew, jm, tname, spread) == (guard == "off")


@pytest.mark.parametrize("model", ["fm", "mvm"])
def test_guarded_step_applies_a_finite_update_like_jax(model):
    jcfg, tcfg, js, ts = _states(model, "skip")
    tname = _tname(model)
    arrays = _batch(model, tcfg, 5)
    jnew, jm = jmake_train_step(jget_model(model), jget_optimizer("ftrl"), jcfg, jit=False)(
        js, {k: jnp.asarray(a) for k, a in arrays.items()})
    tnew, tm = make_train_step(get_model(model)(tcfg), get_optimizer("ftrl"), tcfg)(
        ts, to_device(arrays, "cpu"))
    assert _check_guarded(tcfg, ts, tnew, tm, jnew, jm, tname)
    assert not np.array_equal(_leaves(tnew, tname, False)[2], _leaves(ts, tname, False)[2])


# ------------------------------------------------------------- the hot slot


def _interpret():
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    return pltpu.force_tpu_interpret_mode()


HOT_SLOT = 12345  # in the upper half: n = z = 0 there until the step


@pytest.mark.parametrize("k", [10, 11, 73])
@pytest.mark.parametrize("bf16", [False, True])
def test_hot_slot_plan_matches_jax_and_pallas_interpret(k, bf16):
    rows = 128
    rng = np.random.default_rng(k)
    slots = rng.integers(0, S // 2, (rows, NNZ)).astype(np.int32)
    slots[:, 0] = HOT_SLOT  # a run of `rows` occurrences
    mask = (rng.random((rows, NNZ)) < 0.9).astype(np.float32)
    plan = _plan(slots, mask)
    ss, wo = plan.sorted_slots, plan.win_off
    d = (rng.integers(-1024, 1025, (tst._k8(k), ss.shape[0])) / 256.0).astype(np.float32)
    d[:k] *= plan.sorted_mask[None, :]
    w, n, z = _ftrl_state(k, k + 1)
    got = [t.numpy() for t in tst.scatter_ftrl_plain(_t(d), _t(ss), _t(w), _t(n), _t(z), k,
                                                     FTRLConfig(), bf16)]
    args = [jnp.asarray(a) for a in (d, ss, wo, w, n, z)]
    with _interpret():
        pallas = [np.asarray(a) for a in jst._scatter_ftrl_pallas(*args, k, JFTRLConfig(), bf16)]
    wants = [pallas]
    if not bf16:  # the composition does not round to bf16
        wants.append([np.asarray(a) for a in jst.scatter_ftrl_sorted(*args, k, JFTRLConfig())])
    for want in wants:
        for a, b in zip(got, want):
            _close(a, b)
    hot = int(np.searchsorted(ss, HOT_SLOT))
    assert int(np.searchsorted(ss, HOT_SLOT + 1)) - hot == rows
    assert np.all(got[1][HOT_SLOT] > 0)  # the hot slot was updated on every channel
    untouched = np.arange(S) >= S // 2  # n = z = 0 and no gradient: w kept bitwise
    untouched[HOT_SLOT] = False
    for want in [got] + wants:
        np.testing.assert_array_equal(want[0][untouched], w[untouched])
