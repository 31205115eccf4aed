"""The port's measured roofline, held against the JAX package:

- `StepTimer.window_record(cost=...)` gives the JAX record's
  `achieved_flops_per_s` and `achieved_hbm_gbps`, keys and values, on the
  same injected step timings and the same constant cost, and leaves them
  out without a cost (the JAX tests of `tests/test_perf_tools.py`, run on
  the port too); the port's per-step counts sum over the window;
- `train.compile_metrics` has the JAX default, and a JAX-style override
  sets it in both;
- `train/cost.step_cost` against hand counts on tiny plans, for each step
  form the single-device trainer runs: LR row-major with and without
  dedup, FM row-major, FM's sorted two-pass and fused steps (one count:
  the work, not the kernel), MVM's product side and its stacked segment
  step, FFM's aligned hybrid; the gather's part of a count within the
  smoke's bound for #1;
- the native planner's distinct count equals the plain planner's and
  `np.unique` of the unpadded slots, on uniform and Zipf plans, with and
  without the wire dtypes, flat and stacked; the dedup's count its uniques;
- the gauges in a CPU `fit`'s window records (FM fused and LR), consistent
  with each step's count, and absent with `compile_metrics` off.
"""

import json
import os
import time

import numpy as np
import pytest

import xflow_tpu.telemetry as jtel
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
import xflow_tpu_torch.telemetry as ttel
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.schema import SparseBatch
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.evaluate import HostArrays, HostDedup, batch_arrays
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.train.cost import distinct_rows, step_cost
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jtel, "torch": ttel}
ROOFLINE = {"achieved_flops_per_s", "achieved_hbm_gbps"}
S = 1 << 14

# ------------------------------------------------------------ StepTimer


class _Clock:
    """A perf_counter stand-in: every call advances 1, 2 or 3 ms, so two
    timers that read it in the same order see the same instants."""

    def __init__(self):
        self.t, self.k = 100.0, 0

    def __call__(self):
        self.k += 1
        self.t += 0.001 * (1 + self.k % 3)
        return self.t


def _drive(monkeypatch, tel, n=6, step_cost_=None, window_cost=None):
    monkeypatch.setattr(time, "perf_counter", _Clock())
    st = tel.StepTimer(registry=tel.Registry())
    for _ in st.batches(range(n)):
        if step_cost_ is None:
            st.dispatched(np.float32(0.5), rows=64)
        else:
            st.dispatched(np.float32(0.5), rows=64, cost=step_cost_)
    st.flush()
    return st.window_record(cost=window_cost)


@pytest.mark.parametrize("cost", [{"flops": 1000, "bytes": 500},
                                  {"flops": 123456789, "bytes": 987654321},
                                  {"flops": 0, "bytes": 4096}])
def test_window_gauges_equal_jax_on_injected_timings(monkeypatch, cost):
    want = _drive(monkeypatch, jtel, window_cost=cost)
    got = _drive(monkeypatch, ttel, window_cost=cost)
    assert got == want
    assert "achieved_hbm_gbps" in got
    assert ("achieved_flops_per_s" in got) == bool(cost["flops"])
    # the per-step counts: each step's own, summed, is JAX's constant one
    assert _drive(monkeypatch, ttel, step_cost_=cost) == want


def test_window_without_cost_has_no_gauges_in_either(monkeypatch):
    for tel in PACKAGES.values():
        rec = _drive(monkeypatch, tel)
        assert rec and not ROOFLINE & set(rec)


def test_per_step_counts_sum_over_the_window(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", _Clock())
    st = ttel.StepTimer(registry=ttel.Registry())
    costs = [{"flops": 10 * (i + 1), "bytes": 1000 * (i + 1)} for i in range(4)]
    for c in st.batches(costs):
        st.dispatched(np.float32(0.5), rows=64, cost=c)
    st.flush()
    device_s = float(np.sum(st._win["device"]))
    rec = st.window_record()
    assert rec["achieved_flops_per_s"] == round(100 / device_s, 1)
    assert rec["achieved_hbm_gbps"] == round(10000 / device_s / 1e9, 4)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_steptimer_roofline_fields(pkg):
    tel = PACKAGES[pkg]
    st = tel.StepTimer(tel.Registry())
    for _ in st.batches([1, 2, 3]):
        st.dispatched(np.float32(0.5), rows=64)
    st.flush()
    rec = st.window_record(cost={"flops": 1000.0, "bytes": 500.0})
    assert rec["achieved_flops_per_s"] > 0
    assert rec["achieved_hbm_gbps"] > 0
    ratio = rec["achieved_hbm_gbps"] * 1e9 / rec["achieved_flops_per_s"]
    assert ratio == pytest.approx(0.5, rel=0.05)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_steptimer_no_cost_no_roofline_fields(pkg):
    tel = PACKAGES[pkg]
    st = tel.StepTimer(tel.Registry())
    for _ in st.batches([1]):
        st.dispatched(np.float32(0.5), rows=64)
    st.flush()
    rec = st.window_record()
    assert "achieved_flops_per_s" not in rec
    assert "achieved_hbm_gbps" not in rec


# --------------------------------------------------------------- config


@pytest.mark.parametrize("value", ["false", "0", "true"])
def test_compile_metrics_default_and_override_match_jax(value):
    assert Config().train.compile_metrics is JConfig().train.compile_metrics is True
    got = override(Config(), **{"train.compile_metrics": value}).train.compile_metrics
    want = joverride(JConfig(), **{"train.compile_metrics": value}).train.compile_metrics
    assert got is want


# ----------------------------------------------------------- hand counts

# four rows of three occurrences over six distinct slots: the dedup's
# capacity at dedup_cap_frac 0.5 is 4 * 3 * 0.5 = 6
SLOTS = [[1, 2, 3], [1, 2, 4], [5, 2, 3], [1, 6, 3]]
FIELDS = [[0, 1, 2]] * 4
B, F, U = 4, 3, 6
NP = 1024  # padded_len(12): two chunks of 512
WIN = S // 2048 + 1  # win_off's entries


def _batch(fields=FIELDS):
    return SparseBatch(np.asarray(SLOTS, np.int32), np.asarray(fields, np.int32),
                       np.ones((B, F), np.float32), np.asarray([1, 0, 1, 0], np.float32),
                       np.ones(B, np.float32))


def _cfg(model, **kw):
    return override(Config(), **{"model.name": model, "model.v_dim": 2, "model.num_fields": 3,
                                 "data.max_nnz": F, "data.batch_size": B,
                                 "data.log2_slots": 14, **kw})


def _count(cfg, batch=None):
    return step_cost(cfg, batch_arrays(batch or _batch(), cfg, HostDedup(cfg)))


# each case: (config, its hand count {"bytes", "flops"}), the terms in
# the order of train/cost.py's docstring: plan arrays, distinct rows (w
# and FTRL's n, z read and written), occurrence rows and their cotangent,
# per-row products and their cotangent, logits and theirs
HAND = {
    # LR, dedup: unique_slots i32[6], inverse i32[4,3], mask f32[4,3],
    # labels, row_mask; K 1; ch 1, R 0, row 0
    "lr_dedup": (_cfg("lr", **{"data.dedup": "auto"}), {
        "bytes": (24 + 48 + 48 + 16 + 16) + 2 * 3 * 6 * 1 * 4 + 2 * 2 * 12 * 1 * 4 + 0
        + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * 12 * 1 + 4 * (0 + 8)) + 12 * 1 + 6 * 1 * 16}),
    # LR without dedup (the default): slots i32[4,3], mask, labels,
    # row_mask; U counted as the 12 occurrences
    "lr_no_dedup": (_cfg("lr"), {
        "bytes": (48 + 48 + 16 + 16) + 2 * 3 * 12 * 1 * 4 + 2 * 2 * 12 * 1 * 4
        + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * 12 * 1 + 4 * 8) + 12 * 1 + 12 * 1 * 16}),
    # FM row-major, dedup: K 3; ch 5, R 5, row 3 * 2 + 2
    "fm_row_major": (_cfg("fm", **{"data.sorted_layout": "off", "data.dedup": "auto"}), {
        "bytes": (24 + 48 + 48 + 16 + 16) + 2 * 3 * 6 * 3 * 4 + 2 * 2 * 12 * 3 * 4
        + 2 * 2 * 4 * 5 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * 12 * 5 + 4 * (8 + 8)) + 12 * 3 + 6 * 3 * 16}),
    # FM sorted, fused: sorted_slots i32[1024], sorted_row u16, sorted_mask
    # u8, win_off i32[9], labels, row_mask
    "fm_fused": (_cfg("fm"), {
        "bytes": (NP * 4 + NP * 2 + NP + WIN * 4 + 16 + 16) + 2 * 3 * 6 * 3 * 4
        + 2 * 2 * NP * 3 * 4 + 2 * 2 * 4 * 5 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * NP * 5 + 4 * (8 + 8)) + NP * 3 + 6 * 3 * 16}),
    # bf16 gathered rows: the occurrence terms at 2 bytes
    "fm_fused_bf16": (_cfg("fm", **{"data.sorted_bf16": True}), {
        "bytes": (NP * 4 + NP * 2 + NP + WIN * 4 + 16 + 16) + 2 * 3 * 6 * 3 * 4
        + 2 * 2 * NP * 3 * 2 + 2 * 2 * 4 * 5 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * NP * 5 + 4 * (8 + 8)) + NP * 3 + 6 * 3 * 16}),
    # MVM's product side (two-pass under auto): K 2; ch 6, R 6, row 8
    "mvm_product": (_cfg("mvm"), {
        "bytes": (NP * 4 + NP * 2 + NP + WIN * 4 + 16 + 16) + 2 * 3 * 6 * 2 * 4
        + 2 * 2 * NP * 2 * 4 + 2 * 2 * 4 * 6 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * NP * 6 + 4 * (8 + 8)) + NP * 2 + 6 * 2 * 16}),
    # MVM's segment step stacked in 2 sub-plans of 1024 with u8 fields:
    # U = 4 + 5 distinct (the sub-plans' sum); ch 3, R 3 * 3, row 3 * 2 + 2
    "mvm_segment_stacked": (_cfg("mvm", **{"model.mvm_exclusive": "off",
                                           "data.sorted_sub_batches": 2}), {
        "bytes": (2 * NP * 4 + 2 * NP * 2 + 2 * NP + 2 * NP + 2 * WIN * 4 + 16 + 16)
        + 2 * 3 * 9 * 2 * 4 + 2 * 2 * 2 * NP * 2 * 4 + 2 * 2 * 4 * 9 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * 2 * NP * 3 + 4 * (8 + 8)) + 2 * NP * 2 + 9 * 2 * 16}),
    # FFM's aligned hybrid (fused): K 1 + 3 * 2; u8 fields, ffm_invperm
    # i32[4, 3]; ch 1, R 3 * 7, row 5 * 3 * 6 + 3
    "ffm_aligned": (_cfg("ffm"), {
        "bytes": (NP * 4 + NP * 2 + NP + NP + WIN * 4 + 48 + 16 + 16) + 2 * 3 * 6 * 7 * 4
        + 2 * 2 * NP * 7 * 4 + 2 * 2 * 4 * 21 * 4 + 2 * 2 * 4 * 4,
        "flops": 2 * (2 * NP * 1 + 4 * (93 + 8)) + NP * 7 + 6 * 7 * 16}),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_step_cost_matches_the_hand_count(case):
    cfg, want = HAND[case]
    assert _count(cfg) == want


def test_the_fused_and_two_pass_steps_count_the_same_work():
    fused = _cfg("fm")
    two_pass = _cfg("fm", **{"optim.fused_scatter": "off"})
    assert _count(fused) == _count(two_pass) == HAND["fm_fused"][1]
    # SGD keeps no leaves: only w of each distinct row is read and written,
    # at 2 operations an element
    sgd = _count(_cfg("fm", **{"optim.name": "sgd"}))
    assert HAND["fm_fused"][1]["bytes"] - sgd["bytes"] == 2 * 2 * 6 * 3 * 4
    assert HAND["fm_fused"][1]["flops"] - sgd["flops"] == 6 * 3 * (16 - 2)


def test_the_distinct_count_is_exact_only_where_a_planner_counted():
    for case, exact in (("fm_fused", True), ("lr_dedup", True), ("lr_no_dedup", False)):
        cfg = HAND[case][0]
        host = batch_arrays(_batch(), cfg, HostDedup(cfg))
        assert isinstance(host, HostArrays)
        assert distinct_rows(host) == ((U, True) if exact else (B * F, False))


def test_the_gather_part_stays_within_the_smokes_bound():
    """#1's share of the count (the slots read, each distinct row read, the
    gathered rows written) against `chip_smoke.gather_bytes` on a random
    plan at K = 11."""
    import torch

    import chip_smoke

    rng = np.random.default_rng(3)
    slots = rng.integers(0, S, (64, 18)).astype(np.int32)
    plan = tst.plan_sorted_batch(slots, np.ones_like(slots, np.float32), S)
    K = 11
    part = plan.sorted_slots.size * 4 + plan.distinct * K * 4 + plan.sorted_slots.size * K * 4
    bound = chip_smoke.gather_bytes(torch.from_numpy(plan.sorted_slots), K, tst._k8(K))
    assert part <= bound


def test_step_cost_is_cached_by_shape_and_reads_no_data():
    from xflow_tpu_torch.train import cost

    cfg = _cfg("fm")
    host = batch_arrays(_batch(), cfg)
    cost._linear.cache_clear()
    first = step_cost(cfg, host)
    other = HostArrays({k: np.zeros_like(v) for k, v in host.items()})
    other.distinct = host.distinct
    assert step_cost(cfg, other) == first  # the shapes and U, never the values
    info = cost._linear.cache_info()
    assert (info.hits, info.misses) == (1, 1)


# -------------------------------------------------------- distinct counts


def _plan_batch(kind: str, seed: int, rows: int = 64, nnz: int = 18):
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        slots = np.minimum(rng.zipf(1.3, (rows, nnz)) - 1, S - 1).astype(np.int32)
    else:
        slots = rng.integers(0, S, (rows, nnz)).astype(np.int32)
    mask = (rng.random((rows, nnz)) < 0.8).astype(np.float32)
    fields = np.tile(np.arange(nnz, dtype=np.int32), (rows, 1))
    return slots, mask, fields


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("with_fields", [False, True])
def test_native_distinct_equals_plain_and_unique(kind, wire, with_fields):
    slots, mask, fields = _plan_batch(kind, 1 + wire + 2 * with_fields)
    f = fields if with_fields else None
    want = np.unique(slots).size  # masked occurrences keep their slots
    got = tst.plan_sorted_batch(slots, mask, S, fields=f, wire=wire)
    plain = tst.plan_sorted_plain(slots, mask, S, fields=f)
    assert got.distinct == plain.distinct == want
    assert isinstance(got.distinct, int)
    assert np.unique(got.sorted_slots[:slots.size]).size == want  # the pads are no rows


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("ns", [2, 4])
def test_stacked_distinct_is_the_sub_plans_sum(kind, ns):
    slots, mask, _ = _plan_batch(kind, 7 + ns)
    plan = tst.plan_sorted_stacked(slots, mask, S, num_sub=ns, wire=True)
    bs = slots.shape[0] // ns
    assert plan.distinct == sum(np.unique(slots[i * bs:(i + 1) * bs]).size for i in range(ns))
    one = tst.plan_sorted_stacked(slots, mask, S, num_sub=1, always_stack=True)
    assert one.distinct == np.unique(slots).size and one.sorted_slots.ndim == 2


def test_the_distinct_count_of_an_empty_plan_is_zero():
    empty = np.zeros((0, 4), np.int32)
    for fn in (tst.plan_sorted_batch, tst.plan_sorted_plain):
        assert fn(empty, np.zeros((0, 4), np.float32), S).distinct == 0


def test_dedup_counts_its_uniques():
    cfg = HAND["lr_dedup"][0]
    out = HostDedup(cfg)(dict(batch_arrays(_batch(), override(cfg, **{"data.dedup": "off"}))))
    assert out.distinct == np.unique(SLOTS).size == U
    assert out["unique_slots"].shape == (6,)
    got = tst.dedup_slots_counted(np.asarray(SLOTS, np.int32), 6)
    want = tst.dedup_slots(np.asarray(SLOTS, np.int32), 6)
    assert got[2] == U and all(np.array_equal(a, b) for a, b in zip(got[:2], want))


# ---------------------------------------------------------- a CPU fit


FIT = {"model.v_dim": 4, "model.num_fields": 6, "data.max_nnz": 8, "data.batch_size": 64,
       "data.log2_slots": 14, "train.epochs": 1, "train.log_every": 1}


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    work = tmp_path_factory.mktemp("roofline")
    generate_shards(str(work / "train"), 1, 256, num_fields=6, ids_per_field=40, seed=4)
    return work


def _fit(shard, name, model, **kw):
    path = shard / name / "metrics_rank0.jsonl"
    cfg = override(Config(), **FIT, **{"model.name": model,
                                       "data.train_path": str(shard / "train"),
                                       "train.metrics_path": str(path)}, **kw)
    Trainer(cfg, device="cpu").fit()
    with open(path) as f:
        return cfg, [json.loads(line) for line in f if '"loss"' in line]


@pytest.mark.parametrize("model", ["fm", "lr"])
def test_fit_window_records_carry_the_gauges(shard, model):
    from xflow_tpu_torch.data.pipeline import batch_iterator

    cfg, wins = _fit(shard, model, model)
    assert [r["step"] for r in wins] == [1, 2, 3, 4]
    dedup = HostDedup(cfg)
    costs = [step_cost(cfg, batch_arrays(b, cfg, dedup))
             for b in batch_iterator(str(shard / "train-00000"), cfg.data)]
    for r, c in zip(wins, costs):
        assert ROOFLINE <= set(r)
        # each gauge is its step's count over the window's one step's
        # device time, up to the record's rounding: device_ms to 1e-3 ms,
        # the gauges to 1e-4 GB/s and 0.1 FLOP/s
        d = r["device_ms"] / 1e3
        rel = 0.5e-6 / (d - 0.5e-6)
        for key, count, unit, half in (("achieved_hbm_gbps", c["bytes"], 1e9, 0.5e-4),
                                       ("achieved_flops_per_s", c["flops"], 1.0, 0.05)):
            want = count / d / unit
            assert abs(r[key] - want) <= half + want * rel, key


def test_fit_window_records_lose_the_gauges_with_compile_metrics_off(shard):
    _, wins = _fit(shard, "off", "fm", **{"train.compile_metrics": False})
    assert len(wins) == 4 and not any(ROOFLINE & set(r) for r in wins)
