"""PyTorch port, sorted-window engine (xflow_tpu_torch/ops/sorted_table.py)
held against the JAX package on the same numpy inputs:

- the host planner, bitwise;
- the gather's plain version, bitwise against `_gather_xla`,
  `table_gather_sorted` and the Pallas kernel in interpret mode;
- the row sum's plain version against `row_sums_sorted` and the Pallas
  kernel, within kernel_parity's reduction tolerance (1e-4 relative over
  a 1e-2 floor: the two sum in different orders);
- the backwards: the row sum's against `jax.vjp` of `row_sums_sorted`
  (a gather: bitwise), and both backwards by `torch.autograd.gradcheck`
  in float64.

Small shapes: S = 2^14, B = 64 rows of 8 occurrences, v_dim = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.weights import tables_from_jax

S = 1 << 14
B, F = 64, 8
K = 5  # fused FM row at v_dim = 4
K8 = tst._k8(K)
RTOL, FLOOR = 1e-4, 1e-2  # xflow_tpu/tools/kernel_parity.py reductions
CHUNK_N = tst.CHUNK


def _case(seed, mask_p=0.7):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:4] = slots[4:8]  # repeated slots inside one window
    mask = (rng.random((B, F)) < mask_p).astype(np.float32)
    table = rng.normal(size=(S, K)).astype(np.float32)
    return slots, mask, table


def _jax_plan(monkeypatch, slots, mask, fields=None):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")
    plan = jst.plan_sorted_batch(slots, mask, S, fields=fields)
    monkeypatch.delenv("XFLOW_NO_NATIVE_PLAN")
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    return plan


def _cfg():
    return override(Config(), **{
        "model.name": "fm", "model.v_dim": K - 1, "data.log2_slots": 14,
        "data.batch_size": B, "data.max_nnz": F,
    })


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= RTOL * np.maximum(np.abs(want), FLOOR)), err.max()


@pytest.mark.parametrize("seed, with_fields", [(0, False), (1, True), (2, False)])
def test_plan_bitwise_equal_to_jax_numpy_planner(monkeypatch, seed, with_fields):
    slots, mask, _ = _case(seed)
    fields = (
        np.random.default_rng(seed).integers(0, 18, (B, F)).astype(np.int32)
        if with_fields else None
    )
    want = _jax_plan(monkeypatch, slots, mask, fields)
    got = tst.plan_sorted_batch(slots, mask, S, fields=fields)
    for name in ("sorted_slots", "sorted_row", "sorted_mask", "win_off", "sorted_fields"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_plan_rejects_out_of_range_slot():
    slots, mask, _ = _case(3)
    slots[0, 0] = S
    with pytest.raises(ValueError, match="out of range"):
        tst.plan_sorted_batch(slots, mask, S)


@pytest.mark.parametrize("packed", [False, True])
def test_gather_plain_bitwise_equal_to_jax(monkeypatch, packed):
    slots, mask, table = _case(4)
    plan = _jax_plan(monkeypatch, slots, mask)
    jtab = jst.pack_table(jnp.asarray(table)) if packed else jnp.asarray(table)
    pack = jst.pack_of(jtab, K)
    jss, joff = jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off)
    want_xla = np.asarray(jst._gather_xla(jtab, jss, joff, pack))
    want_op = np.asarray(jst.table_gather_sorted(jtab, jss, joff, False, pack))
    ttab = tables_from_jax({"wv": np.asarray(jtab)}, _cfg(), device="cpu")["wv"]
    assert tuple(ttab.shape) == (S, K)
    got = tst.table_gather_sorted(
        ttab, torch.from_numpy(plan.sorted_slots), torch.from_numpy(plan.win_off)
    ).numpy()
    assert got.shape == (K8, plan.sorted_slots.shape[0])
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_op)


def test_gather_plain_zero_rows_and_out_of_range_slots():
    _, _, table = _case(5)
    ss = torch.tensor([0, 3, S - 1, S, S + 7], dtype=torch.int32)
    got = tst.gather_sorted_plain(torch.from_numpy(table), ss)
    want = jst._gather_xla(jnp.asarray(table), jnp.asarray(ss.numpy()), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.all(got[K:] == 0) and torch.all(got[:, 3:] == 0)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_plain_matches_pallas_interpret(monkeypatch, bf16):
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    slots, mask, table = _case(6)
    plan = _jax_plan(monkeypatch, slots, mask)
    n = slots.size
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jst._gather_pallas(
            jnp.asarray(table), jnp.asarray(plan.sorted_slots),
            jnp.asarray(plan.win_off), bf16,
        ))
    got = tst.gather_sorted_plain(
        torch.from_numpy(table), torch.from_numpy(plan.sorted_slots), bf16
    ).numpy()
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


def _rowsum_inputs(monkeypatch, seed, wire):
    slots, mask, table = _case(seed)
    plan = _jax_plan(monkeypatch, slots, mask)
    rng = np.random.default_rng(seed + 100)
    ch = tst._k8(2 * K - 1)
    vals = rng.normal(size=(ch, plan.sorted_slots.shape[0])).astype(np.float32)
    vals *= plan.sorted_mask[None, :]  # pads and masked occurrences add 0
    rows = plan.sorted_row
    if wire:
        rows = jst.compact_plan_wire({"sorted_row": rows}, rows_bound=B)["sorted_row"]
        assert rows.dtype == np.uint16
    return vals, rows


@pytest.mark.parametrize("wire", [False, True])
def test_row_sums_plain_matches_jax(monkeypatch, wire):
    vals, rows = _rowsum_inputs(monkeypatch, 7, wire)
    want = np.asarray(jst.row_sums_sorted(
        jnp.asarray(vals), jst.wire_rows(jnp.asarray(rows)), B
    ))
    got = tst.row_sums_sorted(
        torch.from_numpy(vals), tst.wire_rows(torch.from_numpy(rows)), B
    ).numpy()
    assert got.shape == (B, vals.shape[0])
    _close(got, want)


@pytest.mark.parametrize("ch", [8, 24, 136])
def test_row_sums_plain_contract_matches_jax(monkeypatch, ch):
    """The row-sum contract at the JAX kernel's widths (ch % 8 == 0, Np a
    multiple of CHUNK): masked occurrences and pads (row 0, value 0) add
    nothing, rows outside [0, B) are skipped, against `row_sums_sorted`
    on the CPU (JAX's segment sum drops them)."""
    slots, mask, _ = _case(ch)
    plan = _jax_plan(monkeypatch, slots, mask)
    np_ = plan.sorted_slots.shape[0]
    assert np_ % CHUNK_N == 0 and (plan.sorted_row[-CHUNK_N:] == 0).all()
    rng = np.random.default_rng(ch)
    vals = rng.normal(size=(ch, np_)).astype(np.float32) * plan.sorted_mask[None, :]
    rows = plan.sorted_row.copy()
    rows[[3, 11, 40]] = [-1, B, B + 1000]  # out of range: skipped
    want = np.asarray(jst.row_sums_sorted(jnp.asarray(vals), jnp.asarray(rows), B))
    got = tst.row_sums_sorted(torch.from_numpy(vals), torch.from_numpy(rows), B).numpy()
    assert got.shape == (B, ch)
    _close(got, want)
    keep = (rows >= 0) & (rows < B) & (plan.sorted_mask > 0)
    ref = np.zeros((B, ch), np.float64)
    np.add.at(ref, rows[keep], vals[:, keep].T.astype(np.float64))
    _close(got, ref)
    assert not got[np.bincount(rows[keep], minlength=B) == 0].any()


def test_row_sums_plain_takes_any_channel_count():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(6, 64)).astype(np.float32)
    rows = rng.integers(0, 5, 64).astype(np.int32)
    got = tst.row_sums_sorted(torch.from_numpy(vals), torch.from_numpy(rows), 5).numpy()
    ref = np.zeros((5, 6), np.float64)
    np.add.at(ref, rows, vals.T.astype(np.float64))
    _close(got, ref)


def test_row_sums_plain_matches_pallas_interpret(monkeypatch):
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    vals, rows = _rowsum_inputs(monkeypatch, 8, False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jst._rowsum_pallas(jnp.asarray(vals), jnp.asarray(rows), B))
    got = tst.row_sums_plain(torch.from_numpy(vals), torch.from_numpy(rows), B).numpy()
    _close(got, want)


def test_wire_compaction_matches_jax_and_widens(monkeypatch):
    slots, mask, _ = _case(9)
    plan = _jax_plan(monkeypatch, slots, mask)
    arrays = {"sorted_row": plan.sorted_row, "sorted_mask": plan.sorted_mask,
              "sorted_slots": plan.sorted_slots}
    want = jst.compact_plan_wire(arrays, rows_bound=B)
    got = tst.compact_plan_wire(arrays, rows_bound=B)
    for k in arrays:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert got["sorted_mask"].dtype == np.uint8
    assert torch.equal(tst.wire_mask(torch.from_numpy(got["sorted_mask"])),
                       torch.from_numpy(plan.sorted_mask))
    assert torch.equal(tst.wire_rows(torch.from_numpy(got["sorted_row"])),
                       torch.from_numpy(plan.sorted_row))
    with pytest.raises(ValueError, match="0/1"):
        tst.compact_plan_wire({"sorted_mask": np.full(4, 0.5, np.float32)}, rows_bound=B)


def test_plain_versions_only_on_cpu_tensors():
    """A wrapper takes the plain version because its tensors lie on the
    CPU; tensors elsewhere go to the kernel wrapper, which checks them."""
    from xflow_tpu_torch.config import FTRLConfig

    table = torch.zeros((S, K))
    ss = torch.zeros(CHUNK_N, dtype=torch.int32)
    win_off = torch.zeros(S // tst.WINDOW + 1, dtype=torch.int32)
    d = torch.zeros((K8, CHUNK_N))
    hp = FTRLConfig()
    before = dict(tst.LAUNCHES)
    tst.table_gather_sorted(table, ss, win_off)
    tst.row_sums_sorted(torch.zeros((16, CHUNK_N)), ss, 4)
    tst.scatter_sorted(d, ss, win_off, S, K)
    tst.scatter_ftrl_sorted(d, ss, win_off, table, table, table, K, hp)
    assert tst.LAUNCHES == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tst.gather_sorted_cuda(table, ss)
    with pytest.raises(ValueError, match="CUDA"):
        tst.row_sums_cuda(torch.zeros((16, CHUNK_N)), ss, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tst.scatter_sorted_cuda(d, ss, win_off, S, K)
    with pytest.raises(ValueError, match="CUDA"):
        tst.scatter_ftrl_cuda(d, ss, win_off, table, table, table, K, hp)


@pytest.mark.parametrize("wire", [False, True])
def test_row_sums_backward_matches_jax_vjp(monkeypatch, wire):
    vals, rows = _rowsum_inputs(monkeypatch, 10, wire)
    d_out = np.random.default_rng(11).normal(size=(B, vals.shape[0])).astype(np.float32)
    jrows = jst.wire_rows(jnp.asarray(rows))
    _, vjp = jax.vjp(lambda v: jst.row_sums_sorted(v, jrows, B), jnp.asarray(vals))
    want = np.asarray(vjp(jnp.asarray(d_out))[0])
    tvals = torch.from_numpy(vals).requires_grad_(True)
    tst.row_sums_sorted(tvals, tst.wire_rows(torch.from_numpy(rows)), B).backward(
        torch.from_numpy(d_out)
    )
    assert tvals.grad.shape == vals.shape
    np.testing.assert_array_equal(tvals.grad.numpy(), want)


def test_backwards_pass_gradcheck():
    """Both backwards against finite differences in float64, on a tiny
    plan with repeated slots and repeated rows."""
    rng = np.random.default_rng(12)
    n_slots, n_rows, n_occ = 64, 5, 24
    ss = torch.from_numpy(np.sort(rng.integers(0, n_slots, n_occ)).astype(np.int32))
    ss[3:6] = ss[2]
    table = torch.from_numpy(rng.normal(size=(n_slots, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: tst.table_gather_sorted(t, ss, torch.zeros(1, dtype=torch.int32)), (table,)
    )
    rows = torch.from_numpy(rng.integers(0, n_rows, n_occ).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(8, n_occ))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: tst.row_sums_sorted(v, rows, n_rows), (vals,))

