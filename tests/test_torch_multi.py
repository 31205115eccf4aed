"""PyTorch port, stacked plans and the multi-buffer table kernels
(xflow_tpu_torch/ops/sorted_table.py) held against the JAX package on the
same numpy inputs:

- `plan_sorted_stacked` bitwise against the JAX numpy planner, fields on
  and off, NS in {1, 2, 4}, `always_stack`; `auto_sub_batches` and
  `resolve_sub_batches` over a grid of batch sizes, models and
  `mvm_exclusive` values, including the error;
- the multi-buffer gather's plain version (kernel #5) bit-exact against
  `_gather_xla` on the flattened stream and `_gather_pallas_multi` in
  interpret mode, bf16 off and on;
- the multi-buffer scatter's plain version (kernel #6) against
  `_scatter_xla` and `_scatter_pallas_multi` in interpret mode: 1e-4
  relative over a 1e-2 floor, 2^-7 in bf16 mode (kernel_parity's scatter
  tolerances: the sums run in other orders);
- the port's backward against `jax.vjp` of `table_gather_sorted_multi`
  on a logical and a packed JAX table, and `gradcheck` in float64;
- the wrapper rules: CPU tensors launch nothing, the `_cuda` wrappers
  refuse CPU tensors, a bad `loc_off` raises.

Small shapes: S = 2^14, B = 64 rows of 8 occurrences, K = 4 (and 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.ops import sorted_table as tst

S = 1 << 14
B, F = 64, 8
RTOL, FLOOR = 1e-4, 1e-2
BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _numpy_planner(monkeypatch):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + floor)))


def _batch(seed, all_pad_rows=0):
    """[B, F] slots, mask and fields: repeated slots across sub-batches
    (rows 0..3 repeat rows 32..35), masked occurrences, and optionally the
    last `all_pad_rows` rows fully masked (an all-pad sub-batch)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:4] = slots[32:36]
    slots[5, 0] = S - 1
    mask = (rng.random((B, F)) < 0.8).astype(np.float32)
    if all_pad_rows:
        mask[-all_pad_rows:] = 0.0
    fields = rng.integers(0, 18, (B, F)).astype(np.int32)
    return slots, mask, fields


@pytest.mark.parametrize("ns", [1, 2, 4])
@pytest.mark.parametrize("with_fields", [False, True])
@pytest.mark.parametrize("always_stack", [False, True])
def test_plan_stacked_bitwise_equal_to_jax(ns, with_fields, always_stack):
    slots, mask, fields = _batch(ns + 10 * with_fields)
    f = fields if with_fields else None
    want = jst.plan_sorted_stacked(slots, mask, S, fields=f, num_sub=ns,
                                   always_stack=always_stack)
    got = tst.plan_sorted_stacked(slots, mask, S, fields=f, num_sub=ns,
                                  always_stack=always_stack)
    stacked = ns > 1 or always_stack
    for name in ("sorted_slots", "sorted_row", "sorted_mask", "win_off", "sorted_fields"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
        assert a.ndim == (2 if stacked else 1), name
    if stacked:  # the loc_off contract of the multi-buffer kernels
        assert (got.win_off[:, -1] == got.sorted_slots.shape[1]).all()
    with pytest.raises(ValueError, match="not divisible"):
        tst.plan_sorted_stacked(slots[:63], mask[:63], S, num_sub=2)


def test_sub_batch_resolution_matches_jax():
    for bs in (64, 1000, 1024, 4096, 65536, 131072, 1 << 20):
        for per_row in (0, 96, 792, 4 * 18 * 74):
            assert tst.auto_sub_batches(bs, per_row) == jst.auto_sub_batches(bs, per_row)
    for bs in (64, 4096, 65536, 262144):
        for model in ("fm", "mvm", "ffm", "lr"):
            for excl in ("auto", "on", "off"):
                for ns in (0, 1, 2, 4):
                    pairs = {"model.name": model, "model.mvm_exclusive": excl,
                             "data.batch_size": bs, "data.sorted_sub_batches": ns}
                    got = tst.resolve_sub_batches(override(Config(), **pairs))
                    assert got == jst.resolve_sub_batches(joverride(JConfig(), **pairs)), pairs
    assert tst.resolve_sub_batches(override(Config(), **{
        "model.name": "mvm", "model.mvm_exclusive": "off", "data.batch_size": 65536})) == 4
    for mod, cfg_cls, ov in ((tst, Config, override), (jst, JConfig, joverride)):
        with pytest.raises(ValueError, match="must divide batch_size"):
            mod.resolve_sub_batches(ov(cfg_cls(), **{
                "data.batch_size": 64, "data.sorted_sub_batches": 3}))


def _stream(seed, ns=4, k=4, all_pad_rows=0):
    """A stacked plan's flattened stream: (slots [ns*cap], loc_off
    [ns, S/W+1], cap, table [S, k], d [K8, ns*cap] with masked
    occurrences and pads at 0, rows k..K8 noise)."""
    slots, mask, _ = _batch(seed, all_pad_rows)
    plan = jst.plan_sorted_stacked(slots, mask, S, num_sub=ns)
    cap = plan.sorted_slots.shape[1]
    rng = np.random.default_rng(seed + 100)
    table = rng.normal(size=(S, k)).astype(np.float32)
    k8 = tst._k8(k)
    d = rng.normal(size=(k8, ns * cap)).astype(np.float32)
    d[:k] *= plan.sorted_mask.reshape(1, -1)
    return plan.sorted_slots.reshape(-1), plan.win_off, cap, table, d


def _interpret():
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("k", [4, 10])
def test_gather_multi_plain_bitwise_equal_to_gather_xla(k):
    ss, loc, cap, table, _ = _stream(1, k=k)
    want = np.asarray(jst._gather_xla(jnp.asarray(table), jnp.asarray(ss), None))
    want_op = np.asarray(jst.table_gather_sorted_multi(
        jnp.asarray(table), jnp.asarray(ss), jnp.asarray(loc)))
    got = tst.table_gather_sorted_multi(_t(table), _t(ss), _t(loc)).numpy()
    assert got.shape == (tst._k8(k), 4 * cap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_op)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_multi_plain_matches_pallas_interpret(bf16):
    ss, loc, cap, table, _ = _stream(2, all_pad_rows=16)  # the last buffer is all pads
    with _interpret():
        want = np.asarray(jst._gather_pallas_multi(
            jnp.asarray(table), jnp.asarray(ss), jnp.asarray(loc), cap, bf16))
    got = tst.gather_sorted_multi_plain(_t(table), _t(ss), _t(loc), bf16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [4, 10, 11])
def test_scatter_multi_plain_matches_scatter_xla(k):
    ss, loc, _, _, d = _stream(3, k=k)
    want = np.asarray(jst._scatter_xla(jnp.asarray(d), jnp.asarray(ss), None, S, k))
    got = tst.scatter_sorted_multi(_t(d), _t(ss), _t(loc), S, k).numpy()
    assert got.shape == (S, k)
    assert _rel(got, want, FLOOR) <= RTOL
    # the slot every sub-batch shares sums all four buffers' terms
    assert np.count_nonzero(np.any(got != 0, axis=1)) > B


@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_multi_plain_matches_pallas_interpret(bf16):
    ss, loc, cap, _, d = _stream(4, all_pad_rows=16)
    with _interpret():
        want = np.asarray(jst._scatter_pallas_multi(
            jnp.asarray(d), jnp.asarray(ss), jnp.asarray(loc), S, 4, cap, bf16))
    got = tst.scatter_sorted_multi_plain(_t(d), _t(ss), _t(loc), S, 4, bf16).numpy()
    assert _rel(got, want, FLOOR) <= (BF16_RTOL if bf16 else RTOL)


def test_scatter_multi_plain_sums_in_stream_order():
    """The plain version adds a slot's terms buffer by buffer, each run in
    plan order from 0: the order the CUDA kernel keeps, so the two agree
    bitwise on the CPU."""
    ss, loc, cap, _, d = _stream(5)
    got = tst.scatter_sorted_multi_plain(_t(d), _t(ss), _t(loc), S, 4).numpy()
    want = np.zeros((S, 4), np.float32)
    for j in range(ss.shape[0]):
        want[ss[j]] += d[:4, j]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_backward_matches_jax_vjp(packed):
    ss, loc, _, table, d = _stream(6)
    K = table.shape[1]
    jtab = jst.pack_table(jnp.asarray(table)) if packed else jnp.asarray(table)
    pack = jst.pack_of(jtab, K)
    jss, jloc = jnp.asarray(ss), jnp.asarray(loc)
    _, vjp = jax.vjp(lambda t: jst.table_gather_sorted_multi(t, jss, jloc, False, pack), jtab)
    want = np.asarray(vjp(jnp.asarray(d))[0]).reshape(S, K)
    ttab = _t(table).requires_grad_(True)
    tst.table_gather_sorted_multi(ttab, _t(ss), _t(loc)).backward(_t(d))
    assert _rel(ttab.grad.numpy(), want, FLOOR) <= RTOL


def test_gradcheck():
    """The multi-buffer gather's backward against finite differences in
    float64: two buffers over a 2-window table, a slot in both."""
    n_slots, cap = 2 * tst.WINDOW, tst.CHUNK
    rng = np.random.default_rng(7)
    bufs, offs = [], []
    for _ in range(2):
        s = np.sort(rng.integers(0, n_slots, 40)).astype(np.int32)
        s[:3] = 17
        s = np.sort(np.concatenate([s, np.full(cap - 40, n_slots - 1, np.int32)]))
        bufs.append(s)
        offs.append(np.searchsorted(s, np.arange(0, n_slots + 1, tst.WINDOW)).astype(np.int32))
    ss, loc = _t(np.concatenate(bufs)), _t(np.stack(offs))
    table = torch.from_numpy(rng.normal(size=(n_slots, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: tst.table_gather_sorted_multi(t, ss, loc), (table,)
    )


def test_wrapper_rules():
    ss, loc, cap, table, d = _stream(8)
    t, s, lo, dd = _t(table), _t(ss), _t(loc), _t(d)
    before = dict(tst.LAUNCHES)
    tst.table_gather_sorted_multi(t, s, lo)
    tst.scatter_sorted_multi(dd, s, lo, S, 4)
    assert tst.LAUNCHES == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tst.gather_sorted_multi_cuda(t, s, lo)
    with pytest.raises(ValueError, match="CUDA"):
        tst.scatter_sorted_multi_cuda(dd, s, lo, S, 4)
    bad = {
        "columns": lo[:, :-1].contiguous(),
        "buffers": lo[:3].contiguous(),
        "rank": lo.reshape(-1),
        "dtype": lo.long(),
    }
    for why, b in bad.items():
        with pytest.raises((ValueError, TypeError)):
            tst.table_gather_sorted_multi(t, s, b)
        with pytest.raises((ValueError, TypeError)):
            tst.scatter_sorted_multi(dd, s, b, S, 4)
    with pytest.raises(ValueError, match="multiple of"):  # cap not a CHUNK multiple
        tst.gather_sorted_multi_plain(t, s[:-4], lo)
    n = tst.MULTI_MAX_BUFFERS + 1
    with pytest.raises(ValueError, match="at most"):
        tst.gather_sorted_multi_plain(t, torch.zeros(tst.CHUNK * n, dtype=torch.int32),
                                      torch.zeros((n, S // tst.WINDOW + 1), dtype=torch.int32))


def test_sorted_gather_map_stacked_equals_flat():
    """One multi-buffer gather and a row side per sub-batch give the flat
    plan's logits (a row sum is NS-invariant)."""
    slots, mask, _ = _batch(9)
    table = np.random.default_rng(9).normal(size=(S, 4)).astype(np.float32)

    def row_fn(occ, sr, sm, rows):
        return tst.row_sums_sorted((occ[:4] * sm[None, :]).contiguous(), sr, rows).sum(1)

    logits = []
    for ns in (1, 4):
        p = tst.plan_sorted_stacked(slots, mask, S, num_sub=ns)
        batch = {k: _t(getattr(p, k)) for k in ("sorted_slots", "sorted_row", "sorted_mask",
                                                "win_off")}
        logits.append(tst.sorted_gather_map(_t(table), batch, ("sorted_row", "sorted_mask"),
                                            B, row_fn, 4, False).numpy())
    assert logits[1].shape == (B,)
    np.testing.assert_allclose(logits[1], logits[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="logical width"):
        tst.sorted_gather_map(_t(table), batch, (), B, row_fn, 5, False)
