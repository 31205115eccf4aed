"""PyTorch port, the row sum's order (#2, `csrc/row_sums.cu`) on the CPU.

The TPU kernel `_rowsum_pallas` adds `out[r] += vt[i]` for i in plan order
from zero, in one sequential grid step. The port's plain version
(`row_sums_plain`: `index_add_`, which adds in index order on the CPU)
gives the same sums bit for bit, and so must the CUDA kernel, whose
order is modelled here in plain torch: count each row's in-range nonzero
terms, place the terms in their rows' segments in any order (hypothesis
draws the order), rank each row's terms by plan position (a warp's rank
up to ROW_SUMS_WARP_MAX terms; beyond, a block's bitmap of
ROW_SUMS_WINDOW positions, window by window from the row's least
position), drop the all-zero terms and add the rest in order from +0.

Tolerance: none. Every comparison is `np.array_equal` / `torch.equal`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hst

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu_torch.ops import sorted_table as st

CHUNK = jst.CHUNK


def _values(rng, ch, np_):
    """[ch, np_] float32 of either sign over 1e-3..1e3."""
    v = rng.choice([-1.0, 1.0], (ch, np_)) * 10.0 ** rng.uniform(-3, 3, (ch, np_))
    return v.astype(np.float32)


def _plan(seed, ch, n_chunks, num_rows, pad=CHUNK // 2, masked=0.2):
    """A plan of `n_chunks` x CHUNK positions: rows shuffled over
    [0, num_rows), a share of them masked (value 0), then `pad` pads at
    row 0 with value 0."""
    rng = np.random.default_rng(seed)
    np_ = n_chunks * CHUNK
    rows = rng.integers(0, num_rows, np_).astype(np.int32)
    vals = _values(rng, ch, np_)
    vals[:, rng.random(np_) < masked] = 0.0
    rows[np_ - pad:] = 0
    vals[:, np_ - pad:] = 0.0
    return vals, rows


def kernel_order_model(vals_t: torch.Tensor, rows: torch.Tensor, num_rows: int,
                       placement: np.ndarray, window: int = st.ROW_SUMS_WINDOW) -> torch.Tensor:
    """The CUDA kernel's sums in plain torch. `placement` is a permutation
    of the plan's positions: the order in which the place step's integer
    atomics hand out the slots of each row's segment."""
    ch, np_ = vals_t.shape
    rows_np = rows.numpy().astype(np.int64)
    nonzero = (vals_t != 0).any(dim=0).numpy()
    counted = (rows_np >= 0) & (rows_np < num_rows) & nonzero
    counts = np.bincount(rows_np[counted], minlength=num_rows)
    segments = [[] for _ in range(num_rows)]
    for j in placement:
        if counted[j]:
            segments[rows_np[j]].append(int(j))
    assert [len(s) for s in segments] == counts.tolist()
    orders = []
    for seg in segments:
        js = np.asarray(seg, np.int64)
        if js.size <= st.ROW_SUMS_WARP_MAX:
            # a lane's rank: the count of the row's smaller js
            rank = (js[None, :] < js[:, None]).sum(axis=1)
            order = np.empty_like(js)
            order[rank] = js
        else:
            order = _windows(js, window)
        orders.append(order)
    out = torch.zeros((num_rows, ch), dtype=torch.float32)
    depth = max((len(o) for o in orders), default=0)
    for k in range(depth):  # the k-th term of every row that has one
        r = [i for i, o in enumerate(orders) if len(o) > k]
        j = [int(orders[i][k]) for i in r]
        out[r] = out[r] + vals_t[:, j].T
    return out


def _windows(js: np.ndarray, window: int = st.ROW_SUMS_WINDOW) -> np.ndarray:
    """A long row's order: window by window of `window` positions from
    its least j (the next window from the least j past the last), each
    window's positions read off a bitmap, so in ascending order."""
    out, lo = [], int(js.min())
    while True:
        bitmap = np.zeros(window, bool)
        inside = js[(js >= lo) & (js < lo + window)]
        assert inside.size > 0
        bitmap[inside - lo] = True
        out.append(lo + np.flatnonzero(bitmap))
        later = js[js >= lo + window]
        if later.size == 0:
            return np.concatenate(out)
        lo = int(later.min())


@pytest.mark.parametrize("seed, ch, n_chunks, num_rows", [
    (0, 8, 4, 64), (1, 24, 3, 48), (2, 16, 6, 16), (3, 32, 2, 200),
])
def test_row_sums_plain_is_bitwise_the_interpreted_tpu_kernel(seed, ch, n_chunks, num_rows):
    """`row_sums_plain` against `_rowsum_pallas` run as the JAX package's
    tests run it on the CPU: several chunks, shuffled rows, values over
    1e-3..1e3, masked zeros and the pad run at row 0."""
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    vals, rows = _plan(seed, ch, n_chunks, num_rows)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jst._rowsum_pallas(jnp.asarray(vals), jnp.asarray(rows), num_rows))
    got = st.row_sums_plain(torch.from_numpy(vals), torch.from_numpy(rows), num_rows).numpy()
    assert np.array_equal(got, want)
    ref = np.zeros((num_rows, ch), np.float32)
    np.add.at(ref, rows, vals.T)  # float32, one term at a time in index order
    assert np.array_equal(got, ref)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=hst.data())
def test_kernel_order_model_is_bitwise_the_plain_version(data):
    """Any placement of a small plan's terms (hypothesis draws it), rows
    inside and outside [0, B), masked zeros, a pad run at row 0 and rows
    longer than a warp orders."""
    seed = data.draw(hst.integers(0, 2**16), label="plan seed")
    num_rows = data.draw(hst.integers(1, 24), label="rows")
    np_ = 4 * data.draw(hst.integers(1, 160), label="position quads")
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, num_rows + 3, np_).astype(np.int32)
    rows[rng.random(np_) < 0.1] = 2**31 - 1
    vals = _values(rng, 8, np_)
    vals[:, rng.random(np_) < 0.2] = 0.0
    pad = data.draw(hst.integers(0, np_ // 2), label="pads")
    rows[np_ - pad:] = 0
    vals[:, np_ - pad:] = 0.0
    placement = np.asarray(data.draw(hst.permutations(range(np_)), label="placement"))
    v, r = torch.from_numpy(vals), torch.from_numpy(rows)
    assert torch.equal(kernel_order_model(v, r, num_rows, placement),
                       st.row_sums_plain(v, r, num_rows))


@settings(max_examples=4, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(order_seed=hst.integers(0, 2**32 - 1))
def test_kernel_order_model_on_a_row_of_4096_terms(order_seed):
    """One row of 4,096 nonzero terms and one of 9,000, rows outside [0,
    B) and a pad run at row 0, under a drawn placement; with windows of
    4,096 positions as well (both long rows span several)."""
    rng = np.random.default_rng(3)
    np_, num_rows, ch = 1 << 15, 64, 4
    rows = rng.integers(3, num_rows, np_).astype(np.int32)
    pos = rng.permutation(np_ - 1024)
    rows[pos[:4096]] = 1
    rows[pos[4096:13096]] = 2
    rows[pos[13096:13196]] = -7
    rows[pos[13196:13296]] = num_rows
    vals = _values(rng, ch, np_)
    rows[np_ - 1024:] = 0
    vals[:, np_ - 1024:] = 0.0
    placement = np.random.default_rng(order_seed).permutation(np_)
    v, r = torch.from_numpy(vals), torch.from_numpy(rows)
    want = st.row_sums_plain(v, r, num_rows)
    for window in (st.ROW_SUMS_WINDOW, 4096):
        got = kernel_order_model(v, r, num_rows, placement, window)
        assert torch.equal(got, want)
    assert torch.equal(got[0], torch.zeros(ch))


@settings(max_examples=3, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(order_seed=hst.integers(0, 2**32 - 1))
def test_kernel_order_model_on_a_zero_run_as_long_as_the_plan(order_seed):
    """A row-0 run of zeros as long as the real plan (a fully-sharded
    buffer's pads): none of it is counted, placed or added."""
    rng = np.random.default_rng(4)
    real, num_rows, ch = 4096, 256, 8
    rows = np.concatenate([rng.integers(0, num_rows, real), np.zeros(real)]).astype(np.int32)
    vals = np.concatenate([_values(rng, ch, real), np.zeros((ch, real), np.float32)], axis=1)
    vals[:, :real][:, rng.random(real) < 0.1] = -0.0
    placement = np.random.default_rng(order_seed).permutation(2 * real)
    v, r = torch.from_numpy(vals), torch.from_numpy(rows)
    assert torch.equal(kernel_order_model(v, r, num_rows, placement),
                       st.row_sums_plain(v, r, num_rows))


def test_a_dropped_zero_term_changes_no_sum():
    """The drop is exact: a sum begun at +0 never becomes -0, so adding
    +-0 leaves it as it is, cancellation to zero included."""
    terms = np.float32([1.5, -1.5, -0.0, 0.0, 2.0**-149, -(2.0**-149), -0.0])
    acc = np.float32(0.0)
    kept = np.float32(0.0)
    for t in terms:
        acc = np.float32(acc + t)
        if t != 0:
            kept = np.float32(kept + t)
    assert acc.tobytes() == kept.tobytes() == np.float32(0.0).tobytes()
