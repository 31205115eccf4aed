"""PyTorch port, the training slice's two table kernels
(xflow_tpu_torch/ops/sorted_table.py) held against the JAX package on the
same numpy inputs, through their plain versions:

- the windowed scatter-add (`scatter_sorted`, kernel #4) against
  `_scatter_xla`, the VJP of JAX `table_gather_sorted` (logical and
  packed tables) and `_scatter_pallas` in interpret mode, bf16 off and
  on: 1e-4 relative over a 1e-2 floor, 2^-7 in bf16 mode
  (kernel_parity's scatter tolerances: the sums run in other orders);
- the fused scatter + FTRL (`scatter_ftrl_sorted`, kernel #3) against
  JAX `scatter_ftrl_sorted` (its CPU composition) and
  `_scatter_ftrl_pallas` in interpret mode: 1e-3 relative over a 1e-4
  floor for w, n and z (kernel_parity's scatter_ftrl_*), and w of the
  never-touched upper half of the table kept bitwise.

Cases hold repeated slots inside one window, masked occurrences (d = 0)
and pads at slot S-1. Small shapes: S = 2^14, B = 64 rows of 8
occurrences, v_dim = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import FTRLConfig as JFTRLConfig
from xflow_tpu_torch.config import FTRLConfig
from xflow_tpu_torch.ops import sorted_table as tst

S = 1 << 14
B, F = 64, 8
K = 5  # fused FM row at v_dim = 4
K8 = tst._k8(K)
RTOL, FLOOR = 1e-4, 1e-2
BF16_RTOL = 2.0 ** -7
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4


def _rel(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + floor)))


def _plan(monkeypatch, slots, mask):
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")
    plan = jst.plan_sorted_batch(slots, mask, S)
    monkeypatch.delenv("XFLOW_NO_NATIVE_PLAN")
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    return plan


def _case(monkeypatch, seed, upper_half_zero=False):
    """(plan, d [K8, Np]): masked occurrences and pads carry d = 0; rows
    K..K8 of d hold noise the scatter must ignore. With
    `upper_half_zero`, slots >= S/2 get no gradient at all."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:4] = slots[4:8]  # repeated slots
    slots[8, :4] = slots[8, 4] + np.arange(4)  # neighbours in one window
    slots[9, 0] = S - 1  # a real occurrence where the pads sit
    mask = (rng.random((B, F)) < 0.7).astype(np.float32)
    mask[9, 0] = 1.0
    plan = _plan(monkeypatch, slots, mask)
    d = rng.normal(size=(K8, plan.sorted_slots.shape[0])).astype(np.float32)
    d[:K] *= plan.sorted_mask[None, :]
    if upper_half_zero:
        d[:K] *= (plan.sorted_slots < S // 2)[None, :]
    return plan, d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _interpret():
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_plain_matches_scatter_xla(monkeypatch, seed):
    plan, d = _case(monkeypatch, seed)
    want = np.asarray(jst._scatter_xla(
        jnp.asarray(d), jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off), S, K
    ))
    got = tst.scatter_sorted(_t(d), _t(plan.sorted_slots), _t(plan.win_off), S, K).numpy()
    assert got.shape == (S, K)
    assert _rel(got, want, FLOOR) <= RTOL
    assert np.count_nonzero(np.any(got != 0, axis=1)) > B  # many slots got gradient


@pytest.mark.parametrize("packed", [False, True])
def test_scatter_is_the_gather_vjp_of_jax(monkeypatch, packed):
    plan, d = _case(monkeypatch, 2)
    table = np.random.default_rng(3).normal(size=(S, K)).astype(np.float32)
    jtab = jst.pack_table(jnp.asarray(table)) if packed else jnp.asarray(table)
    pack = jst.pack_of(jtab, K)
    jss, joff = jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off)
    _, vjp = jax.vjp(lambda t: jst.table_gather_sorted(t, jss, joff, False, pack), jtab)
    want = np.asarray(vjp(jnp.asarray(d))[0]).reshape(S, K)
    ttab = _t(table).requires_grad_(True)
    tst.table_gather_sorted(ttab, _t(plan.sorted_slots), _t(plan.win_off)).backward(_t(d))
    assert _rel(ttab.grad.numpy(), want, FLOOR) <= RTOL


@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_plain_matches_pallas_interpret(monkeypatch, bf16):
    plan, d = _case(monkeypatch, 4)
    with _interpret():
        want = np.asarray(jst._scatter_pallas(
            jnp.asarray(d), jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off),
            S, K, bf16,
        ))
    got = tst.scatter_sorted_plain(_t(d), _t(plan.sorted_slots), S, K, bf16).numpy()
    assert _rel(got, want, FLOOR) <= (BF16_RTOL if bf16 else RTOL)


def _edge_slots(case, rng):
    """[B, F] slots of the plans that reach the staged CUDA design's edges
    (its card tests run the same shapes): runs across its staging chunks,
    tiles whose spans start at odd positions, one hot slot."""
    if case == "chunk_cross":  # 40 slots of one tile: runs of about 13
        return rng.integers(4096, 4136, (B, F)).astype(np.int32)
    if case == "odd_starts":  # tile t (256 slots) holds 2t + 1 occurrences
        flat = np.concatenate([t * 256 + np.arange(2 * t + 1) % 3 for t in range(48)])
        return flat.astype(np.int32).reshape(-1, F)
    return np.full((B, F), 12345, np.int32)  # hot: one run of B * F


@pytest.mark.parametrize("case", ["chunk_cross", "odd_starts", "hot"])
@pytest.mark.parametrize("k", [10, 11])
def test_scatter_plain_matches_scatter_xla_at_staging_edges(monkeypatch, case, k):
    """The plain version at the MVM and FM widths on the plans the card
    tests use for the staged kernel's edges, against `_scatter_xla`."""
    rng = np.random.default_rng(7)
    slots = _edge_slots(case, rng)
    mask = (rng.random(slots.shape) < 0.8).astype(np.float32)
    plan = _plan(monkeypatch, slots, mask)
    d = rng.normal(size=(tst._k8(k), plan.sorted_slots.shape[0])).astype(np.float32)
    d[:k] *= plan.sorted_mask[None, :]
    want = np.asarray(jst._scatter_xla(
        jnp.asarray(d), jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off), S, k
    ))
    got = tst.scatter_sorted(_t(d), _t(plan.sorted_slots), _t(plan.win_off), S, k).numpy()
    assert got.shape == (S, k)
    assert _rel(got, want, FLOOR) <= RTOL
    assert np.count_nonzero(got) > 0


def test_staged_scatter_checks_what_its_copies_need():
    """The CUDA scatters copy 16 B aligned pieces and keep a tile's sums in
    shared memory: the check before their launch refuses K out of range,
    an Np that is not a multiple of 4 and a cotangent that does not start
    16 B aligned, and passes a padded plan."""
    ss = torch.zeros(tst.CHUNK, dtype=torch.int32)
    d = torch.zeros((8, tst.CHUNK))
    tst._check_staged(d, ss, K)
    tst._check_staged(torch.zeros((tst.SCATTER_MAX_K, 4)), ss[:4], tst.SCATTER_MAX_K)
    for bad_k in (0, tst.SCATTER_MAX_K + 1):
        with pytest.raises(ValueError, match="staged scatter takes"):
            tst._check_staged(d, ss, bad_k)
    with pytest.raises(ValueError, match="multiple of 4"):
        tst._check_staged(d[:, :-2].contiguous(), ss[:-2].contiguous(), K)
    shifted = torch.zeros(8 * tst.CHUNK + 1)[1:].view(8, tst.CHUNK)  # 4 B past alignment
    with pytest.raises(ValueError, match="16 B aligned"):
        tst._check_staged(shifted, ss, K)


def test_scatter_drops_out_of_range_slots_and_adds_zero_pads():
    d = np.arange(1, 1 + K8 * 6, dtype=np.float32).reshape(K8, 6)
    d[:, 4] = 0.0  # a pad at S-1, after the real occurrence of S-1
    ss = np.array([0, 0, 7, S - 1, S - 1, S + 3], np.int32)
    want = np.asarray(jst._scatter_xla(jnp.asarray(d), jnp.asarray(ss), None, S, K))
    got = tst.scatter_sorted_plain(_t(d), _t(ss), S, K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], d[:K, 0] + d[:K, 1])
    np.testing.assert_array_equal(got[S - 1], d[:K, 3])
    assert np.count_nonzero(got) == 3 * K  # slot S+3 dropped, rows K..K8 ignored


def _ftrl_state(seed):
    """(w, n, z) as kernel_parity builds them: the upper half of the
    table never touched (n = z = 0)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((S, K)) * 0.01).astype(np.float32)
    n = (np.abs(rng.standard_normal((S, K))) * 0.1).astype(np.float32)
    z = (rng.standard_normal((S, K)) * 1e-4).astype(np.float32)
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    return w, n, z


def _check_ftrl(got, want, w0):
    for name, a, b in zip("wnz", got, want):
        assert _rel(a, b, FTRL_FLOOR) <= FTRL_RTOL, name
    # lazy-init guard: no gradient and n = 0 keeps w bitwise
    np.testing.assert_array_equal(np.asarray(got[0])[S // 2:], w0[S // 2:])
    np.testing.assert_array_equal(np.asarray(want[0])[S // 2:], w0[S // 2:])


def test_scatter_ftrl_plain_matches_jax_composition(monkeypatch):
    plan, d = _case(monkeypatch, 5, upper_half_zero=True)
    w, n, z = _ftrl_state(6)
    want = jst.scatter_ftrl_sorted(
        jnp.asarray(d), jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off),
        jnp.asarray(w), jnp.asarray(n), jnp.asarray(z), K, JFTRLConfig(),
    )
    got = tst.scatter_ftrl_sorted(
        _t(d), _t(plan.sorted_slots), _t(plan.win_off), _t(w), _t(n), _t(z), K, FTRLConfig()
    )
    _check_ftrl([t.numpy() for t in got], [np.asarray(a) for a in want], w)
    assert not np.array_equal(got[0].numpy()[: S // 2], w[: S // 2])  # FTRL moved w


@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_ftrl_plain_matches_pallas_interpret(monkeypatch, bf16):
    plan, d = _case(monkeypatch, 7, upper_half_zero=True)
    w, n, z = _ftrl_state(8)
    with _interpret():
        want = jst._scatter_ftrl_pallas(
            jnp.asarray(d), jnp.asarray(plan.sorted_slots), jnp.asarray(plan.win_off),
            jnp.asarray(w), jnp.asarray(n), jnp.asarray(z), K, JFTRLConfig(), bf16,
        )
        want = [np.asarray(a) for a in want]
    got = tst.scatter_ftrl_plain(
        _t(d), _t(plan.sorted_slots), _t(w), _t(n), _t(z), K, FTRLConfig(), bf16
    )
    _check_ftrl([t.numpy() for t in got], want, w)
