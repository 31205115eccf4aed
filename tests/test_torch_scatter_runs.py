"""PyTorch port, the staged scatters' order of adds on long runs
(kernels #4 and #6, `csrc/scatter_staged.cuh`), through their plain
versions (`scatter_sorted_plain`, `scatter_sorted_multi_plain`), which
the card tests and `chip_smoke.py` hold the kernels to bitwise:

- on plans whose runs are all at most SCATTER_RUN_H long (runs of 1-3,
  of H - 1 and of exactly H, at tile and window edges), bitwise equal to
  `zeros` + `index_add_` in plan order, buffer after buffer;
- on plans with longer runs, bitwise equal to a model of the contract
  written out term by term (pieces on the SCATTER_CELL grid in plan
  order, groups of SCATTER_GROUP cells, runs, then the slot's stream);
- on runs of H + 1, runs over several grid pieces and over several
  groups, a hot slot in every row, #6's all-pad buffer and the
  fully-sharded layout (`fullshard_buffers` with `cap`'s pads at slot
  s_local - 1): within the float32 reorder bound of plan order
  (`bench_lab.reorder_err` < 1), and against JAX `_scatter_xla` and
  `_scatter_pallas` / `_scatter_pallas_multi` in interpret mode at
  `test_torch_scatter.py`'s tolerances (1e-4 relative over a 1e-2
  floor, 2^-7 in bf16 mode: the sums run in other orders);
- the all-pad buffer's pads add 0: the sum equals, bitwise, the sum
  without that buffer.

Small shapes: S = 2^14, inputs from a numpy seed, K = 5 and 11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.parallel import sorted_fullshard as tfs
from xflow_tpu_torch.tools.bench_lab import reorder_err

S = 1 << 14
H, CELL, GROUP = tst.SCATTER_RUN_H, tst.SCATTER_CELL, tst.SCATTER_GROUP
RTOL, FLOOR = 1e-4, 1e-2
BF16_RTOL = 2.0 ** -7
CAP = 4 * tst.CHUNK  # a stacked buffer's positions in the crafted plans


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _rel(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + floor)))


def _buffer(rng, runs, cap, fill=200, pads=None):
    """One slot-sorted buffer of `cap` positions: uniform slots (none of
    the runs' slots; `fill` of them, or as many as leave `pads`), a run of
    `n` at each (slot, n) of `runs`, then pads at S - 1."""
    if pads is not None:
        fill = cap - pads - sum(n for _, n in runs)
    pool = np.setdiff1d(np.arange(S - 1), [s for s, _ in runs])
    flat = np.concatenate([rng.choice(pool, fill)]
                          + [np.full(n, s) for s, n in runs]).astype(np.int32)
    assert flat.size <= cap
    return np.sort(np.concatenate([flat, np.full(cap - flat.size, S - 1, np.int32)]))


def _plan(case, rng):
    """(sorted_slots, nbuf, real) of a crafted plan: `real` is 0 at pads."""
    if case == "uniform":  # runs of 1-3, as the main paths' plans
        bufs = [_buffer(rng, [], CAP, pads=100)]
    elif case == "h_minus_1":
        bufs = [_buffer(rng, [(777, H - 1), (4095, H - 1), (4096, H - 1)], 2 * CAP, pads=100)]
    elif case == "exactly_h":  # at a tile edge (256) and a window edge (2048)
        bufs = [_buffer(rng, [(255, H), (256, H), (2047, H), (2048, H), (9000, H)], 2 * CAP,
                        pads=H)]
    elif case == "stacked_short":  # one slot in every buffer, exactly H in each
        bufs = [_buffer(rng, [(777, H), (778, 3)], CAP, pads=100) for _ in range(4)]
    elif case == "h_plus_1":
        bufs = [_buffer(rng, [(777, H + 1), (778, H), (779, H + 1)], 2 * CAP)]
    elif case == "several_pieces":  # runs over 2-9 grid cells, from odd starts
        bufs = [_buffer(rng, [(300, 3 * CELL + 7), (301, 5), (302, 2 * CELL - 1),
                              (4100, 8 * CELL + 3)], 8 * CAP, fill=333)]
    elif case == "several_groups":  # a run over more than one group of cells
        bufs = [_buffer(rng, [(12345, GROUP * CELL + 3 * CELL + 11)], 36 * CAP, fill=500)]
    elif case == "hot_every_row":  # one slot in every row's first field
        slots = rng.integers(0, S, (512, 8)).astype(np.int32)
        slots[:, 0] = 12345
        bufs = [np.sort(np.concatenate([slots.ravel(), np.full(CAP, S - 1, np.int32)]))]
    elif case == "stacked_long":  # long and short runs of one slot across buffers
        bufs = [_buffer(rng, [(777, n), (4100, 3)], CAP)
                for n in (H + 1, 5, 3 * CELL + 1, H)]
    elif case == "all_pad":  # the last of four buffers holds pads only
        bufs = [_buffer(rng, [(777, 40)], CAP) for _ in range(3)]
        bufs.append(np.full(CAP, S - 1, np.int32))
    else:
        raise ValueError(case)
    ss = np.concatenate(bufs)
    real = np.ones(ss.size, np.float32)
    for i, b in enumerate(bufs):
        real[i * b.size:(i + 1) * b.size] = (np.arange(b.size) < np.searchsorted(b, S - 1))
    return ss, len(bufs), real


def _fullshard(D, seed):
    """Column 0's buffers of a fully-sharded batch on a D x 1 mesh (pads at
    slot s_local - 1, mask 0), as (sorted_slots, nbuf, real, s_local)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (256, 8)).astype(np.int32)
    mask = (rng.random(slots.shape) < 0.8).astype(np.float32)
    plan = tst.plan_sorted_batch(slots, mask, S)
    cap = 4 * tst.CHUNK + tst.CHUNK  # slack over 2,048 / D real occurrences, one spare CHUNK
    host = tfs.fullshard_buffers(plan, D, 1, cap, S // D, 2.0, n_real=slots.size)
    return (host["fs_slots"][0].reshape(-1), D, host["fs_mask"][0].reshape(-1), S // D,
            host["fs_off"][0])


def _inputs(case, k, seed=0):
    """(d [K8, Np], sorted_slots, nbuf, num_slots, loc_off): d masked to 0
    at pads, rows k..K8 noise."""
    rng = np.random.default_rng(seed)
    if case.startswith("fullshard"):
        ss, nbuf, real, num_slots, loc = _fullshard(int(case[-1]), seed)
    else:
        ss, nbuf, real = _plan(case, rng)
        num_slots = S
        cap = ss.size // nbuf
        loc = np.stack([np.searchsorted(ss[i * cap:(i + 1) * cap],
                                        np.arange(0, S + 1, jst.WINDOW)) for i in range(nbuf)])
        loc[:, -1] = cap
    d = rng.normal(size=(tst._k8(k), ss.size)).astype(np.float32)
    d[:k] *= real[None, :]
    return d, ss.astype(np.int32), nbuf, num_slots, loc.astype(np.int32)


def _plain(d, ss, nbuf, num_slots, loc, k, bf16=False):
    if nbuf == 1:
        return tst.scatter_sorted_plain(_t(d), _t(ss), num_slots, k, bf16).numpy()
    return tst.scatter_sorted_multi_plain(_t(d), _t(ss), _t(loc), num_slots, k, bf16).numpy()


def _plan_order(d, ss, num_slots, k):
    return torch.zeros((num_slots, k)).index_add_(0, _t(ss).long(), _t(d[:k]).T).numpy()


def _longest_run(ss, nbuf):
    cap = ss.size // nbuf
    best = 0
    for i in range(nbuf):
        _, counts = np.unique(ss[i * cap:(i + 1) * cap], return_counts=True)
        best = max(best, int(counts.max()))
    return best


def _contract(d, ss, nbuf, num_slots, k):
    """The order of adds written out: a run of at most H terms one by one;
    a longer run as its pieces (the run's positions in one CELL of the
    stream) summed from 0, the pieces of each GROUP of cells from 0, the
    groups from 0; each slot's items in stream order from 0."""
    cap = ss.size // nbuf
    out = np.zeros((num_slots, k), np.float32)
    j = 0
    while j < ss.size:
        e = j + 1
        while e < ss.size and ss[e] == ss[j] and e % cap:
            e += 1
        s = ss[j]
        if 0 <= s < num_slots:
            if e - j <= H:
                for y in range(j, e):
                    out[s] = out[s] + d[:k, y]
            else:
                groups = {}
                for c in range(j // CELL, (e - 1) // CELL + 1):
                    piece = np.zeros(k, np.float32)
                    for y in range(max(j, c * CELL), min(e, (c + 1) * CELL)):
                        piece = piece + d[:k, y]
                    groups[c // GROUP] = groups.get(c // GROUP, np.zeros(k, np.float32)) + piece
                total = np.zeros(k, np.float32)
                for g in sorted(groups):
                    total = total + groups[g]
                out[s] = out[s] + total
        j = e
    return out


SHORT = ("uniform", "h_minus_1", "exactly_h", "stacked_short")
LONG = ("h_plus_1", "several_pieces", "several_groups", "hot_every_row", "stacked_long",
        "all_pad", "fullshard_1", "fullshard_4")


@pytest.mark.parametrize("case", SHORT)
@pytest.mark.parametrize("k", [5, 11])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_is_plan_order_when_no_run_is_long(case, k, bf16):
    d, ss, nbuf, num_slots, loc = _inputs(case, k)
    assert _longest_run(ss, nbuf) <= H
    terms = d.copy()
    if bf16:
        terms[:k] = _t(d[:k]).to(torch.bfloat16).float().numpy()
    got = _plain(d, ss, nbuf, num_slots, loc, k, bf16)
    np.testing.assert_array_equal(got, _plan_order(terms, ss, num_slots, k))


@pytest.mark.parametrize("case", LONG)
def test_plain_follows_the_contract_on_long_runs(case):
    d, ss, nbuf, num_slots, loc = _inputs(case, 5, seed=1)
    assert _longest_run(ss, nbuf) > H
    got = _plain(d, ss, nbuf, num_slots, loc, 5)
    np.testing.assert_array_equal(got, _contract(d, ss, nbuf, num_slots, 5))


@pytest.mark.parametrize("case", LONG)
@pytest.mark.parametrize("k", [5, 11])
def test_long_runs_within_the_reorder_bound_of_plan_order(case, k):
    d, ss, nbuf, num_slots, loc = _inputs(case, k, seed=2)
    got = _plain(d, ss, nbuf, num_slots, loc, k)
    want = _plan_order(d, ss, num_slots, k)
    assert reorder_err(_t(got), _t(want), _t(d[:k]), _t(ss), num_slots) < 1


JAX_CASES = tuple(c for c in LONG if c != "several_groups")


@pytest.mark.parametrize("case", JAX_CASES)
def test_long_runs_match_scatter_xla(case):
    d, ss, nbuf, num_slots, loc = _inputs(case, 11, seed=3)
    want = np.asarray(jst._scatter_xla(jnp.asarray(d), jnp.asarray(ss), None, num_slots, 11))
    got = _plain(d, ss, nbuf, num_slots, loc, 11)
    assert _rel(got, want, FLOOR) <= RTOL
    assert np.count_nonzero(got) > 0


def test_a_run_over_several_groups_matches_scatter_xla_within_the_reorder_bound():
    """A run of 16,395 unit normal terms: its channels' sums pass near 0,
    where any two float32 orders part by more than 1e-4 over a 1e-2 floor,
    so it is held to the reorder bound of the same terms."""
    d, ss, nbuf, num_slots, loc = _inputs("several_groups", 11, seed=3)
    want = np.asarray(jst._scatter_xla(jnp.asarray(d), jnp.asarray(ss), None, num_slots, 11))
    got = _plain(d, ss, nbuf, num_slots, loc, 11)
    assert reorder_err(_t(got), _t(want), _t(d[:11]), _t(ss), num_slots) < 1


def _interpret():
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pallas TPU interpret mode unavailable in this jax build")
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_long_runs_match_pallas_interpret(case, bf16):
    d, ss, nbuf, num_slots, loc = _inputs(case, 5, seed=4)
    with _interpret():
        if nbuf == 1:
            wo = np.searchsorted(ss, np.arange(0, num_slots + 1, jst.WINDOW)).astype(np.int32)
            want = jst._scatter_pallas(jnp.asarray(d), jnp.asarray(ss), jnp.asarray(wo),
                                       num_slots, 5, bf16)
        else:
            want = jst._scatter_pallas_multi(jnp.asarray(d), jnp.asarray(ss), jnp.asarray(loc),
                                             num_slots, 5, ss.size // nbuf, bf16)
        want = np.asarray(want)
    got = _plain(d, ss, nbuf, num_slots, loc, 5, bf16)
    assert _rel(got, want, FLOOR) <= (BF16_RTOL if bf16 else RTOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_all_pad_buffer_adds_zero(bf16):
    d, ss, nbuf, num_slots, loc = _inputs("all_pad", 11, seed=5)
    cap = ss.size // nbuf
    assert not d[:11, -cap:].any()
    got = _plain(d, ss, nbuf, num_slots, loc, 11, bf16)
    without = tst.scatter_sorted_multi_plain(
        _t(d[:, :-cap]), _t(ss[:-cap]), _t(loc[:-1]), num_slots, 11, bf16).numpy()
    np.testing.assert_array_equal(got, without)
    assert np.count_nonzero(got[S - 1]) == 0  # every term at S - 1 is a pad
