"""PyTorch port on the card: each CUDA kernel (xflow_tpu_torch/csrc) held
against its plain version on crafted plans the chip smoke's random data
does not reach, and the train step and `Trainer.fit` on the card against
the CPU. Every test needs a CUDA card and skips without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the root conftest pins JAX, which the card's machine
does not have; nothing here imports JAX.)

The scatters (#4, and #6 at 1, 4 and the most stacked buffers) also run
on the edges of their staged design: runs across 160-position staging
chunks, spans longer than a chunk (in one buffer and split over all of
them), spans that start at odd positions (not 16 B aligned), a buffer
empty in a window next to one with a long span there, at K = 5, 10, 11
and 73 (the MVM, FM and FFM widths); and on the long-run split: runs of
SCATTER_RUN_H - 1, SCATTER_RUN_H and SCATTER_RUN_H + 1, runs across
chunk, cell and tile edges and across a buffer's end, and a run of
40,000 (more than one group of cells), at K = 10, 11 and 73. The multi-buffer kernels (#5 gather, #6
scatter) run on stacked plans: a slot every buffer shares, windows empty
in some buffers, an all-pad buffer, a hot slot of 2,048 occurrences
across the buffers, both table ends. The fused scatter + FTRL (#3) runs
on the scatters' plans and on its own edges at K = 5, 10, 11 and 73, bf16
off and on: runs longer than a 32-position piece and than a staging
chunk, the 65,536-occurrence hot slot, windows with no occurrence, and
slots below 0 and at or above S; each bitwise across two launches, w kept
bitwise on never-touched entries, and its non-finite count equal to
torch's count of its outputs and to its plain version's (0 on clean
data; NaN and +-Inf placed in d, w, n and z by one test). The row sum (#2) runs at ch = 24,
32, 104, 128 and 136 (one to five staging passes) and at ch 464, with
rows out of range and whole zero quads; on rows at and past the warp's
limit (ROW_SUMS_WARP_MAX), rows of 1,000 to 20,000 terms, a row spread
over two of the long rows' windows (ROW_SUMS_WINDOW), and on a pad run as
long as the real plan beside 256 rows of 200 terms; it refuses a ch that
is not a multiple of 4, and FM's forward runs at v_dim = 64 against the
CPU. FFM's steps (the aligned hybrid at K = 73,
and the row-major route of a batch that repeats a field) and LR's steps
(no hand-written kernel) run on
the card against the CPU. The lab's kernels (#7-#11, `ops/lab.py`) run
at the mosaic probe's shapes with one slice out of range (#7 also at the
grids that split a window into 64 pieces and into none), #11 at one to
34 quads and at B 512, 65,536 and 2^18 (a quad column of 4 MiB), and
`kernel_parity` runs whole. The server's runner runs on the card against
the CPU, through a reload under a predict loop, and returns the old
generation's memory. The async checkpoint snapshot keeps the cadence
step's state bitwise while later steps run, in pinned buffers it reuses,
with no card memory of its own; a tail fit with async saves and
publications matches the CPU's. The multi-buffer gather (#5) also runs on
windows empty in every buffer and on one buffer whose spans all lie in
one window, at 1, 4 and the most stacked buffers.

Tolerances:
- gathers: bitwise (a copy);
- scatters: bitwise against the plain version on the CPU (both add in
  the order of `csrc/scatter_staged.cuh`: a run of at most
  SCATTER_RUN_H terms in plan order from 0, buffer after buffer; a
  longer run by its pieces on a fixed grid, joined in order, so the hot
  and all-pad cases check that order), and bitwise across two launches;
  on terms whose sums are exact in any order (`_dyadic`), bitwise
  against a plan-order `index_add_`;
- scatter + FTRL: 1e-3 relative over a 1e-4 floor (kernel_parity's
  scatter_ftrl_*) where finite, non-finite entries at the same places,
  w of never-touched entries bitwise. #3 sums a run as a fixed tree and
  the plain version in plan order; on #3's own crafted plans d holds
  multiples of 2^-6 in [-1, 1], whose sums are exact in any order (see
  `_dyadic`);
- row sum (#2): bitwise against its plain version on CPU copies (both
  add a row's terms in plan order from +0) and bitwise across two
  launches; the lab's row sum (#11, float atomics) within the float32
  reorder bound alone (`bench_lab.reorder_err` < 1: a row of many
  unit-scale terms reorders past 1e-4 over that floor), the relative
  error printed beside it;
- the lab's slice probes: bitwise (copies);
- steps and fits: loss within 1e-5 relative, state within the FTRL
  tolerance.
"""

import numpy as np
import pytest
import torch

from xflow_tpu_torch.config import Config, FTRLConfig, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.evaluate import to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops import sorted_table as st
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.tools.bench_lab import reorder_err
from xflow_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

S = 1 << 14
RTOL, FLOOR = 1e-4, 1e-2
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _rel(got, want, floor):
    return ((got.double().cpu() - want.double().cpu()).abs()
            / (want.double().cpu().abs() + floor)).max().item()


def _odd_starts():
    """Tile t (of 256 slots) holds 2t + 1 occurrences, so the tiles'
    spans start at odd plan positions, none 16 B aligned after the first."""
    flat = np.concatenate([t * 256 + np.arange(2 * t + 1) % 3 for t in range(48)])
    return flat.astype(np.int32).reshape(-1, 8)  # 48^2 = 2,304 occurrences


def _slots(case, rng, rows=64):
    """[B, F] slots of a crafted plan."""
    if case == "hot":  # one slot in every occurrence: a run of B * F
        return np.full((512, 4), 12345, np.int32)
    if case == "edges":  # tile (256) and window (2048) boundaries, both table ends
        edge = np.array([0, 1, 255, 256, 257, 2047, 2048, 2049, S - 2049, S - 2048,
                         S - 257, S - 256, S - 2, S - 1], np.int32)
        return np.tile(edge, (16, 1))
    if case == "chunk_cross":  # 40 slots of one tile: a 2,048-position span
        # whose runs of about 51 cross the staging chunks' boundaries
        return rng.integers(4096, 4136, (rows * 4, 8)).astype(np.int32)
    if case == "odd_starts":
        return _odd_starts()
    return rng.integers(0, S, (rows, 8)).astype(np.int32)


def _inputs(case, k, seed=0):
    rng = np.random.default_rng(seed)
    slots = _slots(case, rng)
    mask = (rng.random(slots.shape) < 0.8).astype(np.float32)
    plan = st.plan_sorted_batch(slots, mask, S)
    k8 = st._k8(k)
    d = rng.normal(size=(k8, plan.sorted_slots.shape[0])).astype(np.float32)
    d[:k] *= plan.sorted_mask[None, :]  # rows k..k8 keep noise to be ignored
    return plan, torch.from_numpy(d)


# k = 10 and 11: the MVM and FM main paths' widths; FFM's 73 below
SHAPES = ("random", "hot", "edges", "chunk_cross", "odd_starts")
CASES = [(c, k) for c in SHAPES for k in (5, 10, 11)]
FFM_CASES = [(c, 73) for c in SHAPES]


@pytest.mark.parametrize("case, k", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_kernel_bitwise_equal_to_plain(dev, case, k, bf16):
    plan, d = _inputs(case, k)
    ss, wo = torch.from_numpy(plan.sorted_slots), torch.from_numpy(plan.win_off)
    got = st.scatter_sorted_cuda(d.to(dev), ss.to(dev), wo.to(dev), S, k, bf16)
    again = st.scatter_sorted_cuda(d.to(dev), ss.to(dev), wo.to(dev), S, k, bf16)
    want = st.scatter_sorted_plain(d, ss, S, k, bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    assert _rel(got, st.scatter_sorted_plain(d.to(dev), ss.to(dev), S, k, bf16), FLOOR) <= RTOL


@pytest.mark.parametrize("case, k", FFM_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_kernel_bitwise_equal_to_plain_at_ffm_width(dev, case, k, bf16):
    """#4 at FFM's K = 73 (128-slot tiles, 20-position chunks): bitwise
    against the CPU plain version and across two launches; against the
    card's plain version within the float32 reorder bound
    (`reorder_err` < 1), as its atomics add in another order (a hot run
    of 2,048 unit terms over 73 channels reorders past 1e-4 over 1e-2)."""
    plan, d = _inputs(case, k)
    ss, wo = torch.from_numpy(plan.sorted_slots), torch.from_numpy(plan.win_off)
    got = st.scatter_sorted_cuda(d.to(dev), ss.to(dev), wo.to(dev), S, k, bf16)
    again = st.scatter_sorted_cuda(d.to(dev), ss.to(dev), wo.to(dev), S, k, bf16)
    want = st.scatter_sorted_plain(d, ss, S, k, bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    card = st.scatter_sorted_plain(d.to(dev), ss.to(dev), S, k, bf16)
    terms = d[:k].to(torch.bfloat16).float() if bf16 else d[:k]
    assert reorder_err(got, card, terms, ss, S) < 1


def _ftrl_state(k, seed=2):
    """(w, n, z) [S, k] on the CPU; n and z 0 on the upper half, whose
    never-touched entries must keep w bitwise."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((S, k)) * 0.01).astype(np.float32))
    n = torch.from_numpy((np.abs(rng.standard_normal((S, k))) * 0.1).astype(np.float32))
    z = torch.from_numpy((rng.standard_normal((S, k)) * 1e-4).astype(np.float32))
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    return w, n, z


def _check_ftrl_kernel(dev, ss, wo, d, k, bf16, state=None):
    """#3 on one plan against its plain version: w, n, z within the FTRL
    tolerance, bitwise across two launches, w of never-touched entries
    kept bitwise, fresh outputs, and its non-finite count equal to
    torch's count of its outputs and to the plain version's. Returns the
    kernel's outputs."""
    w, n, z = _ftrl_state(k) if state is None else state
    hp = FTRLConfig()
    args = [t.to(dev) for t in (d, ss, wo, w, n, z)]
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    got = st.scatter_ftrl_cuda(*args, k, hp, bf16, count)
    again = st.scatter_ftrl_cuda(*args, k, hp, bf16)
    want_count = torch.zeros(1, dtype=torch.int32)
    want = st.scatter_ftrl_plain(d, ss, w, n, z, k, hp, bf16, want_count)
    torch.cuda.synchronize()
    for a, b in zip(got, again):  # bitwise, NaNs included
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    finite = [torch.isfinite(b) for b in want]
    for name, a, b, f in zip("wnz", got, want, finite):
        assert torch.equal(torch.isfinite(a).cpu(), f), name
        assert _rel(a.cpu()[f], b[f], FTRL_FLOOR) <= FTRL_RTOL, name
    torch_count = sum(int((~torch.isfinite(o)).sum()) for o in got)
    assert int(count) == torch_count == int(want_count)
    lazy = (st.scatter_sorted_plain(d, ss, S, k, bf16) == 0) & (n == 0)
    assert lazy.any() and torch.equal(got[0].cpu()[lazy], w[lazy])
    assert all(o.data_ptr() != i.data_ptr() for o, i in zip(got, args[3:]))
    return got


@pytest.mark.parametrize("case, k", CASES + FFM_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_ftrl_kernel_matches_plain(dev, case, k, bf16):
    plan, d = _inputs(case, k, seed=1)
    ss, wo = torch.from_numpy(plan.sorted_slots), torch.from_numpy(plan.win_off)
    _check_ftrl_kernel(dev, ss, wo, d, k, bf16)


def _sorted_plan(slots, num_slots=S):
    """(sorted_slots, win_off) of flat slots that may lie outside [0,
    num_slots) (the planners refuse those): sorted, padded to a multiple
    of 4 at the last slot, windows by searchsorted."""
    ss = np.sort(np.asarray(slots, np.int32).ravel())
    ss = np.concatenate([ss, np.full(-len(ss) % 4 + 4, num_slots - 1, np.int32)])
    ss.sort()
    wo = np.searchsorted(ss, np.arange(0, num_slots + 1, st.WINDOW)).astype(np.int32)
    return torch.from_numpy(ss), torch.from_numpy(wo)


def _ftrl_plan(case, rng):
    """Crafted (sorted_slots, win_off) for #3's own edges: its tiles (256
    slots at k <= 11, 32 at k = 73), 32-position pieces and 64- to
    512-position chunks."""
    if case == "long_run":  # runs longer than a piece and than a chunk, beside short ones
        flat = np.concatenate([np.full(1500, 300), np.full(45, 301), np.full(33, 299),
                               np.full(700, 4100), rng.integers(0, S, 3000)])
    elif case == "hot_65536":  # the chip smoke's hot slot: a run of 65,536
        flat = np.concatenate([np.full(65536, 12345), rng.integers(0, S, 65536)])
    elif case == "empty_windows":  # windows 1, 2 and 4..7 hold no occurrence
        flat = np.concatenate([rng.integers(0, 2048, 900), rng.integers(6144, 8192, 900)])
    elif case == "out_of_range":  # slots below 0 and at or above S, dropped
        flat = np.concatenate([np.full(37, -3), np.full(5, -1), rng.integers(0, S, 4000),
                               np.full(41, S), np.full(7, S + 999)])
    else:
        raise ValueError(case)
    return _sorted_plan(flat)


FTRL_SHAPES = ("long_run", "hot_65536", "empty_windows", "out_of_range")


def _dyadic(rng, k, np_):
    """d [K8, Np] of multiples of 2^-6 in [-1, 1]: every float32 sum of up
    to 2^17 of them is exact, in any order. #3 sums each run as a tree and
    the plain version in plan order; on unit normals a run of 65,536 terms
    sums to within (n - 1) 2^-24 sum |d| in each order, which FTRL
    magnifies past its tolerance where the run's sum is near 0. Exact sums
    leave no such slack: a lost or misrouted term shows."""
    return torch.from_numpy((rng.integers(-64, 65, (st._k8(k), np_)) / 64.0).astype(np.float32))


@pytest.mark.parametrize("case", FTRL_SHAPES)
@pytest.mark.parametrize("k", [5, 10, 11, 73])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_ftrl_kernel_on_crafted_spans(dev, case, k, bf16):
    rng = np.random.default_rng(7)
    ss, wo = _ftrl_plan(case, rng)
    _check_ftrl_kernel(dev, ss, wo, _dyadic(rng, k, ss.shape[0]), k, bf16)


@pytest.mark.parametrize("k", [5, 10, 11, 73])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_ftrl_kernel_counts_nonfinite(dev, k, bf16):
    """NaN and +-Inf placed in d (a short run, the long run), w, n and z:
    the kernel's count equals torch's count of its outputs and the plain
    version's, and the finite entries agree."""
    rng = np.random.default_rng(11)
    ss, wo = _ftrl_plan("long_run", rng)
    d = _dyadic(rng, k, ss.shape[0])
    at = {int(v): int(np.searchsorted(ss.numpy(), v)) for v in (300, 4100)}
    d[0, at[300] + 17] = float("nan")
    d[k - 1, at[4100] + 5] = float("inf")
    d[k - 1, at[4100] + 6] = -float("inf")
    w, n, z = _ftrl_state(k, seed=12)
    w[77, 0] = float("nan")
    n[S - 5, k - 1] = float("inf")
    z[S // 2 + 9, 0] = -float("inf")
    got = _check_ftrl_kernel(dev, ss, wo, d, k, bf16, (w, n, z))
    assert sum(int((~torch.isfinite(o)).sum()) for o in got) >= 4


@pytest.mark.parametrize("case, k", CASES + FFM_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_gather_and_row_sums_kernels_match_plain(dev, case, k, bf16):
    plan, _ = _inputs(case, k, seed=3)
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(S, k)).astype(np.float32)).to(dev)
    ss = torch.from_numpy(plan.sorted_slots).to(dev)
    occ = st.gather_sorted_cuda(table, ss, bf16)
    assert torch.equal(occ, st.gather_sorted_plain(table, ss, bf16))
    rows = torch.from_numpy(plan.sorted_row).to(dev)
    n_rows = int(plan.sorted_row.max()) + 1
    vals = (occ * torch.from_numpy(plan.sorted_mask).to(dev)[None, :]).contiguous()
    _check_row_sums(vals, rows, n_rows)


def _batch(seed, B=64, F=8):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (B, F)).astype(np.int32)
    slots[:3] = slots[3:6]
    mask = (rng.random((B, F)) < 0.8).astype(np.float32)
    plan = st.plan_sorted_batch(slots, mask, S)
    return st.compact_plan_wire({
        "labels": (rng.random(B) < 0.4).astype(np.float32),
        "row_mask": np.ones(B, np.float32), "sorted_slots": plan.sorted_slots,
        "sorted_row": plan.sorted_row, "sorted_mask": plan.sorted_mask,
        "win_off": plan.win_off,
    }, rows_bound=B)


def _cfg(**extra):
    return override(Config(), **{
        "model.name": "fm", "model.v_dim": 4, "model.num_fields": 8, "data.log2_slots": 14,
        "data.batch_size": 64, "data.max_nnz": 8, **extra,
    })


@pytest.mark.parametrize("extra", [{}, {"optim.fused_scatter": "off"}, {"optim.name": "sgd"},
                                   {"data.sorted_bf16": True}])
def test_train_steps_on_the_card_match_the_cpu(dev, extra):
    cfg = _cfg(**extra)
    model, opt = get_model("fm")(cfg), get_optimizer(cfg.optim.name)
    step = make_train_step(model, opt, cfg)
    from xflow_tpu_torch.train.state import init_state

    cpu = init_state(model, opt, cfg, "cpu")
    card = init_state(model, opt, cfg, dev)
    losses = []
    for i in range(3):
        cpu, mc = step(cpu, to_device(_batch(i), "cpu"))
        losses.append(mc["loss"].item())
    st.reset_launches()
    for i in range(3):
        card, mg = step(card, to_device(_batch(i), dev))
        assert abs(mg["loss"].item() - losses[i]) <= LOSS_RTOL * abs(losses[i])
    fused = cfg.optim.name == "ftrl" and cfg.optim.fused_scatter != "off"
    assert st.LAUNCHES["scatter_ftrl" if fused else "scatter_sorted"] == 3
    assert _rel(card.tables["wv"], cpu.tables["wv"], FTRL_FLOOR) <= FTRL_RTOL
    for leaf, t in card.opt_state["wv"].items():
        assert _rel(t, cpu.opt_state["wv"][leaf], FTRL_FLOOR) <= FTRL_RTOL, leaf


def _lr_batch(seed, B=64, F=8, pool=100):
    rng = np.random.default_rng(seed)
    hot = rng.choice(S, pool, replace=False).astype(np.int32)
    mask = (rng.random((B, F)) < 0.8).astype(np.float32)
    return {"slots": hot[rng.integers(0, pool, (B, F))], "mask": mask,
            "fields": np.tile(np.arange(F, dtype=np.int32), (B, 1)),
            "labels": (rng.random(B) < 0.4).astype(np.float32),
            "row_mask": np.ones(B, np.float32)}


@pytest.mark.parametrize("extra", [{}, {"optim.name": "sgd"}, {"data.dedup": "auto"}])
def test_lr_train_steps_on_the_card_match_the_cpu(dev, extra):
    """LR (the default model) takes the row-major step: torch indexing
    and autograd's `index_add_`, no hand-written kernel."""
    from xflow_tpu_torch.evaluate import HostDedup
    from xflow_tpu_torch.train.state import init_state

    cfg = override(Config(), **{"data.log2_slots": 14, "data.batch_size": 64,
                                "data.max_nnz": 8, **extra})
    model, opt = get_model("lr")(cfg), get_optimizer(cfg.optim.name)
    step = make_train_step(model, opt, cfg)
    dedup = HostDedup(cfg)
    batches = [dedup(_lr_batch(i)) for i in range(2)]
    assert ("unique_slots" in batches[0]) == (cfg.data.dedup == "auto")
    cpu, card = init_state(model, opt, cfg, "cpu"), init_state(model, opt, cfg, dev)
    st.reset_launches()
    for b in batches:
        cpu, mc = step(cpu, to_device(b, "cpu"))
        card, mg = step(card, to_device(b, dev))
        assert abs(mg["loss"].item() - mc["loss"].item()) <= LOSS_RTOL * abs(mc["loss"].item())
    torch.cuda.synchronize()
    assert not any(st.LAUNCHES.values()), st.LAUNCHES
    assert _rel(card.tables["w"], cpu.tables["w"], FTRL_FLOOR) <= FTRL_RTOL
    for leaf, t in card.opt_state["w"].items():
        assert _rel(t, cpu.opt_state["w"][leaf], FTRL_FLOOR) <= FTRL_RTOL, leaf


def test_fit_on_the_card_matches_the_cpu(dev, tmp_path):
    (path,) = generate_shards(str(tmp_path / "train"), 1, 200, num_fields=8,
                              ids_per_field=40, seed=5)
    cfg = _cfg(**{"data.train_path": str(tmp_path / "train"), "train.epochs": 2})
    card, cpu = Trainer(cfg, device=str(dev)), Trainer(cfg, device="cpu")
    rc, rp = card.fit(), cpu.fit()
    assert (rc.steps, rc.examples, rc.bad_steps) == (rp.steps, rp.examples, rp.bad_steps)
    assert abs(rc.last_loss - rp.last_loss) <= LOSS_RTOL * abs(rp.last_loss)
    assert _rel(card.state.tables["wv"], cpu.state.tables["wv"], FTRL_FLOOR) <= FTRL_RTOL
    auc_c, ll_c = card.evaluate(path, dump=False)
    auc_p, ll_p = cpu.evaluate(path, dump=False)
    assert abs(auc_c - auc_p) <= 1e-3 and abs(ll_c - ll_p) <= 1e-5 * abs(ll_p)


MULTI_CASES = ("shared", "sparse_windows", "all_pad", "hot", "edges", "chunk_cross",
               "odd_starts", "empty_full", "empty_windows", "one_window")


def _multi_plan(case, seed=0, ns=4):
    """(sorted_slots [ns * cap], loc_off [ns, S/W + 1], sorted_mask) of a
    crafted stacked plan of `ns` buffers (rows repeated up to a multiple
    of ns)."""
    rng = np.random.default_rng(seed)
    if case == "hot":  # 2,048 occurrences of one slot, spread over the buffers
        slots = np.full((512, 4), 12345, np.int32)
    elif case in ("edges", "chunk_cross", "odd_starts"):
        slots = _slots(case, rng)
    elif case == "empty_full":  # buffer 0 has nothing in window 0, buffer 1 a
        # 512-position span of 50 slots there (longer than a staging chunk)
        slots = rng.integers(0, S, (256, 8)).astype(np.int32)
        slots[:64] = rng.integers(st.WINDOW, 2 * st.WINDOW, (64, 8))
        slots[64:128] = rng.integers(0, 50, (64, 8))
    else:
        slots = rng.integers(0, S, (64, 8)).astype(np.int32)
    if case == "empty_windows":  # two windows hold every slot: the others are empty in
        # every buffer
        slots = np.where(rng.random((64, 8)) < 0.5, 5 * st.WINDOW, S - 3 * st.WINDOW)
        slots = (slots + rng.integers(0, st.WINDOW, (64, 8))).astype(np.int32)
    rows = -(-slots.shape[0] // ns) * ns
    slots = np.resize(slots, (rows, slots.shape[1]))
    if case == "one_window":  # buffer 0's slots all lie in window 7
        slots[:rows // ns] = rng.integers(7 * st.WINDOW, 8 * st.WINDOW, (rows // ns, 8))
    if case == "shared":  # one slot in every row of every buffer
        slots[:, 0] = 777
    if case == "sparse_windows":  # buffer i touches windows 2i and 2i+1 only
        bs = slots.shape[0] // ns
        for i in range(ns):
            slots[i * bs:(i + 1) * bs] = (slots[i * bs:(i + 1) * bs] % (2 * st.WINDOW)
                                          + 2 * i * st.WINDOW) % S
    mask = (rng.random(slots.shape) < 0.8).astype(np.float32)
    plan = st.plan_sorted_stacked(slots, mask, S, num_sub=ns, always_stack=True)
    ss, loc, m = plan.sorted_slots.copy(), plan.win_off.copy(), plan.sorted_mask.copy()
    if case == "all_pad":  # the last buffer holds pads only
        ss[-1], m[-1] = S - 1, 0.0
        loc[-1] = np.searchsorted(ss[-1], np.arange(0, S + 1, st.WINDOW))
    return ss.reshape(-1), loc, m.reshape(-1)


@pytest.mark.parametrize("case", MULTI_CASES)
@pytest.mark.parametrize("k", [5, 10, 11])
@pytest.mark.parametrize("nbuf", [1, 4, st.MULTI_MAX_BUFFERS])
@pytest.mark.parametrize("bf16", [False, True])
def test_gather_multi_kernel_matches_plain(dev, case, k, nbuf, bf16):
    """Bit-exact at 1, 4 and the most stacked buffers: K = 10 loads 8 B
    pairs, K = 5 and 11 scalars."""
    ss, loc, _ = _multi_plan(case, ns=nbuf)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(S, k)).astype(np.float32))
    ss_t, loc_t = torch.from_numpy(ss), torch.from_numpy(loc)
    st.reset_launches()
    got = st.gather_sorted_multi_cuda(table.to(dev), ss_t.to(dev), loc_t.to(dev), bf16)
    torch.cuda.synchronize()
    assert st.LAUNCHES["gather_sorted_multi"] == 1
    assert torch.equal(got.cpu(), st.gather_sorted_multi_plain(table, ss_t, loc_t, bf16))


@pytest.mark.parametrize("case", MULTI_CASES)
@pytest.mark.parametrize("k", [5, 10, 11])
@pytest.mark.parametrize("nbuf", [1, 4, st.MULTI_MAX_BUFFERS])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_multi_kernel_bitwise_equal_to_plain(dev, case, k, nbuf, bf16):
    ss, loc, m = _multi_plan(case, seed=1, ns=nbuf)
    rng = np.random.default_rng(6)
    d = rng.normal(size=(st._k8(k), ss.shape[0])).astype(np.float32)
    d[:k] *= m[None, :]  # rows k..k8 keep noise to be ignored
    d_t, ss_t, loc_t = torch.from_numpy(d), torch.from_numpy(ss), torch.from_numpy(loc)
    got = st.scatter_sorted_multi_cuda(d_t.to(dev), ss_t.to(dev), loc_t.to(dev), S, k, bf16)
    again = st.scatter_sorted_multi_cuda(d_t.to(dev), ss_t.to(dev), loc_t.to(dev), S, k, bf16)
    want = st.scatter_sorted_multi_plain(d_t, ss_t, loc_t, S, k, bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    if case == "hot":
        assert (want[12345] != 0).all()


LONG_CASES = ("h_minus_1", "exactly_h", "h_plus_1", "crossing", "buffer_edge", "beyond_a_group")


def _long_plan(case, nbuf, seed=0):
    """(sorted_slots [nbuf * cap], loc_off [nbuf, S/W + 1], real) of a
    plan built for the long-run split: every buffer holds the case's runs,
    uniform slots around them and pads at S - 1. "buffer_edge" puts slot
    9000 at every buffer's end and start: buffer 0 ends with a run of 300
    there (no pads), the middle buffers are that slot alone, the last
    starts with 300 of it, so in the flattened stream the slot's runs meet
    at each buffer's end; with one buffer, the run ends the plan."""
    rng = np.random.default_rng(seed)
    H, C, cap = st.SCATTER_RUN_H, st.SCATTER_CELL, 1024
    runs = {
        "h_minus_1": [(777, H - 1), (4095, H - 1), (4096, H - 1)],
        "exactly_h": [(777, H), (4095, H), (4096, H)],
        "h_plus_1": [(777, H + 1), (4095, H + 1), (4096, H + 1)],
        # runs across 160-position chunks and 256-position cells, neighbours
        # in one 256-slot tile (255 / 256 / 257) and across tiles (511 / 512)
        "crossing": [(255, 3 * C + 5), (256, 161), (257, 2 * C + 1), (511, 700), (512, 3),
                     (513, 999)],
        "beyond_a_group": [(12345, 40000), (12346, 300)],
        "buffer_edge": [(9000, 0)],
    }[case]
    pool = np.setdiff1d(np.arange(S - 1), [s for s, _ in runs])
    bufs = []
    for i in range(nbuf):
        if case != "buffer_edge":
            parts = [rng.choice(pool, 1500)] + [np.full(n, s) for s, n in runs]
        elif i == 0:
            parts = [rng.choice(pool[pool < 9000], cap - 300), np.full(300, 9000)]
        elif i < nbuf - 1:
            parts = [np.full(cap, 9000)]
        else:
            parts = [np.full(300, 9000), rng.choice(pool[pool > 9000], 700)]
        bufs.append(np.sort(np.concatenate(parts)).astype(np.int32))
    if case != "buffer_edge":
        cap = -(-max(b.size for b in bufs) // st.CHUNK) * st.CHUNK
    real = np.concatenate([np.arange(cap) < b.size for b in bufs]).astype(np.float32)
    bufs = [np.concatenate([b, np.full(cap - b.size, S - 1, np.int32)]) for b in bufs]
    loc = np.stack([np.searchsorted(b, np.arange(0, S + 1, st.WINDOW)) for b in bufs])
    loc[:, -1] = cap
    return np.concatenate(bufs), loc.astype(np.int32), real


def _long_scatters(dev, ss, loc, d, k, bf16):
    """#6 over the buffers, and with one buffer #4 too; each launched twice."""
    d_t, ss_t, loc_t = torch.from_numpy(d), torch.from_numpy(ss), torch.from_numpy(loc)
    d_c, ss_c, loc_c = d_t.to(dev), ss_t.to(dev), loc_t.to(dev)
    outs = [(st.scatter_sorted_multi_cuda(d_c, ss_c, loc_c, S, k, bf16),
             st.scatter_sorted_multi_cuda(d_c, ss_c, loc_c, S, k, bf16))]
    if loc.shape[0] == 1:
        wo = loc_c.reshape(-1)
        outs.append((st.scatter_sorted_cuda(d_c, ss_c, wo, S, k, bf16),
                     st.scatter_sorted_cuda(d_c, ss_c, wo, S, k, bf16)))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("case", LONG_CASES)
@pytest.mark.parametrize("k", [10, 11, 73])
@pytest.mark.parametrize("nbuf", [1, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatters_split_long_runs_bitwise(dev, case, k, nbuf, bf16):
    """#4 and #6 on runs at and around SCATTER_RUN_H and far beyond it:
    bitwise across two launches and against the CPU plain version, which
    adds in the kernels' order (a longer run's pieces joined in order)."""
    ss, loc, real = _long_plan(case, nbuf)
    rng = np.random.default_rng(9)
    d = rng.normal(size=(st._k8(k), ss.size)).astype(np.float32)
    d[:k] *= real[None, :]  # rows k..k8 keep noise to be ignored
    want = st.scatter_sorted_multi_plain(torch.from_numpy(d), torch.from_numpy(ss),
                                         torch.from_numpy(loc), S, k, bf16)
    for got, again in _long_scatters(dev, ss, loc, d, k, bf16):
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", LONG_CASES)
@pytest.mark.parametrize("k", [10, 11, 73])
@pytest.mark.parametrize("nbuf", [1, 4])
def test_scatters_on_exact_terms_equal_plan_order(dev, case, k, nbuf):
    """On terms whose float32 sums are exact in any order (`_dyadic`),
    #4 and #6 equal `zeros` + `index_add_` in plan order bitwise: a lost,
    doubled or misrouted term shows, whatever the order of adds."""
    ss, loc, real = _long_plan(case, nbuf, seed=1)
    d = _dyadic(np.random.default_rng(10), k, ss.size).numpy()
    d[:k] *= real[None, :]
    want = torch.zeros((S, k)).index_add_(0, torch.from_numpy(ss).long(),
                                          torch.from_numpy(d[:k]).T)
    for got, again in _long_scatters(dev, ss, loc, d, k, False):
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want)


def test_multi_kernels_refuse_a_bad_loc_off(dev):
    ss, loc, _ = _multi_plan("shared")
    table = torch.zeros((S, 5), device=dev)
    bad = torch.from_numpy(loc[:, :-1].copy()).to(dev)
    with pytest.raises(ValueError, match="columns"):
        st.gather_sorted_multi_cuda(table, torch.from_numpy(ss).to(dev), bad)
    with pytest.raises(ValueError, match="buffers"):
        st.scatter_sorted_multi_cuda(torch.zeros((8, ss.size - 8), device=dev),
                                     torch.from_numpy(ss[:-8].copy()).to(dev),
                                     torch.from_numpy(loc).to(dev), S, 5)


def _mvm_cfg(**extra):
    return _cfg(**{"model.name": "mvm", "optim.v_init_scale": 0.1, **extra})


def _mvm_batch(seed, cfg, dup=False):
    from xflow_tpu_torch.data.schema import make_batch
    from xflow_tpu_torch.evaluate import batch_arrays

    rng = np.random.default_rng(seed)
    fields = [rng.permutation(8)[: int(rng.integers(3, 9))].astype(np.int32) for _ in range(60)]
    if dup:
        fields[0][-1] = fields[0][0]
    slots = [rng.integers(0, S, f.size).astype(np.int32) for f in fields]
    labels = list((rng.random(60) < 0.4).astype(np.float32))
    return batch_arrays(make_batch(fields, slots, labels, 64, 8), cfg)


MVM_VARIANTS = [
    ({}, "scatter_sorted"),
    ({"optim.fused_scatter": "on"}, "scatter_ftrl"),
    ({"model.mvm_exclusive": "off", "data.sorted_sub_batches": 4}, "scatter_sorted_multi"),
    ({"model.mvm_exclusive": "off", "data.sorted_sub_batches": 4, "model.mvm_plus_one": True},
     "scatter_sorted_multi"),
    ({"model.mvm_plus_one": True, "data.sorted_bf16": True}, "scatter_sorted"),
]


@pytest.mark.parametrize("extra, kernel", MVM_VARIANTS)
def test_mvm_train_steps_on_the_card_match_the_cpu(dev, extra, kernel):
    from xflow_tpu_torch.train.state import init_state

    cfg = _mvm_cfg(**extra)
    model, opt = get_model("mvm")(cfg), get_optimizer(cfg.optim.name)
    step = make_train_step(model, opt, cfg)
    cpu, card = init_state(model, opt, cfg, "cpu"), init_state(model, opt, cfg, dev)
    losses = []
    for i in range(3):
        cpu, mc = step(cpu, to_device(_mvm_batch(i, cfg), "cpu"))
        losses.append(mc["loss"].item())
    st.reset_launches()
    for i in range(3):
        card, mg = step(card, to_device(_mvm_batch(i, cfg), dev))
        assert abs(mg["loss"].item() - losses[i]) <= LOSS_RTOL * abs(losses[i])
    assert st.LAUNCHES[kernel] == 3
    if kernel == "scatter_sorted_multi":
        assert st.LAUNCHES["gather_sorted_multi"] == 3 and st.LAUNCHES["gather_sorted"] == 0
    for name, a, b in [("v", card.tables["v"], cpu.tables["v"])] + [
            (leaf, t, cpu.opt_state["v"][leaf]) for leaf, t in card.opt_state["v"].items()]:
        scale = b.abs().max().item()
        assert _rel(a, b, max(FTRL_FLOOR * scale, 1e-30)) <= FTRL_RTOL, name


def test_mvm_fit_on_the_card_matches_the_cpu(dev, tmp_path):
    (path,) = generate_shards(str(tmp_path / "train"), 1, 200, num_fields=8,
                              ids_per_field=40, seed=5)
    cfg = _mvm_cfg(**{"data.train_path": str(tmp_path / "train"), "train.epochs": 2,
                      "model.mvm_exclusive": "off", "data.sorted_sub_batches": 2,
                      "model.mvm_plus_one": True})
    card, cpu = Trainer(cfg, device=str(dev)), Trainer(cfg, device="cpu")
    rc, rp = card.fit(), cpu.fit()
    assert (rc.steps, rc.examples, rc.bad_steps) == (rp.steps, rp.examples, rp.bad_steps)
    assert abs(rc.last_loss - rp.last_loss) <= LOSS_RTOL * abs(rp.last_loss)
    assert _rel(card.state.tables["v"], cpu.state.tables["v"], FTRL_FLOOR) <= FTRL_RTOL
    auc_c, ll_c = card.evaluate(path, dump=False)
    auc_p, ll_p = cpu.evaluate(path, dump=False)
    assert abs(auc_c - auc_p) <= 1e-3 and abs(ll_c - ll_p) <= 1e-5 * abs(ll_p)


# ------------------------------------------------------------------- FFM

def _ffm_cfg(**extra):
    return override(Config(), **{
        "model.name": "ffm", "model.v_dim": 4, "model.num_fields": 18, "data.log2_slots": 14,
        "data.batch_size": 64, "data.max_nnz": 18, **extra,
    })


def _ffm_batch(seed, cfg, dup_rows=0):
    """64 rows of one feature a field over 18 fields (60 real rows, a
    shared slot); the first `dup_rows` rows repeat a field."""
    from xflow_tpu_torch.data.schema import make_batch
    from xflow_tpu_torch.evaluate import batch_arrays

    rng = np.random.default_rng(seed)
    fields, slots = [], []
    for r in range(60):
        f = rng.permutation(18)[: int(rng.integers(6, 19))].astype(np.int32)
        if r < dup_rows:
            f[-1] = f[0]
        fields.append(f)
        slots.append(rng.integers(0, S, f.size).astype(np.int32))
    slots[1][0] = slots[40][0]
    labels = list((rng.random(60) < 0.4).astype(np.float32))
    return batch_arrays(make_batch(fields, slots, labels, 64, 18), cfg)


# (config, dup rows, the table kernel of the step's backward or None)
FFM_VARIANTS = [
    ({}, 0, "scatter_ftrl"),
    ({"optim.fused_scatter": "off"}, 0, "scatter_sorted"),
    ({"optim.name": "sgd"}, 0, "scatter_sorted"),
    ({"data.sorted_bf16": True}, 0, "scatter_ftrl"),
    ({}, 3, None),  # a repeated field: the row-major route, no kernel
]


@pytest.mark.parametrize("extra, dup_rows, kernel", FFM_VARIANTS)
def test_ffm_train_steps_on_the_card_match_the_cpu(dev, extra, dup_rows, kernel):
    """FFM's aligned hybrid (K = 73: #1, then #3 fused or #4 two-pass) and
    its row-major route, 3 steps on the card against the CPU."""
    from xflow_tpu_torch.train.state import init_state

    cfg = _ffm_cfg(**extra)
    model, opt = get_model("ffm")(cfg), get_optimizer(cfg.optim.name)
    step = make_train_step(model, opt, cfg)
    batches = [_ffm_batch(i, cfg, dup_rows) for i in range(3)]
    assert all(("slots" in b) == (kernel is None) for b in batches)
    cpu, card = init_state(model, opt, cfg, "cpu"), init_state(model, opt, cfg, dev)
    losses = []
    for b in batches:
        cpu, mc = step(cpu, to_device(b, "cpu"))
        losses.append(mc["loss"].item())
    st.reset_launches()
    for b, loss in zip(batches, losses):
        card, mg = step(card, to_device(b, dev))
        assert abs(mg["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    torch.cuda.synchronize()
    want = {} if kernel is None else {"gather_sorted": 3, kernel: 3}
    assert {k: v for k, v in st.LAUNCHES.items() if v} == want
    assert _rel(card.tables["wv"], cpu.tables["wv"], FTRL_FLOOR) <= FTRL_RTOL
    for leaf, t in card.opt_state.get("wv", {}).items():
        assert _rel(t, cpu.opt_state["wv"][leaf], FTRL_FLOOR) <= FTRL_RTOL, leaf


# ------------------------------------------------- row sums at wide channels

def _row_sums_case(dev, ch, seed=7):
    """A small plan's rows (a few out of range, the pads at row 0 with
    value 0) and [ch, Np] values with whole zero quads (a masked channel
    group, as MVM's zero counts and FM's padding channels give)."""
    plan, _ = _inputs("random", 5, seed=seed)
    rng = np.random.default_rng(seed + 1)
    vals = (rng.normal(size=(ch, plan.sorted_slots.shape[0])).astype(np.float32)
            * plan.sorted_mask[None, :])
    vals[ch // 2: ch // 2 + 4] = 0.0
    rows = plan.sorted_row.copy()
    n_rows = int(rows.max()) + 1
    rows[:5] = [-1, n_rows, n_rows + 7, -(2**31), 2**31 - 1]
    return torch.from_numpy(vals).to(dev), torch.from_numpy(rows).to(dev), n_rows


def _check_row_sums(vals, rows, n_rows):
    """#2 once: bitwise its plain version on CPU copies (both add a row's
    terms in plan order from +0) and bitwise a second launch. Returns the
    sums."""
    st.reset_launches()
    got = st.row_sums_cuda(vals, rows, n_rows)
    again = st.row_sums_cuda(vals, rows, n_rows)
    torch.cuda.synchronize()
    assert st.LAUNCHES["row_sums"] == 2
    want = st.row_sums_plain(vals.cpu(), rows.cpu(), n_rows)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want), (got.cpu() - want).abs().max().item()
    return got


@pytest.mark.parametrize("ch", [24, 32, 104, 128, 136])
def test_row_sums_kernel_at_wide_channels(dev, ch):
    """The main paths' widths, FM's ch 24 and MVM's product ch 32, and the
    wide ones: FM's row side at v_dim 50 (ch 104) and v_dim 64 (ch 136),
    and ch 128 (four and five staging passes of 32 channels)."""
    vals, rows, n_rows = _row_sums_case(dev, ch)
    _check_row_sums(vals, rows, n_rows)


def test_row_sums_kernel_launches_over_the_old_channel_limit(dev):
    """ch 464: over the 454 channels whose [ch, 128] slab fitted a block's
    shared memory before the channel-group design."""
    vals, rows, n_rows = _row_sums_case(dev, 464, seed=11)
    _check_row_sums(vals, rows, n_rows)


def _long_rows_case(dev, ch, lengths, np_=1 << 16, n_rows=512, seed=5):
    """Rows of the given numbers of nonzero terms (rows 1, 2, ...) at
    random positions, the rest of the plan over rows [0, n_rows) with a
    fifth of its values zeroed, values over 1e-3..1e3 of either sign."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, np_).astype(np.int32)
    pos = rng.permutation(np_)
    at = 0
    for r, n in enumerate(lengths, start=1):
        rows[rows == r] = 0
        rows[pos[at:at + n]] = r
        at += n
    vals = (rng.choice([-1.0, 1.0], (ch, np_)) * 10.0 ** rng.uniform(-3, 3, (ch, np_)))
    vals[:, rng.random(np_) < 0.2] = 0.0
    vals[:, pos[:at]] = np.where(vals[:, pos[:at]] == 0.0, 1.0, vals[:, pos[:at]])
    return (torch.from_numpy(vals.astype(np.float32)).to(dev), torch.from_numpy(rows).to(dev),
            n_rows)


@pytest.mark.parametrize("ch", [24, 136])
@pytest.mark.parametrize("lengths", [
    [st.ROW_SUMS_WARP_MAX - 1, st.ROW_SUMS_WARP_MAX, st.ROW_SUMS_WARP_MAX + 1],
    [1000, 4096],
    [5000, 20_000],
])
def test_row_sums_kernel_on_long_rows(dev, ch, lengths):
    """Rows at the warp's limit and past it (a block orders them), and of
    thousands of terms (several chunks), beside short rows."""
    vals, rows, n_rows = _long_rows_case(dev, ch, lengths)
    got = _check_row_sums(vals, rows, n_rows)
    assert torch.isfinite(got).all()


def test_row_sums_kernel_on_a_row_over_two_windows(dev):
    """A row of 3,000 terms spread over a plan longer than the long rows'
    window: its terms come in two windows, the sum carried between."""
    np_ = 1 << 21
    assert np_ > st.ROW_SUMS_WINDOW
    vals, rows, n_rows = _long_rows_case(dev, 8, [3000], np_=np_, n_rows=4096)
    pos = torch.nonzero(rows.cpu() == 1).flatten()
    assert pos.max() - pos.min() >= st.ROW_SUMS_WINDOW
    _check_row_sums(vals, rows, n_rows)


def test_row_sums_kernel_on_a_pad_run_and_many_long_rows(dev):
    """A plan whose second half is pads (row 0, value 0), as a
    fully-sharded buffer's, and every row of its first half 200 terms
    long: each row goes to the block that orders long rows."""
    ch, n_rows, n = 24, 256, 200
    rng = np.random.default_rng(8)
    real = n_rows * n
    rows = np.zeros(2 * real, np.int32)
    rows[:real] = rng.permutation(np.repeat(np.arange(n_rows, dtype=np.int32), n))
    vals = np.zeros((ch, 2 * real), np.float32)
    vals[:, :real] = rng.normal(size=(ch, real)) * 10.0 ** rng.uniform(-3, 3, real)
    _check_row_sums(torch.from_numpy(vals).to(dev), torch.from_numpy(rows).to(dev), n_rows)


@pytest.mark.parametrize("ch", [1, 6, 10, 22, 26])
def test_row_sums_kernel_refuses_a_channel_count_not_a_multiple_of_4(dev, ch):
    vals = torch.zeros((ch, 128), device=dev)
    rows = torch.zeros(128, dtype=torch.int32, device=dev)
    st.reset_launches()
    with pytest.raises(ValueError, match="must be a multiple of 4"):
        st.row_sums_cuda(vals, rows, 4)
    with pytest.raises(ValueError, match="must be a multiple of 4"):
        st.row_sums_sorted(vals, rows, 4)  # no fallback to the plain version
    with pytest.raises(ValueError, match="Np=126 must be a multiple of 4"):
        st.row_sums_cuda(torch.zeros((8, 126), device=dev), rows[:126], 4)
    assert st.LAUNCHES["row_sums"] == 0


def test_fm_forward_at_v_dim_64_on_the_card_matches_the_cpu(dev):
    from xflow_tpu_torch.models.predict import make_predict_fn

    cfg = _cfg(**{"model.v_dim": 64})
    rng = np.random.default_rng(9)
    wv = torch.from_numpy((rng.normal(size=(S, 65)) * 0.05).astype(np.float32))
    predict = make_predict_fn(get_model("fm")(cfg))
    st.reset_launches()
    p_card = predict({"wv": wv.to(dev)}, to_device(_batch(0), dev))
    assert st.LAUNCHES["row_sums"] == 1
    p_cpu = predict({"wv": wv}, to_device(_batch(0), "cpu"))
    np.testing.assert_allclose(p_card.cpu().numpy(), p_cpu.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------ the Hopper lab (#7-#11)

def _lab_inputs(seed=0, n=1 << 13, k=11, c=512, grid=4):
    from xflow_tpu_torch.ops import lab  # noqa: F401

    rng = np.random.default_rng(seed)
    off = rng.integers(0, n - c + 1, 33).astype(np.int32)
    off[grid - 1] = n  # the last block's slice leaves the array: zeros
    return {
        "table": torch.from_numpy(rng.standard_normal((1 << 14, k), dtype=np.float32)),
        "d_t": torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)),
        "sl": torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (1, n)).astype(np.int32)),
        "d_rows": torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)),
        "off": torch.from_numpy(off),
    }


@pytest.mark.parametrize("probe", ["a", "b", "c", "d"])
def test_lab_slice_probes_bitwise_equal_to_plain(dev, probe):
    from xflow_tpu_torch.ops import lab

    x = _lab_inputs()
    key, fn, plain = {
        "a": ("mosaic_a", lambda t: lab.block_scale_cuda(t["table"]),
              lambda t: lab.block_scale_plain(t["table"])),
        "b": ("mosaic_b", lambda t: lab.col_slices_cuda(t["d_t"], t["off"]),
              lambda t: lab.col_slices_plain(t["d_t"], t["off"])),
        "c": ("mosaic_c", lambda t: lab.col_slices_cuda(t["sl"], t["off"]),
              lambda t: lab.col_slices_plain(t["sl"], t["off"])),
        "d": ("mosaic_d", lambda t: lab.row_slices_cuda(t["d_rows"], t["off"]),
              lambda t: lab.row_slices_plain(t["d_rows"], t["off"])),
    }[probe]
    lab.reset_launches()
    got = fn({name: v.to(dev) for name, v in x.items()})
    torch.cuda.synchronize()
    assert lab.LAUNCHES[key] == 1
    want = plain(x)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple)
                    else (want,)):
        assert torch.equal(g.cpu(), w)
    if probe != "a":
        assert (want[1][:3] != 0).all() and (want[0][3] == 0).all()


@pytest.mark.parametrize("log2_rows", [10, 14, 20])
def test_lab_block_scale_bitwise_at_every_split(dev, log2_rows):
    """#7 cuts each [512, 11] window into pieces by the grid it fills: 64
    pieces of 352 B for 2 windows, 8 of 2,816 B for the probe's 32, one
    whole window a CTA for 2,048."""
    from xflow_tpu_torch.ops import lab

    table = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1 << log2_rows, 11), dtype=np.float32))
    lab.reset_launches()
    got = lab.block_scale_cuda(table.to(dev))
    torch.cuda.synchronize()
    assert lab.LAUNCHES["mosaic_a"] == 1
    assert torch.equal(got.cpu(), table * 2)


def test_lab_tensor_maps_encode_where_the_strides_allow(dev):
    from xflow_tpu_torch.ops import lab

    x = {name: v.to(dev) for name, v in _lab_inputs().items()}
    assert lab.tma_encode(x["d_t"], (11, 256)) == 0
    assert lab.tma_encode(x["sl"], (1, 256)) == 0
    assert lab.tma_encode(x["d_rows"], (256, 11)) != 0  # a 44 B row stride
    assert lab.tma_encode(x["table"], (256, 11)) != 0


@pytest.mark.parametrize("ch, num_rows", [(4, 512), (24, 512), (128, 512), (136, 512),
                                           (24, 65536), (4, 1 << 18), (24, 1 << 18)])
def test_lab_rowsum_kernel_matches_plain(dev, ch, num_rows):
    """#11 at one to 34 quads, B 512, 65,536 and 2^18 rows (a quad column
    of 4 MiB, more than a thread block cluster's shared memory holds),
    with rows out of range and all-zero quads."""
    from xflow_tpu_torch.ops import lab

    rng = np.random.default_rng(10)
    np_ = max(8192, 2 * num_rows)
    rows = torch.from_numpy(rng.integers(-2, num_rows + 2, np_).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(ch, np_)).astype(np.float32))
    vals[:, :100] = 0.0  # whole zero occurrences
    vals[:4, 100::3] = 0.0  # a zero quad beside nonzero ones
    lab.reset_launches()
    got = lab.rowsum_cuda(vals.to(dev), rows.to(dev), num_rows)
    torch.cuda.synchronize()
    assert lab.LAUNCHES["lab_rowsum"] == 1
    want = lab.rowsum_plain(vals, rows, num_rows)
    print(f"ch {ch}, B {num_rows}: {_rel(got, want, FLOOR):.3g} relative over a {FLOOR} floor")
    keep = (rows >= 0) & (rows < num_rows)
    assert reorder_err(got, want, vals[:, keep], rows[keep], num_rows) < 1.0


def test_kernel_parity_on_the_card(dev):
    from xflow_tpu_torch.tools.kernel_parity import TOLERANCES, check_kernel_parity

    res = check_kernel_parity()
    assert res["backend"] == "cuda"
    assert res["ok"], {n: (e, TOLERANCES[n]) for n, e in res["checks"].items()
                       if e > TOLERANCES[n]}


def test_serve_on_the_card_matches_the_cpu_and_returns_the_old_generation(dev, tmp_path):
    """The server's runner on the card: pCTRs within 1e-5 of the CPU's at
    every rung and through `handle_predict`; a reload under a predict
    loop (the copy on the loader's stream) answers at the new step with
    no failure, and once no batch holds the old generation the card
    holds one table again."""
    import json
    import threading
    import time

    from xflow_tpu_torch.serve.server import ServeApp
    from xflow_tpu_torch.serve.runner import ServeRunner
    from xflow_tpu_torch.train.checkpoint import save_tables

    K, nf = 5, 8
    rng = np.random.default_rng(11)
    ck = tmp_path / "ck"
    cfg = override(Config(), **{"model.name": "fm", "model.v_dim": K - 1,
                                "data.log2_slots": 14, "data.max_nnz": nf,
                                "train.checkpoint_dir": str(ck), "serve.max_batch": 64,
                                "serve.ladder": "8,16,32"})
    save_tables(str(ck), {"wv": (rng.normal(size=(S, K)) * 0.3).astype(np.float32)}, 1)
    rows = [" ".join(f"{f}:t{rng.integers(0, 500)}" for f in range(nf)) for _ in range(64)]
    card, cpu = ServeRunner(cfg, device=dev), ServeRunner(cfg, device="cpu")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    card.load(), cpu.load()
    assert card.warmup() == 4
    table = S * K * 4
    assert torch.cuda.memory_allocated() - m0 == table
    for n in (1, 8, 16, 33, 64):
        got, _ = card.predict_rows(rows[:n])
        want, _ = cpu.predict_rows(rows[:n])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    app = ServeApp(cfg, card)
    app.start()
    try:
        status, payload = app.handle_predict(json.dumps({"rows": rows[:5]}).encode())
    finally:
        app.close()
    assert status == 200
    np.testing.assert_allclose(payload["pctr"], cpu.predict_rows(rows[:5])[0], atol=1e-5,
                               rtol=0)
    save_tables(str(ck), {"wv": (rng.normal(size=(S, K)) * 0.3).astype(np.float32)}, 2)
    seen, errors, stop = [], [], threading.Event()

    def loop():
        while not stop.is_set():
            try:
                seen.append(card.predict_rows(rows[:16])[1].step)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                return

    th = threading.Thread(target=loop)
    th.start()
    try:
        assert card.maybe_reload().step == 2
        n, deadline = len(seen), time.monotonic() + 60
        while len(seen) < n + 20 and th.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and not errors and seen[-1] == 2
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - m0 == table
    assert cpu.maybe_reload().step == 2
    np.testing.assert_allclose(card.predict_rows(rows)[0], cpu.predict_rows(rows)[0],
                               atol=1e-5, rtol=0)


def test_async_snapshot_on_the_card_keeps_the_cadence_state(dev, tmp_path):
    """The side-stream snapshot holds references to the cadence step's
    leaves: steps that run while its copies are in flight (and while the
    writer writes) leave the saved state the cadence step's, bitwise;
    the buffers are pinned and reused, and the card gains no memory."""
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import HostDedup, batch_arrays
    from xflow_tpu_torch.train import checkpoint as ckpt

    (path,) = generate_shards(str(tmp_path / "train"), 1, 320, num_fields=8,
                              ids_per_field=40, seed=5)
    cfg = _cfg(**{"data.train_path": str(tmp_path / "train"), "train.epochs": 1,
                  "train.checkpoint_dir": str(tmp_path / "ck"), "train.ckpt_async": True})
    t = Trainer(cfg, device=str(dev))
    batches = [to_device(batch_arrays(b, cfg, HostDedup(cfg)), dev)
               for b in batch_iterator(path, cfg.data)]
    t.state, _ = t.train_step(t.state, batches[0])
    cadence = ckpt.flatten_state(t.state.tables, t.state.opt_state, 0)  # host copies
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert t.save_checkpoint() is True
    assert torch.cuda.memory_allocated() == before  # no copy on the card
    assert all(b.is_pinned() for b in t._ckpt_writer.staging.buffers.values())
    for b in batches[1:]:
        t.state, _ = t.train_step(t.state, b)
    t._ckpt_writer.drain()
    with np.load(str(tmp_path / "ck" / "step_1" / "state.npz")) as got:
        for k, v in cadence.items():
            if k != "step":
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    buffers = dict(t._ckpt_writer.staging.buffers)
    assert t.save_checkpoint() is True  # the second save reuses the buffers
    assert all(t._ckpt_writer.staging.buffers[k] is b for k, b in buffers.items())
    t._ckpt_writer.close()


def test_tail_fit_on_the_card_matches_the_cpu(dev, tmp_path):
    """The online loop on the card: a tail fit over a pre-seeded shard with
    async saves and publications, against the same run on the CPU."""
    from xflow_tpu_torch.train.checkpoint import committed_steps, read_publication

    generate_shards(str(tmp_path / "stream"), 1, 200, num_fields=8, ids_per_field=40, seed=5)
    runs = {}
    for name, device in (("card", str(dev)), ("cpu", "cpu")):
        cfg = _cfg(**{"data.train_path": str(tmp_path / "stream"), "data.stream": "tail",
                      "data.stream_poll_s": 0.02, "data.stream_idle_s": 0.5,
                      "data.stream_dir": str(tmp_path / f"spool_{name}"),
                      "train.publish_every": 2, "train.ckpt_async": True,
                      "train.checkpoint_dir": str(tmp_path / f"ck_{name}")})
        t = Trainer(cfg, device=device)
        runs[name] = (t, t.fit())
    (card, rc), (cpu, rp) = runs["card"], runs["cpu"]
    assert rc.steps == rp.steps == 4
    assert abs(rc.last_loss - rp.last_loss) <= LOSS_RTOL * abs(rp.last_loss)
    assert _rel(card.state.tables["wv"], cpu.state.tables["wv"], FTRL_FLOOR) <= FTRL_RTOL
    ck = str(tmp_path / "ck_card")
    assert committed_steps(ck)[0] == 4 and read_publication(ck, 4)["step"] == 4
