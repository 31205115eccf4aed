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
empty in a window next to one with a long span there, at K = 5, 10 and
11 (the MVM and FM widths). The multi-buffer kernels (#5 gather, #6
scatter) run on stacked plans: a slot every buffer shares, windows empty
in some buffers, an all-pad buffer, a hot slot of 2,048 occurrences
across the buffers, both table ends. The row sum (#2) runs at ch = 24,
32, 104, 128 and 136 (one to five channel groups) and at ch 464 (over
the old shared-memory limit), with rows out of range and whole zero
quads, refuses a ch that is not a multiple of 4, and FM's forward runs at
v_dim = 64 against the CPU. LR's steps (no hand-written kernel) run on
the card against the CPU. The lab's kernels (#7-#11, `ops/lab.py`) run
at the mosaic probe's shapes with one slice out of range (#7 also at the
grids that split a window into 64 pieces and into none), #11 at one to
34 quads and at B 512, 65,536 and 2^18 (a quad column of 4 MiB), and
`kernel_parity` runs whole. The multi-buffer gather (#5) also runs on
windows empty in every buffer and on one buffer whose spans all lie in
one window, at 1, 4 and the most stacked buffers.

Tolerances:
- gathers: bitwise (a copy);
- scatters: bitwise against the plain version on the CPU (both sum each
  slot's run in plan order from 0, buffer after buffer), and bitwise
  across two launches;
- scatter + FTRL: 1e-3 relative over a 1e-4 floor (kernel_parity's
  scatter_ftrl_*), w of never-touched entries bitwise;
- row sum: 1e-4 relative over a 1e-2 floor (float reductions reorder it)
  and, at the widths' test, the float32 reorder bound too; the lab's row
  sum within that bound alone (`bench_lab.reorder_err` < 1: a row of many
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


# k = 10 and 11: the MVM and FM main paths' widths
CASES = [(c, k) for c in ("random", "hot", "edges", "chunk_cross", "odd_starts")
         for k in (5, 10, 11)]


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


@pytest.mark.parametrize("case, k", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_ftrl_kernel_matches_plain(dev, case, k, bf16):
    plan, d = _inputs(case, k, seed=1)
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.standard_normal((S, k)) * 0.01).astype(np.float32))
    n = torch.from_numpy((np.abs(rng.standard_normal((S, k))) * 0.1).astype(np.float32))
    z = torch.from_numpy((rng.standard_normal((S, k)) * 1e-4).astype(np.float32))
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    hp = FTRLConfig()
    ss, wo = torch.from_numpy(plan.sorted_slots), torch.from_numpy(plan.win_off)
    got = st.scatter_ftrl_cuda(d.to(dev), ss.to(dev), wo.to(dev), w.to(dev), n.to(dev),
                               z.to(dev), k, hp, bf16)
    want = st.scatter_ftrl_plain(d, ss, w, n, z, k, hp, bf16)
    torch.cuda.synchronize()
    for name, a, b in zip("wnz", got, want):
        assert _rel(a, b, FTRL_FLOOR) <= FTRL_RTOL, name
    lazy = (st.scatter_sorted_plain(d, ss, S, k, bf16) == 0) & (n == 0)
    assert lazy.any() and torch.equal(got[0].cpu()[lazy], w[lazy])
    assert all(o.data_ptr() != i.data_ptr() for o, i in zip(got, (w, n, z)))


@pytest.mark.parametrize("case, k", CASES)
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
    got = st.row_sums_cuda(vals, rows, n_rows)
    assert _rel(got, st.row_sums_plain(vals, rows, n_rows), FLOOR) <= RTOL


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
    auc_c, ll_c = card.evaluate(path)
    auc_p, ll_p = cpu.evaluate(path)
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
    auc_c, ll_c = card.evaluate(path)
    auc_p, ll_p = cpu.evaluate(path)
    assert abs(auc_c - auc_p) <= 1e-3 and abs(ll_c - ll_p) <= 1e-5 * abs(ll_p)


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


@pytest.mark.parametrize("ch", [24, 32, 104, 128, 136])
def test_row_sums_kernel_at_wide_channels(dev, ch):
    """The main paths' widths, FM's ch 24 and MVM's product ch 32, and the
    wide ones: FM's row side at v_dim 50 (ch 104) and v_dim 64 (ch 136),
    and ch 128 (five channel groups at ch 136). Each launches once."""
    vals, rows, n_rows = _row_sums_case(dev, ch)
    st.reset_launches()
    got = st.row_sums_cuda(vals, rows, n_rows)
    torch.cuda.synchronize()
    assert st.LAUNCHES["row_sums"] == 1
    want = st.row_sums_plain(vals, rows, n_rows)
    print(f"ch {ch}: {_rel(got, want, FLOOR):.3g} relative over a {FLOOR} floor")
    keep = (rows >= 0) & (rows < n_rows)
    assert reorder_err(got, want, vals[:, keep], rows[keep], n_rows) < 1.0
    assert _rel(got, want, FLOOR) <= RTOL


def test_row_sums_kernel_launches_over_the_old_channel_limit(dev):
    """ch 464: over the 454 channels whose [ch, 128] slab fitted a block's
    shared memory before the channel-group design (which needs two
    [256][32] slabs at any ch)."""
    vals, rows, n_rows = _row_sums_case(dev, 464, seed=11)
    st.reset_launches()
    got = st.row_sums_cuda(vals, rows, n_rows)
    torch.cuda.synchronize()
    assert st.LAUNCHES["row_sums"] == 1
    assert _rel(got, st.row_sums_plain(vals, rows, n_rows), FLOOR) <= RTOL


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
