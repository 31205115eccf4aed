"""PyTorch port on the card: each CUDA kernel (xflow_tpu_torch/csrc) held
against its plain version on crafted plans the chip smoke's random data
does not reach, and the train step and `Trainer.fit` on the card against
the CPU. Every test needs a CUDA card and skips without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the root conftest pins JAX, which the card's machine
does not have; nothing here imports JAX.)

Tolerances:
- gather: bitwise (a copy);
- scatter: bitwise against the plain version on the CPU (both sum each
  slot's run in plan order from 0), and bitwise across two launches;
- scatter + FTRL: 1e-3 relative over a 1e-4 floor (kernel_parity's
  scatter_ftrl_*), w of never-touched entries bitwise;
- row sum: 1e-4 relative over a 1e-2 floor (float atomics reorder it);
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


def _slots(case, rng):
    """[B, F] slots of a crafted plan."""
    if case == "hot":  # one slot in every occurrence: a run of B * F
        return np.full((512, 4), 12345, np.int32)
    if case == "edges":  # tile (256) and window (2048) boundaries, both table ends
        edge = np.array([0, 1, 255, 256, 257, 2047, 2048, 2049, S - 2049, S - 2048,
                         S - 257, S - 256, S - 2, S - 1], np.int32)
        return np.tile(edge, (16, 1))
    return rng.integers(0, S, (64, 8)).astype(np.int32)


def _inputs(case, k, seed=0):
    rng = np.random.default_rng(seed)
    slots = _slots(case, rng)
    mask = (rng.random(slots.shape) < 0.8).astype(np.float32)
    plan = st.plan_sorted_batch(slots, mask, S)
    k8 = st._k8(k)
    d = rng.normal(size=(k8, plan.sorted_slots.shape[0])).astype(np.float32)
    d[:k] *= plan.sorted_mask[None, :]  # rows k..k8 keep noise to be ignored
    return plan, torch.from_numpy(d)


CASES = [(c, k) for c in ("random", "hot", "edges") for k in (5, 11)]


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
