"""The train step (`xflow_tpu/train/step.py`) on one device:

    grads = grad of the masked mean BCE (gather forward, scatter backward)
    tables, opt_state = optimizer(tables, opt_state, grads)

Two forms. The two-pass step runs autograd through the model (the
sorted gather's backward is the windowed scatter kernel, the multi-buffer
one for a stacked plan) and then the optimizer over whole tables. The
fused step (fused FM or MVM's product row side, FTRL, a flat sorted plan
without fields) takes autograd only through the row side, from the
gathered occurrence rows to the loss, and hands the occurrence cotangent
to the one `scatter_ftrl_sorted` pass, so the [S, K] gradient never
exists.

Masked padded rows contribute zero gradient; the loss mean divides by
the number of real rows.
"""

from __future__ import annotations

from typing import Callable

import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.metrics import binary_logloss_from_logits
from xflow_tpu_torch.models.base import Model
from xflow_tpu_torch.optim.base import Optimizer
from xflow_tpu_torch.train.state import TrainState


def masked_mean_logloss(logits, labels, row_mask):
    """Mean BCE over real rows: the one loss reduction of both step forms."""
    per_row = binary_logloss_from_logits(logits, labels)
    return (per_row * row_mask).sum() / torch.clamp(row_mask.sum(), min=1.0)


def loss_fn(tables, batch, model: Model, cfg: Config):
    return masked_mean_logloss(model(tables, batch), batch["labels"], batch["row_mask"])


def nonfinite_guard_on(cfg: Config) -> bool:
    """Validate train.nonfinite_guard and return whether the guard runs."""
    g = cfg.train.nonfinite_guard
    if g not in ("off", "skip", "halt"):
        raise ValueError(f"train.nonfinite_guard={g!r}: expected off|skip|halt")
    return g != "off"


def _leaves(state: TrainState):
    yield from state.tables.values()
    for st in state.opt_state.values():
        yield from st.values()


def guard_nonfinite(cfg: Config, state: TrainState, new_state: TrainState, metrics: dict):
    """Fold the non-finite update guard into one step's result:
    `update_ok` = the loss and every updated table/optimizer leaf are
    finite. On a bad step the pre-step tables and optimizer state ride
    through; the step counter still advances, so checkpoint names stay
    monotonic. The flag is read on the host here (one sync per step),
    which keeps the old or the new tensors as they are instead of
    selecting between them element by element."""
    if not nonfinite_guard_on(cfg):
        return new_state, metrics
    ok = torch.isfinite(metrics["loss"])
    for leaf in _leaves(new_state):
        ok = ok & torch.isfinite(leaf).all()
    ok = bool(ok)
    if not ok:
        new_state = TrainState(state.tables, state.opt_state, new_state.step)
    return new_state, dict(metrics, update_ok=ok)


def _fused_scatter_eligible(cfg: Config) -> bool:
    """Whether the fused scatter+FTRL step applies (the JAX rules):
    "auto" fuses FM only (MVM's product path measured slower fused on
    the TPU, so it stays an opt-in), "on" takes fused FM or MVM and is a
    config error elsewhere, not a silent downgrade."""
    if cfg.optim.fused_scatter == "off":
        return False
    if cfg.optim.fused_scatter not in ("auto", "on"):
        raise ValueError(
            f"optim.fused_scatter={cfg.optim.fused_scatter!r}: expected auto|on|off"
        )
    if cfg.model.name == "ffm":
        raise ValueError("model.name=ffm is not ported to xflow_tpu_torch yet")
    fm_ok = cfg.model.name == "fm" and cfg.model.fm_fused
    mvm_ok = cfg.model.name == "mvm"
    ftrl = cfg.optim.name == "ftrl"
    if cfg.optim.fused_scatter == "on":
        if not (ftrl and (fm_ok or mvm_ok)):
            raise ValueError(
                "optim.fused_scatter=on requires optim.name=ftrl and model.name=fm "
                f"(fm_fused=true) or mvm; got optim={cfg.optim.name} "
                f"model={cfg.model.name} fm_fused={cfg.model.fm_fused}"
            )
        return True
    return ftrl and fm_ok


def fused_cotangent(table: torch.Tensor, batch: dict, cfg: Config):
    """(loss, d_occ [K8, Np]) of a flat sorted-plan batch: the gather,
    then autograd of the row-side loss with respect to the gathered
    occurrence rows only (the table is not part of the graph). The row
    side is FM's, or MVM's product row side."""
    from xflow_tpu_torch.ops.sorted_table import table_gather_sorted

    with torch.no_grad():
        occ_t = table_gather_sorted(
            table, batch["sorted_slots"], batch["win_off"], cfg.data.sorted_bf16
        )
    occ_t.requires_grad_(True)
    rows = batch["labels"].shape[0]
    with torch.enable_grad():
        if cfg.model.name == "mvm":
            from xflow_tpu_torch.models.mvm import _product_row_side

            plus = 1.0 if cfg.model.mvm_plus_one else 0.0
            logits = _product_row_side(
                occ_t, batch["sorted_row"], batch["sorted_mask"], rows, cfg.model.v_dim, plus
            )
        else:
            from xflow_tpu_torch.models.fm import _row_side_sorted

            logits = _row_side_sorted(
                occ_t, batch["sorted_row"], batch["sorted_mask"], rows, cfg
            )
        loss = masked_mean_logloss(logits, batch["labels"], batch["row_mask"])
        (d_occ,) = torch.autograd.grad(loss, occ_t)
    return loss.detach(), d_occ


def _fused_sorted_step(state: TrainState, batch: dict, cfg: Config):
    """`fused_cotangent`, then one scatter_ftrl_sorted pass over the table
    ("wv" for FM, "v" for MVM)."""
    from xflow_tpu_torch.ops.sorted_table import scatter_ftrl_sorted

    tname = "v" if cfg.model.name == "mvm" else "wv"
    table = state.tables[tname]
    loss, d_occ = fused_cotangent(table, batch, cfg)
    st = state.opt_state[tname]
    w_new, n_new, z_new = scatter_ftrl_sorted(
        d_occ, batch["sorted_slots"], batch["win_off"], table, st["n"], st["z"],
        table.shape[1], cfg.optim.ftrl, cfg.data.sorted_bf16,
    )
    new_state = TrainState({tname: w_new}, {tname: {"n": n_new, "z": z_new}}, state.step + 1)
    return new_state, {"loss": loss, "rows": batch["row_mask"].sum()}


def _two_pass_step(state: TrainState, batch: dict, model: Model, optimizer: Optimizer,
                   cfg: Config):
    params = {k: t.detach().requires_grad_(True) for k, t in state.tables.items()}
    with torch.enable_grad():
        loss = loss_fn(params, batch, model, cfg)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {
        k: torch.zeros_like(t) if g is None else g
        for (k, t), g in zip(state.tables.items(), grads)
    }
    with torch.no_grad():
        new_tables, new_opt = optimizer.apply(state.tables, state.opt_state, grads, cfg)
    new_state = TrainState(new_tables, new_opt, state.step + 1)
    return new_state, {"loss": loss.detach(), "rows": batch["row_mask"].sum()}


def make_train_step(model: Model, optimizer: Optimizer, cfg: Config) -> Callable:
    """Returns train_step(state, batch tensors) -> (state, metrics) with
    metrics {"loss", "rows"} plus "update_ok" when the guard is on."""
    fuse = _fused_scatter_eligible(cfg)

    def train_step(state: TrainState, batch: dict):
        # the fused path needs a flat sorted plan without per-occurrence
        # fields (not a stacked plan, not MVM's segment row side)
        fusable = (
            "sorted_slots" in batch
            and batch["sorted_slots"].ndim == 1
            and "sorted_fields" not in batch
        )
        if fuse and fusable:
            new_state, metrics = _fused_sorted_step(state, batch, cfg)
            return guard_nonfinite(cfg, state, new_state, metrics)
        if fuse and cfg.optim.fused_scatter == "on":
            raise ValueError(
                "optim.fused_scatter=on but this batch has no flat "
                "fields-free sorted plan (sorted_layout off/row-major, "
                "stacked sub-batch plans, or MVM's segment path): the "
                "fused path cannot run; use auto to allow the two-pass "
                "form on such batches"
            )
        new_state, metrics = _two_pass_step(state, batch, model, optimizer, cfg)
        return guard_nonfinite(cfg, state, new_state, metrics)

    return train_step
