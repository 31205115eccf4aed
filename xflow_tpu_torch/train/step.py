"""The train step (`xflow_tpu/train/step.py`) on one device:

    grads = grad of the masked mean BCE (gather forward, scatter backward)
    tables, opt_state = optimizer(tables, opt_state, grads)

Two forms. The two-pass step runs autograd through the model (the
sorted gather's backward is the windowed scatter kernel, the multi-buffer
one for a stacked plan) and then the optimizer over whole tables. The
fused step (FTRL on a flat sorted plan: fused FM, MVM's product row
side, or FFM's aligned hybrid) takes autograd only through the row
side, from the gathered occurrence rows to the loss, and hands the
occurrence cotangent to the one `scatter_ftrl_sorted` pass, so the
[S, K] gradient never exists. Under the non-finite guard that pass also
counts the non-finite entries it writes, and the guard reads that count
with the loss in its one host read; the two-pass step's guard sweeps the
updated leaves with `isfinite`.

Masked padded rows contribute zero gradient; the loss mean divides by
the number of real rows.

Both forms open the JAX step's named scopes as `torch.profiler` ranges
(`telemetry.scope`), label for label: the two-pass step `grad` around
the forward and its backward (with `gather` and `loss` inside, through
`loss_fn`) and `optimizer` around the update; the fused step `gather`,
`loss` (the row side and the loss), `grad` (its backward) and
`scatter_optimizer` (the one scatter + FTRL pass).

`train.health_metrics` adds the grad, update and param norms to each
step's metrics (`health_norms`; per table under "full"): on the fused
path the grad norm is the occurrence cotangent's, since the table
gradient never exists there; on the two-pass path the dense gradient's.
They are taken on the proposed update, before the guard's discard. With
health off the metrics stay `{"loss", "rows"}` (plus `"update_ok"` under
the guard).
"""

from __future__ import annotations

from typing import Callable

import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.metrics import binary_logloss_from_logits
from xflow_tpu_torch.models.base import Model
from xflow_tpu_torch.optim.base import Optimizer
from xflow_tpu_torch.telemetry import scope
from xflow_tpu_torch.train.state import TrainState


def masked_mean_logloss(logits, labels, row_mask):
    """Mean BCE over real rows: the one loss reduction of both step forms."""
    per_row = binary_logloss_from_logits(logits, labels)
    return (per_row * row_mask).sum() / torch.clamp(row_mask.sum(), min=1.0)


def loss_fn(tables, batch, model: Model, cfg: Config):
    # the forward holds the table gather; its backward, the scatter, runs
    # under the caller's "grad" range
    with scope("gather"):
        logits = model(tables, batch)
    with scope("loss"):
        return masked_mean_logloss(logits, batch["labels"], batch["row_mask"])


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


def guard_nonfinite(cfg: Config, state: TrainState, new_state: TrainState, metrics: dict,
                    nonfinite=None):
    """Fold the non-finite update guard into one step's result:
    `update_ok` = the loss and every updated table/optimizer leaf are
    finite. On a bad step the pre-step tables and optimizer state ride
    through; the step counter still advances, so checkpoint names stay
    monotonic. The flag is read on the host here (one sync per step),
    which keeps the old or the new tensors as they are instead of
    selecting between them element by element. `nonfinite` is the fused
    step's count of non-finite entries in the updated leaves (int32 [1],
    counted by the scatter + FTRL pass that wrote them): with it, the
    leaves are not swept again."""
    if not nonfinite_guard_on(cfg):
        return new_state, metrics
    ok = torch.isfinite(metrics["loss"])
    if nonfinite is not None:
        ok = ok & (nonfinite[0] == 0)
    else:
        for leaf in _leaves(new_state):
            ok = ok & torch.isfinite(leaf).all()
    ok = bool(ok)
    if not ok:
        new_state = TrainState(state.tables, state.opt_state, new_state.step)
    return new_state, dict(metrics, update_ok=ok)


def health_mode(cfg: Config) -> str:
    """Validate train.health_metrics and return the mode."""
    m = cfg.train.health_metrics
    if m not in ("off", "norms", "full"):
        raise ValueError(f"train.health_metrics={m!r}: expected off|norms|full")
    return m


def health_metric_keys(cfg: Config) -> tuple:
    """The health keys of every step's metrics under this config: the
    global grad/update/param norms ("norms"), and per table ("full")."""
    mode = health_mode(cfg)
    if mode == "off":
        return ()
    keys = ["grad_norm", "update_norm", "param_norm"]
    if mode == "full":
        from xflow_tpu_torch.weights import table_shapes

        for t in sorted(table_shapes(cfg)):
            keys += [f"grad_norm.{t}", f"update_norm.{t}", f"param_norm.{t}"]
    return tuple(keys)


def health_norms(cfg: Config, old_tables: dict, new_tables: dict, grads=None,
                 grad_sq=None) -> dict:
    """One step's health scalars (0-dim tensors, no host read): per table
    the squared grad norm (from `grads`, or a squared norm the step
    passes in `grad_sq` where the table gradient never exists), the
    squared update norm ||new - old||^2 and the squared param norm
    ||new||^2, summed over tables and square-rooted; per table too under
    "full"."""
    mode = health_mode(cfg)
    if mode == "off":
        return {}
    names = sorted(new_tables)
    sqsum = lambda x: (x.float() ** 2).sum()  # noqa: E731
    ref = new_tables[names[0]]
    sq = {}
    for name in names:
        if grad_sq is not None and name in grad_sq:
            sq[name] = grad_sq[name].float()
        elif grads is not None and name in grads:
            sq[name] = sqsum(grads[name])
        else:
            sq[name] = torch.zeros((), dtype=torch.float32, device=ref.device)
    upd = {n: sqsum(new_tables[n] - old_tables[n]) for n in names}
    par = {n: sqsum(new_tables[n]) for n in names}
    total = lambda d: torch.sqrt(sum(d.values()))  # noqa: E731
    out = {"grad_norm": total(sq), "update_norm": total(upd), "param_norm": total(par)}
    if mode == "full":
        for n in names:
            out[f"grad_norm.{n}"] = torch.sqrt(sq[n])
            out[f"update_norm.{n}"] = torch.sqrt(upd[n])
            out[f"param_norm.{n}"] = torch.sqrt(par[n])
    return out


def metrics_keys(cfg: Config) -> tuple:
    """The keys of a step's metrics under this config."""
    base = ("loss", "rows") + health_metric_keys(cfg)
    return base + (("update_ok",) if nonfinite_guard_on(cfg) else ())


def _fused_scatter_eligible(cfg: Config) -> bool:
    """Whether the fused scatter+FTRL step applies (the JAX rules):
    "auto" fuses FM and FFM (MVM's product path measured slower fused on
    the TPU, so it stays an opt-in), "on" takes fused FM, MVM or FFM and
    is a config error elsewhere, not a silent downgrade."""
    if cfg.optim.fused_scatter == "off":
        return False
    if cfg.optim.fused_scatter not in ("auto", "on"):
        raise ValueError(
            f"optim.fused_scatter={cfg.optim.fused_scatter!r}: expected auto|on|off"
        )
    fm_ok = cfg.model.name == "fm" and cfg.model.fm_fused
    mvm_ok = cfg.model.name == "mvm"
    ffm_ok = cfg.model.name == "ffm"
    ftrl = cfg.optim.name == "ftrl"
    if cfg.optim.fused_scatter == "on":
        if not (ftrl and (fm_ok or mvm_ok or ffm_ok)):
            raise ValueError(
                "optim.fused_scatter=on requires optim.name=ftrl and model.name=fm "
                f"(fm_fused=true), mvm or ffm; got optim={cfg.optim.name} "
                f"model={cfg.model.name} fm_fused={cfg.model.fm_fused}"
            )
        return True
    return ftrl and (fm_ok or ffm_ok)


def fused_cotangent(table: torch.Tensor, batch: dict, cfg: Config):
    """(loss, d_occ [K8, Np]) of a flat sorted-plan batch: the gather,
    then autograd of the row-side loss with respect to the gathered
    occurrence rows only (the table is not part of the graph). The row
    side is FM's, MVM's product row side, or FFM's aligned hybrid."""
    from xflow_tpu_torch.ops.sorted_table import table_gather_sorted

    with torch.no_grad(), scope("gather"):
        occ_t = table_gather_sorted(
            table, batch["sorted_slots"], batch["win_off"], cfg.data.sorted_bf16
        )
    occ_t.requires_grad_(True)
    rows = batch["labels"].shape[0]
    with torch.enable_grad(), scope("loss"):
        if cfg.model.name == "ffm":
            from xflow_tpu_torch.models.ffm import ffm_aligned_logits

            logits = ffm_aligned_logits(occ_t, batch, cfg)
        elif cfg.model.name == "mvm":
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
    with scope("grad"):
        (d_occ,) = torch.autograd.grad(loss, occ_t)
    return loss.detach(), d_occ


def _fused_sorted_step(state: TrainState, batch: dict, cfg: Config):
    """`fused_cotangent`, then one scatter_ftrl_sorted pass over the table
    ("wv" for FM and FFM, "v" for MVM). Returns (state, metrics, count):
    under the guard, count is the pass's int32 [1] count of non-finite
    w', n', z' entries (else None)."""
    from xflow_tpu_torch.ops.sorted_table import scatter_ftrl_sorted

    tname = "v" if cfg.model.name == "mvm" else "wv"
    table = state.tables[tname]
    loss, d_occ = fused_cotangent(table, batch, cfg)
    st = state.opt_state[tname]
    count = (torch.zeros(1, dtype=torch.int32, device=table.device)
             if nonfinite_guard_on(cfg) else None)
    with scope("scatter_optimizer"):  # the one pass is scatter and optimizer
        w_new, n_new, z_new = scatter_ftrl_sorted(
            d_occ, batch["sorted_slots"], batch["win_off"], table, st["n"], st["z"],
            table.shape[1], cfg.optim.ftrl, cfg.data.sorted_bf16, count,
        )
    new_state = TrainState({tname: w_new}, {tname: {"n": n_new, "z": z_new}}, state.step + 1)
    metrics = {"loss": loss, "rows": batch["row_mask"].sum()}
    if health_mode(cfg) != "off":
        with torch.no_grad():
            metrics.update(health_norms(cfg, state.tables, new_state.tables,
                                        grad_sq={tname: (d_occ.float() ** 2).sum()}))
    return new_state, metrics, count


def _two_pass_step(state: TrainState, batch: dict, model: Model, optimizer: Optimizer,
                   cfg: Config):
    params = {k: t.detach().requires_grad_(True) for k, t in state.tables.items()}
    # "grad" holds the forward and its backward: the table scatter (the
    # gather's transpose) lands there
    with torch.enable_grad(), scope("grad"):
        loss = loss_fn(params, batch, model, cfg)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {
            k: torch.zeros_like(t) if g is None else g
            for (k, t), g in zip(state.tables.items(), got)
        }
    with torch.no_grad():
        with scope("optimizer"):
            new_tables, new_opt = optimizer.apply(state.tables, state.opt_state, grads, cfg)
        metrics = {"loss": loss.detach(), "rows": batch["row_mask"].sum()}
        metrics.update(health_norms(cfg, state.tables, new_tables, grads=grads))
    return TrainState(new_tables, new_opt, state.step + 1), metrics


def make_train_step(model: Model, optimizer: Optimizer, cfg: Config) -> Callable:
    """Returns train_step(state, batch tensors) -> (state, metrics) with
    metrics `metrics_keys(cfg)`: {"loss", "rows"}, the health norms under
    train.health_metrics, "update_ok" under the guard."""
    fuse = _fused_scatter_eligible(cfg)
    health_mode(cfg)  # validates train.health_metrics at construction

    def train_step(state: TrainState, batch: dict):
        # the fused path needs a flat sorted plan without per-occurrence
        # fields (not a stacked plan, not MVM's segment row side), except
        # FFM's aligned hybrid, whose plan carries fields and its placement
        fusable = (
            "sorted_slots" in batch
            and batch["sorted_slots"].ndim == 1
            and ("ffm_invperm" in batch if cfg.model.name == "ffm"
                 else "sorted_fields" not in batch)
        )
        if fuse and fusable:
            new_state, metrics, count = _fused_sorted_step(state, batch, cfg)
            return guard_nonfinite(cfg, state, new_state, metrics, count)
        if fuse and cfg.optim.fused_scatter == "on":
            raise ValueError(
                "optim.fused_scatter=on but this batch has no flat "
                "fields-free sorted plan (sorted_layout off/row-major, "
                "stacked sub-batch plans, MVM's segment path, or an FFM "
                "batch routed row-major): the "
                "fused path cannot run; use auto to allow the two-pass "
                "form on such batches"
            )
        new_state, metrics = _two_pass_step(state, batch, model, optimizer, cfg)
        return guard_nonfinite(cfg, state, new_state, metrics)

    return train_step
