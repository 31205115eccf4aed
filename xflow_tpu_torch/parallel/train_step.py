"""The row-major sharded train and eval steps (`xflow_tpu/parallel/
train_step.py`), and what every mesh step shares (the loss over the
mesh, the non-finite guard and the health norms).

The JAX package writes this step once over logical arrays and lets
GSPMD partition it: the table gather lowers to the collectives of a
parameter server's pull, its transpose to the push. Torch has no GSPMD,
so the exchange is written out (`PullRows`), the ps-lite pull and push:

1. the host takes the unique slots of the rank's rows (`row_share`);
2. each slot's owner is ``slot // (S / n)`` over the n ranks that split
   the table (`mesh.owner_group`);
3. one all_to_all of the per-owner counts, one of the slot ids;
4. the owner `index_select`s the rows and sends them back by one
   all_to_all;
5. the model's own row-major forward runs on those rows (the batch's
   slots re-indexed into them);
6. backward: the gradient of each unique slot goes to its owner by one
   all_to_all;
7. the owner `index_add_`s it into its shard's dense gradient, and the
   optimizer runs on the shard.

`index_select` and `index_add_` stay library calls: the JAX package
computes this gather outside any Pallas kernel.

Rows that the table axis repeats count once: the T ranks of data
coordinate d hold the same batch, and rank (d, t) trains only row block
t of it (`row_share`: ``ceil(B/T)`` rows, the last block padded with
masked rows), so the loss and its row count sum once over the world.
The eval step gathers the T blocks back over the `table` group.

Three paths run this step: LR (the default model) on a mesh, the
fully-sharded engine's overflow fallback (the ``full`` layout, the
engine's own), and mesh evaluation for the replicated engine (the
``table`` layout).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from xflow_tpu_torch.metrics import binary_logloss_from_logits, reference_pctr
from xflow_tpu_torch.parallel import collectives as C
from xflow_tpu_torch.parallel.mesh import Mesh
from xflow_tpu_torch.telemetry import scope
from xflow_tpu_torch.train.state import TrainState
from xflow_tpu_torch.train.step import health_mode, nonfinite_guard_on

# train steps the row-major sharded step ran (a run can show that a
# fully-sharded engine's overflow fallback went through it)
RUNS = {"row_major": 0}


# ------------------------------------------------------------ shared parts

def mesh_loss(logits, labels, row_mask, group=None):
    """(loss, rows): the masked BCE summed over the group's rows, divided
    by their count, the same on every rank of the group."""
    per_row = binary_logloss_from_logits(logits, labels)
    loss_sum = C.all_reduce((per_row * row_mask).sum(), group)
    rows = C.reduce_sum_tensor(row_mask.sum(), group)
    return loss_sum / torch.clamp(rows, min=1.0), rows


def _sq(x: torch.Tensor) -> torch.Tensor:
    return (x.detach().float() ** 2).sum()


def finish_step(cfg, mesh: Mesh, layout: str, state: TrainState, new_tables: dict,
                new_opt: dict, loss, rows, grads: dict):
    """The end of every mesh step: the health norms over the whole table
    (each rank's squared sums added over the ranks that split it), and
    the non-finite guard with one flag for all ranks (MIN over the
    world), so a discard is rank-symmetric. Returns (state, metrics)."""
    metrics = {"loss": loss.detach(), "rows": rows}
    names = sorted(new_tables)
    mode = health_mode(cfg)
    if mode != "off":
        with torch.no_grad():
            parts = []
            for n in names:
                g = grads.get(n)
                parts += [_sq(g) if g is not None else torch.zeros((), device=rows.device),
                          _sq(new_tables[n] - state.tables[n]), _sq(new_tables[n])]
            tot = C.reduce_sum_tensor(torch.stack(parts), mesh.owner_group(layout))
            sq = tot.reshape(len(names), 3)
            metrics["grad_norm"] = torch.sqrt(sq[:, 0].sum())
            metrics["update_norm"] = torch.sqrt(sq[:, 1].sum())
            metrics["param_norm"] = torch.sqrt(sq[:, 2].sum())
            if mode == "full":
                for i, n in enumerate(names):
                    metrics[f"grad_norm.{n}"] = torch.sqrt(sq[i, 0])
                    metrics[f"update_norm.{n}"] = torch.sqrt(sq[i, 1])
                    metrics[f"param_norm.{n}"] = torch.sqrt(sq[i, 2])
    new_state = TrainState(new_tables, new_opt, state.step + 1)
    if not nonfinite_guard_on(cfg):
        return new_state, metrics
    with torch.no_grad():
        ok = torch.isfinite(loss)
        for t in new_tables.values():
            ok = ok & torch.isfinite(t).all()
        for st in new_opt.values():
            for t in st.values():
                ok = ok & torch.isfinite(t).all()
        flag = ok.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    good = bool(flag.item())
    if not good:
        new_state = TrainState(state.tables, state.opt_state, new_state.step)
    return new_state, dict(metrics, update_ok=good)


# --------------------------------------------------------- host row share

def row_share(arrays: dict, mesh: Mesh) -> dict:
    """This rank's row block of its data coordinate's row-major batch,
    shipped as (unique_slots, inverse) for the pull: rows
    ``[t*b, (t+1)*b)`` with ``b = ceil(B/T)``, padded with masked rows.
    Labels and row_mask come along; `fields` when the batch has them."""
    B = int(np.asarray(arrays["labels"]).shape[0])
    T = mesh.table
    b = -(-B // T)
    lo, hi = mesh.t * b, min((mesh.t + 1) * b, B)
    out = {}
    for key in ("slots", "fields", "mask", "labels", "row_mask"):
        if key not in arrays:
            continue
        a = np.asarray(arrays[key])
        part = a[lo:hi] if hi > lo else a[:0]
        pad = b - part.shape[0]
        if pad:
            part = np.concatenate([part, np.zeros((pad,) + a.shape[1:], a.dtype)])
        out[key] = np.ascontiguousarray(part)
    slots = out.pop("slots")
    uniq, inv = np.unique(slots.astype(np.int64).ravel(), return_inverse=True)
    out["unique_slots"] = uniq.astype(np.int64)
    out["inverse"] = inv.astype(np.int32).reshape(slots.shape)
    return out


# ------------------------------------------------------------- pull/push

class PullPlan:
    """The exchange of one batch's unique slots (sorted ascending) with
    the ranks that own them in `layout`: the per-owner counts (one
    all_to_all) and the ids each owner serves, as local row indices (one
    all_to_all). `send[j]` ids went to owner j, `recv[j]` came from
    requester j."""

    def __init__(self, uniq: torch.Tensor, num_slots: int, mesh: Mesh, layout: str):
        self.group = mesh.owner_group(layout)
        n = mesh.owners(layout)
        per = num_slots // n
        owner = torch.div(uniq, per, rounding_mode="floor")
        send = torch.bincount(owner, minlength=n).to(torch.int64)
        recv = C.exchange(send, self.group)
        both = torch.stack([send, recv]).cpu()  # the one host read of the splits
        self.send, self.recv = both[0].tolist(), both[1].tolist()
        ids = C.all_to_all_v(uniq, self.send, self.recv, self.group)
        self.local_ids = ids - mesh.owner_index(layout) * per


class PullRows(torch.autograd.Function):
    """The rows of this batch's unique slots from their owners (forward),
    and the push of their gradient into this rank's dense shard gradient
    (backward)."""

    @staticmethod
    def forward(ctx, table_local, plan: PullPlan):
        ctx.plan, ctx.shape = plan, tuple(table_local.shape)
        served = table_local.index_select(0, plan.local_ids)
        return C.all_to_all_v(served, plan.recv, plan.send, plan.group)

    @staticmethod
    def backward(ctx, d_rows):
        plan = ctx.plan
        got = C.all_to_all_v(d_rows.contiguous(), plan.send, plan.recv, plan.group)
        d_table = d_rows.new_zeros(ctx.shape)
        d_table.index_add_(0, plan.local_ids, got)
        return d_table, None


def pulled_logits(model, tables_local: dict, batch: dict, cfg, mesh: Mesh, layout: str):
    """Logits of the rank's row block through the pull: every table's
    rows of the batch's unique slots, then the model's row-major forward
    with the slots re-indexed into them."""
    plan = PullPlan(batch["unique_slots"].long(), cfg.num_slots, mesh, layout)
    pulled = {n: PullRows.apply(t, plan) for n, t in tables_local.items()}
    rb = {"slots": batch["inverse"], "mask": batch["mask"], "labels": batch["labels"],
          "row_mask": batch["row_mask"]}
    if "fields" in batch:
        rb["fields"] = batch["fields"]
    return model(pulled, rb)


def make_sharded_train_step(model, optimizer, cfg, mesh: Mesh, layout: str = "full") -> Callable:
    """train_step(state, batch) -> (state, metrics) over a `row_share`
    batch, the state holding this rank's rows of every table in
    `layout`. The loss sums over the world (each row once)."""

    def train_step(state: TrainState, batch: dict):
        RUNS["row_major"] += 1
        # "train_step" brackets the whole step, its collectives included;
        # inside it the single-device step's ranges
        with scope("train_step"):
            params = {k: t.detach().requires_grad_(True) for k, t in state.tables.items()}
            with torch.enable_grad(), scope("grad"):
                with scope("gather"):
                    logits = pulled_logits(model, params, batch, cfg, mesh, layout)
                with scope("loss"):
                    loss, rows = mesh_loss(logits, batch["labels"], batch["row_mask"])
                got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                grads = {k: torch.zeros_like(t) if g is None else g
                         for (k, t), g in zip(state.tables.items(), got)}
            with torch.no_grad(), scope("optimizer"):
                new_tables, new_opt = optimizer.apply(state.tables, state.opt_state, grads,
                                                      cfg)
            return finish_step(cfg, mesh, layout, state, new_tables, new_opt, loss, rows,
                               grads)

    return train_step


def make_sharded_eval_step(model, cfg, mesh: Mesh, layout: str = "full") -> Callable:
    """eval_step(tables, batch) -> pctr of the data coordinate's rows
    [T * ceil(B/T)] (the row blocks gathered over the `table` group; the
    caller keeps the first B)."""

    def eval_step(tables: dict, batch: dict):
        with torch.no_grad():
            p = reference_pctr(pulled_logits(model, tables, batch, cfg, mesh, layout))
            return C.all_gather(p.contiguous(), mesh.table_group)

    return eval_step


def gather_state(state: TrainState, mesh: Mesh, layout: str) -> TrainState:
    """Whole tables and optimizer leaves from their shards (an all_gather
    over the ranks that split them), on every rank; the step as is."""

    def whole(x):
        return C.all_gather(x.contiguous(), mesh.owner_group(layout)) if x.ndim else x

    with torch.no_grad():
        tables = {n: whole(t) for n, t in state.tables.items()}
        opt = {n: {k: whole(v) for k, v in st.items()} for n, st in state.opt_state.items()}
    return TrainState(tables, opt, state.step)
