"""The replicated sorted engine (`xflow_tpu/parallel/sorted_sharded.py`):
fused FM on a mesh with the table split over the ``table`` axis only.

Layout: the fused ``wv`` table and its FTRL state sit in the ``table``
layout of `parallel/mesh.py`: rank (d, t) owns ``S/T`` slots, ``n_win/T``
whole windows, repeated across ``d`` (D times the table memory, for
fewer collectives than the fully-sharded engine).

Per step on rank (d, t): the data coordinate's rows are planned over
the FULL table (one flat plan), so the rank's windows are one
contiguous span of the sorted stream. The rank slices its
``win_off[t*wpt : (t+1)*wpt + 1]``, rebases the slots to its shard and
runs kernel #1 (`table_gather_sorted`) on the local shard; positions
outside its span (slots out of the shard's range, which gather 0) are
masked out with `where`, never a multiply, so nothing out of span can
poison a sum as NaN * 0. Then #2 (`row_sums_sorted`) and ONE
`all_reduce` over ``table`` of the per-row partial sums, the loss and
its row count over ``data``. Backward: #4 (`scatter_sorted`) into the
shard's gradient, then the gradient `all_reduce` over ``data`` (the
table is repeated there), the data-parallel allreduce. The optimizer
runs two-pass.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from xflow_tpu_torch.ops.sorted_table import (
    WINDOW,
    compact_plan_wire,
    plan_sorted_batch,
    row_sums_sorted,
    table_gather_sorted,
    wire_mask,
    wire_rows,
)
from xflow_tpu_torch.parallel import collectives as C
from xflow_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, Mesh
from xflow_tpu_torch.parallel.train_step import finish_step, mesh_loss
from xflow_tpu_torch.train.state import TrainState


def validate_sorted_sharded(cfg, mesh: Mesh) -> None:
    """Reject configs the replicated engine cannot run, with the JAX
    package's reasons and words (a data coordinate is its process, so
    each plans one sub-plan)."""
    d, t = mesh.shape[DATA_AXIS], mesh.shape[TABLE_AXIS]
    p = d
    S = cfg.num_slots
    if S % (t * WINDOW) != 0:
        raise ValueError(
            f"sorted sharded layout needs num_slots (2^{cfg.data.log2_slots}) "
            f"divisible by table_axis*WINDOW = {t}*{WINDOW}"
        )
    if d % p != 0:
        raise ValueError(
            f"sorted sharded layout needs the data axis ({d}) divisible by "
            f"the process count ({p}): each process plans its rows into d/P "
            "sub-plans"
        )
    if cfg.data.batch_size % (d // p) != 0:
        raise ValueError(
            f"per-process batch_size {cfg.data.batch_size} not divisible by "
            f"the local data-shard count {d // p} (data axis {d} / {p} "
            "process(es))"
        )
    if not (cfg.model.name == "fm" and cfg.model.fm_fused):
        raise ValueError("sorted sharded layout supports fused FM only")
    if cfg.data.sorted_sub_batches not in (0, d // p):
        raise ValueError(
            f"data.sorted_sub_batches={cfg.data.sorted_sub_batches} conflicts "
            f"with the mesh sorted path (per-process plan count = {d // p}); "
            "leave it 0"
        )


def sorted_arrays(batch, cfg) -> dict:
    """The step's host arrays of a data coordinate's batch: its flat plan
    over the whole table in the compact wire dtypes, labels, row_mask."""
    rows = cfg.data.batch_size
    plan = plan_sorted_batch(batch.slots, batch.mask, cfg.num_slots, wire=rows <= (1 << 16))
    out = {"labels": batch.labels, "row_mask": batch.row_mask,
           "sorted_slots": plan.sorted_slots, "sorted_row": plan.sorted_row,
           "sorted_mask": plan.sorted_mask, "win_off": plan.win_off}
    return compact_plan_wire(out, rows_bound=rows)


def local_logits(wv_local: torch.Tensor, batch: dict, cfg, mesh: Mesh) -> torch.Tensor:
    """Rank (d, t)'s forward: logits [R] of the data coordinate's rows."""
    from xflow_tpu_torch.models.fm import fm_logits_from_sums, stack_channels

    T = mesh.table
    S_local = cfg.num_slots // T
    wpt = (cfg.num_slots // WINDOW) // T
    t = mesh.t
    K = 1 + cfg.model.v_dim
    sorted_slots = batch["sorted_slots"]
    sorted_row = wire_rows(batch["sorted_row"])
    sorted_mask = wire_mask(batch["sorted_mask"])
    off_local = batch["win_off"][t * wpt : (t + 1) * wpt + 1]
    slots_local = sorted_slots - t * S_local
    occ_t = table_gather_sorted(wv_local, slots_local, off_local, cfg.data.sorted_bf16)
    pos = torch.arange(sorted_slots.shape[0], dtype=torch.int32, device=sorted_slots.device)
    in_span = (pos >= off_local[0]) & (pos < off_local[-1])
    occm_t = torch.where(in_span[None, :], occ_t[:K],
                         torch.zeros((), dtype=occ_t.dtype, device=occ_t.device))
    occm_t = occm_t * sorted_mask[None, :]
    stacked = stack_channels(occm_t, K).contiguous()
    partial = row_sums_sorted(stacked, sorted_row, batch["labels"].shape[0])
    sums = C.all_reduce(partial, mesh.table_group)  # the one forward collective
    return fm_logits_from_sums(sums, K, cfg)


def make_sorted_sharded_train_step(optimizer, cfg, mesh: Mesh) -> Callable:
    """train_step(state, batch) -> (state, metrics) on rank (d, t): the
    state holds t's ``[S/T, K]`` rows of ``wv`` and its FTRL leaves; the
    batch the coordinate's flat plan (`sorted_arrays`)."""
    validate_sorted_sharded(cfg, mesh)

    def train_step(state: TrainState, batch: dict):
        wv = state.tables["wv"].detach().requires_grad_(True)
        with torch.enable_grad():
            logits = local_logits(wv, batch, cfg, mesh)
            loss, rows = mesh_loss(logits, batch["labels"], batch["row_mask"], mesh.data_group)
            (grad,) = torch.autograd.grad(loss, [wv])
        with torch.no_grad():
            dist.all_reduce(grad, group=mesh.data_group)  # the table repeats over data
            new_tables, new_opt = optimizer.apply(
                {"wv": state.tables["wv"]}, state.opt_state, {"wv": grad}, cfg)
        return finish_step(cfg, mesh, "table", state, new_tables, new_opt, loss, rows,
                           {"wv": grad})

    return train_step
