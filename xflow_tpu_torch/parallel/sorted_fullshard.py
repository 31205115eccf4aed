"""The fully-sharded sorted engine (`xflow_tpu/parallel/sorted_fullshard.py`),
the default mesh engine for fused FM, MVM and FFM.

The table and its optimizer state are split over every rank of the mesh
(the ``full`` layout of `parallel/mesh.py`): rank ``o = d*T + t`` owns
``S/W`` slots, ``wpo`` whole windows, and nothing is repeated anywhere,
as ps-lite splits its key space over all servers.

Per step, on rank (d, t):

1. HOST: the data coordinate's batch is slot-sorted once
   (`plan_sorted_batch`) and cut at owner-block boundaries, each block's
   occurrences one contiguous span of the sorted stream, into
   fixed-capacity buffers (`fullshard_buffers`), the rank keeping its own
   column t: ``fs_* [D_dst, cap]``. Pads carry the block's last local
   slot with mask 0.
2. One all_to_all over ``data`` of ``fs_slots``, ``fs_row``, ``fs_mask``,
   ``fs_off`` (and ``fs_fields``) brings the rank the D buffers (one per
   source coordinate) that hold its block; the compact wire dtypes cross
   as bytes (`collectives.exchange`) and widen after.
3. Kernel #5 (`table_gather_sorted_multi`) gathers the rows from the
   local ``[S/W, K]`` shard over the D buffers, with the received
   ``fs_off`` as its buffer-local window offsets; rows are globalized by
   source (``grow = row + src * R``).
4. The row side reduces the occurrences into per-row (or per-(row,
   field)) partial sums, by #2 (`row_sums_sorted`: FM, MVM's product
   side) or `segment_sum_channels` (MVM's segment side, FFM), and
   `owner_reduce` returns them to their rows: `reduce_scatter` over
   ``data`` then `all_reduce` over ``table``. Aggregated rows cross the
   wire, never table rows.
5. Backward: the row cotangent is all-gathered over ``data`` (the
   reduce_scatter's backward, or the custom ops' `broadcast_rows`), and
   #6 (`scatter_sorted_multi`) scatters into the local shard's gradient.
   The optimizer runs two-pass on the shard.

The JAX engine restores the table-axis cotangent inside MVM's product
op and FFM's op (`restore_dP`, `restore_dl`: a psum over 'table')
because shard_map's transpose hands each 'table' copy 1/T of it. The
port's collectives hand every rank the whole cotangent
(`parallel/collectives.py`), so those hooks are the identity here; the
T = 2 parity tests hold both ops to the single-device step.

A hot feature's occurrences all land in one owner block (ps-lite's one
server owns the hot key too); `data.fullshard_slack` sizes the buffers,
and a batch that overflows them raises `FullshardOverflowError` at plan
time, which the trainer answers by running the row-major sharded step
for that batch on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from xflow_tpu_torch.metrics import reference_pctr
from xflow_tpu_torch.ops.sorted_table import (
    CHUNK,
    WINDOW,
    SortedPlan,
    compact_plan_wire,
    plan_sorted_batch,
    row_sums_sorted,
    segment_sum_channels,
    table_gather_sorted_multi,
    wire_mask,
    wire_rows,
)
from xflow_tpu_torch.parallel import collectives as C
from xflow_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, Mesh
from xflow_tpu_torch.parallel.train_step import finish_step, mesh_loss
from xflow_tpu_torch.train.state import TrainState


class FullshardOverflowError(ValueError):
    """An owner block's occurrences exceed the buffer capacity (data more
    skewed than data.fullshard_slack allows). Distinct from other config
    errors so the trainer can run the row-major sharded step for the
    offending batch; on a mesh every rank's flag goes into one
    all_reduce(MAX) a batch, so all ranks fall back on the same batch."""


def _dims(cfg, mesh: Mesh):
    """(D, T, P): a data coordinate plays the part of a JAX process, so
    P = D and each coordinate plans one shard."""
    d, t = mesh.shape[DATA_AXIS], mesh.shape[TABLE_AXIS]
    return d, t, d


def validate_sorted_fullshard(cfg, mesh: Mesh) -> None:
    """Reject configs the fully-sharded engine cannot run, with the JAX
    package's reasons and words."""
    d, t, p = _dims(cfg, mesh)
    S = cfg.num_slots
    if S % (d * t * WINDOW) != 0:
        raise ValueError(
            f"fullshard layout needs num_slots (2^{cfg.data.log2_slots}) "
            f"divisible by data*table*WINDOW = {d}*{t}*{WINDOW} (each device "
            "owns whole windows)"
        )
    if cfg.model.name == "fm":
        if not cfg.model.fm_fused:
            raise ValueError("fullshard FM needs model.fm_fused=true (one table)")
    elif cfg.model.name not in ("mvm", "ffm"):
        raise ValueError(
            "fullshard layout supports fused FM, MVM, and FFM (LR keeps the "
            f"GSPMD row-major path); got model={cfg.model.name}"
        )
    if d % p != 0:
        raise ValueError(
            f"fullshard layout needs the data axis ({d}) divisible by the "
            f"process count ({p}): each process plans its rows into d/P shards"
        )
    if cfg.data.batch_size % (d // p) != 0:
        raise ValueError(
            f"per-process batch_size {cfg.data.batch_size} not divisible by "
            f"the local data-shard count {d // p}"
        )
    if cfg.data.sorted_sub_batches not in (0, d // p):
        raise ValueError(
            f"data.sorted_sub_batches={cfg.data.sorted_sub_batches} conflicts "
            f"with the fullshard plan count (= {d // p} per process); leave it 0"
        )
    if cfg.data.fullshard_slack < 1.0:
        raise ValueError(
            f"data.fullshard_slack={cfg.data.fullshard_slack} < 1 cannot hold "
            "even perfectly uniform occupancy"
        )


def fullshard_capacity(cfg, mesh: Mesh) -> int:
    """Per-(source, owner block) buffer capacity: a CHUNK multiple
    covering `slack` times the uniform-hash expectation of real
    occurrences, plus one spare CHUNK for the buffer's own pads."""
    d, t, p = _dims(cfg, mesh)
    rows = cfg.data.batch_size // (d // p)
    expect = rows * cfg.data.max_nnz / (d * t)
    cap = int(np.ceil(cfg.data.fullshard_slack * expect / CHUNK)) * CHUNK
    return max(cap, CHUNK) + CHUNK


def fullshard_buffers(plan: SortedPlan, D: int, T: int, cap: int, s_local: int,
                      slack: float, with_fields: bool = False, *, n_real: int,
                      columns: Optional[tuple] = None) -> dict:
    """Cut ONE source's flat sorted plan at owner-block boundaries into
    per-destination buffers: ``fs_slots/fs_row/fs_mask`` ``[T, D, cap]``
    (+ ``fs_fields``) and ``fs_off`` ``[T, D, wpo+1]``, buffer-local
    window offsets with the last entry at `cap`, so the block's last
    window owns the pads (slot s_local-1, mask 0). Spans are clamped to
    `n_real`, the real occurrence count: the plan's own pads never count
    against the capacity. `columns` keeps only those table columns (a
    rank builds its own), in that order; default all T."""
    cols = tuple(range(T)) if columns is None else tuple(columns)
    win_off = plan.win_off
    wpo = (win_off.shape[0] - 1) // (D * T)
    nc = len(cols)
    slots = np.full((nc, D, cap), s_local - 1, np.int32)
    row = np.zeros((nc, D, cap), np.int32)
    mask = np.zeros((nc, D, cap), np.float32)
    fields = np.zeros((nc, D, cap), np.int32) if with_fields else None
    off = np.empty((nc, D, wpo + 1), np.int32)
    for i, t in enumerate(cols):
        for d in range(D):
            o = d * T + t
            lo = min(int(win_off[o * wpo]), n_real)
            hi = min(int(win_off[(o + 1) * wpo]), n_real)
            L = hi - lo
            if L > cap:
                raise FullshardOverflowError(
                    f"owner block {o} holds {L} occurrences > buffer capacity "
                    f"{cap}: the hash distribution is more skewed than "
                    f"data.fullshard_slack={slack} allows — raise it (a hot "
                    "feature's occurrences all land in one block)"
                )
            slots[i, d, :L] = plan.sorted_slots[lo:hi] - o * s_local
            row[i, d, :L] = plan.sorted_row[lo:hi]
            mask[i, d, :L] = plan.sorted_mask[lo:hi]
            if with_fields:
                fields[i, d, :L] = plan.sorted_fields[lo:hi]
            off[i, d, :wpo] = np.minimum(win_off[o * wpo : (o + 1) * wpo], n_real) - lo
            off[i, d, wpo] = cap
    out = {"fs_slots": slots, "fs_row": row, "fs_mask": mask, "fs_off": off}
    if with_fields:
        out["fs_fields"] = fields
    return out


def plan_fullshard_batch(slots: np.ndarray, mask: np.ndarray, cfg, mesh: Mesh,
                         fields: Optional[np.ndarray] = None,
                         column: Optional[int] = None) -> dict:
    """A data coordinate's [batch_size, max_nnz] batch -> its buffers
    ``[T, D, cap]`` (``fs_off [T, D, wpo+1]``), or only column `column`'s
    ``[D, cap]``, planned by the native planner. JAX's
    `plan_fullshard_batch` stacks one such plan a local data shard, so
    its ``[i]`` is this function on rows slice i."""
    d, t, p = _dims(cfg, mesh)
    B = slots.shape[0]
    if B != cfg.data.batch_size or slots.shape[1] != cfg.data.max_nnz:
        raise ValueError(
            f"batch shape {slots.shape} != configured "
            f"(batch_size={cfg.data.batch_size}, max_nnz={cfg.data.max_nnz})"
        )
    cap = fullshard_capacity(cfg, mesh)
    s_local = cfg.num_slots // (d * t)
    plan = plan_sorted_batch(slots, mask, cfg.num_slots, fields=fields)
    out = fullshard_buffers(
        plan, d, t, cap, s_local, cfg.data.fullshard_slack, fields is not None,
        n_real=slots.size, columns=None if column is None else (column,),
    )
    if column is not None:
        out = {k: v[0] for k, v in out.items()}
    return out


def fullshard_arrays(batch, cfg, mesh: Mesh, with_fields: bool) -> dict:
    """The step's host arrays of one batch on this rank: its column's
    buffers in the compact wire dtypes, labels and row_mask. Raises
    `FullshardOverflowError` on a batch too skewed for the slack."""
    out = {"labels": batch.labels, "row_mask": batch.row_mask}
    out.update(plan_fullshard_batch(
        np.asarray(batch.slots), np.asarray(batch.mask), cfg, mesh,
        fields=np.asarray(batch.fields) if with_fields else None, column=mesh.t,
    ))
    return compact_plan_wire(out, rows_bound=cfg.data.batch_size,
                             fields_bound=cfg.model.num_fields if with_fields else 0)


def _mode_statics(cfg):
    """(table name, K, nf, bf16, plus): the logical row width, MVM [k],
    FM [1+k], FFM [1+nf·k]."""
    mvm, ffm = cfg.model.name == "mvm", cfg.model.name == "ffm"
    nf = cfg.model.num_fields
    K = cfg.model.v_dim if mvm else (1 + nf * cfg.model.v_dim if ffm else 1 + cfg.model.v_dim)
    return ("v" if mvm else "wv", K, nf, cfg.data.sorted_bf16,
            1.0 if cfg.model.mvm_plus_one else 0.0)


def _batch_mode(cfg, batch: dict) -> str:
    if cfg.model.name == "mvm":
        return "mvm_segment" if "fs_fields" in batch else "mvm_product"
    return "ffm" if cfg.model.name == "ffm" else "fm"


def local_logits(mode: str, tbl_local: torch.Tensor, batch: dict, cfg, mesh: Mesh) -> torch.Tensor:
    """Rank (d, t)'s forward, shared by the train and eval steps: logits
    [R] of its data coordinate's rows (the same on its T ranks)."""
    from xflow_tpu_torch.models.fm import fm_logits_from_sums, stack_channels

    _, K, nf, bf16, plus = _mode_statics(cfg)
    D, g = mesh.data, mesh.data_group
    R = batch["labels"].shape[0]
    r_slots = C.exchange(batch["fs_slots"], g)  # [D_src, cap]
    r_row = wire_rows(C.exchange(batch["fs_row"], g))
    r_mask = wire_mask(C.exchange(batch["fs_mask"], g))
    r_off = C.exchange(batch["fs_off"], g)  # [D_src, wpo+1]
    mask_flat = r_mask.reshape(-1)
    occ_t = table_gather_sorted_multi(tbl_local, r_slots.reshape(-1), r_off, bf16)
    # rows arrive source-local [0, R); one row space covers all D sources
    src = torch.arange(D, dtype=torch.int32, device=r_row.device)[:, None] * R
    grow = (r_row + src).reshape(-1)

    def owner_reduce(partials):  # [D, ...] -> this coordinate's rows
        return C.all_reduce(C.reduce_scatter(partials, g), mesh.table_group)[0]

    def broadcast_rows(arr):
        return C.all_gather(arr.contiguous(), g)

    if mode in ("ffm", "mvm_segment"):
        r_fields = wire_rows(C.exchange(batch["fs_fields"], g)).reshape(-1)
    if mode == "ffm":
        from xflow_tpu_torch.models.ffm import make_ffm_row_op

        op = make_ffm_row_op(
            lambda data, seg: owner_reduce(
                segment_sum_channels(data, seg, D * R * nf).reshape(D, R * nf, K + 1)
            ).reshape(R, nf, K + 1),
            broadcast_rows, nf, cfg.model.v_dim,
        )
        return op(occ_t, mask_flat, r_fields, grow)
    if mode == "mvm_segment":
        occm_t = occ_t[:K] * mask_flat[None, :]
        seg = grow * nf + r_fields
        # the mask as an extra channel: its segment sum counts a (row,
        # field)'s occurrences, `present`
        stacked = torch.cat([occm_t, mask_flat[None, :]], dim=0)
        sums = segment_sum_channels(stacked, seg, D * R * nf)
        sums = owner_reduce(sums.reshape(D, R * nf, K + 1)).reshape(R, nf, K + 1)
        s, present = sums[..., :K], sums[..., K] > 0
        factors = torch.where(present[..., None], s + plus,
                              torch.ones((), dtype=s.dtype, device=s.device))
        return torch.prod(factors, dim=1).sum(dim=-1)
    if mode == "mvm_product":
        from xflow_tpu_torch.models.mvm import make_row_products

        # log-space product channels add over shards, so they reduce like
        # FM's row sums
        op = make_row_products(
            lambda ch, rows_: owner_reduce(row_sums_sorted(ch, rows_, D * R).reshape(D, R, -1)),
            broadcast_rows, K,
        )
        return op(occ_t[:K] + plus, mask_flat, grow).sum(dim=1)
    occm_t = occ_t[:K] * mask_flat[None, :]
    stacked = stack_channels(occm_t, K).contiguous()
    rs = row_sums_sorted(stacked, grow, D * R)  # [D*R, ch]
    return fm_logits_from_sums(owner_reduce(rs.reshape(D, R, -1)), K, cfg)


def make_fullshard_train_step(optimizer, cfg, mesh: Mesh) -> Callable:
    """train_step(state, batch) -> (state, metrics) on rank (d, t): the
    state holds the rank's ``[S/W, K]`` rows of the table and its
    optimizer leaves; the batch its column's buffers, labels and
    row_mask. The row side is chosen per batch (`_batch_mode`)."""
    validate_sorted_fullshard(cfg, mesh)
    tname = _mode_statics(cfg)[0]

    def train_step(state: TrainState, batch: dict):
        tbl = state.tables[tname].detach().requires_grad_(True)
        with torch.enable_grad():
            logits = local_logits(_batch_mode(cfg, batch), tbl, batch, cfg, mesh)
            loss, rows = mesh_loss(logits, batch["labels"], batch["row_mask"], mesh.data_group)
            (grad,) = torch.autograd.grad(loss, [tbl])
        with torch.no_grad():
            new_tables, new_opt = optimizer.apply(
                {tname: state.tables[tname]}, state.opt_state, {tname: grad}, cfg)
        return finish_step(cfg, mesh, "full", state, new_tables, new_opt, loss, rows,
                           {tname: grad})

    return train_step


def make_fullshard_eval_step(cfg, mesh: Mesh) -> Callable:
    """eval_step(tables, batch) -> pctr [R] of the data coordinate's rows
    from the same host plan the train step takes (one all_to_all and
    `owner_reduce`, no row-major arrays)."""
    validate_sorted_fullshard(cfg, mesh)
    tname = _mode_statics(cfg)[0]

    def eval_step(tables: dict, batch: dict):
        with torch.no_grad():
            return reference_pctr(
                local_logits(_batch_mode(cfg, batch), tables[tname], batch, cfg, mesh))

    return eval_step
