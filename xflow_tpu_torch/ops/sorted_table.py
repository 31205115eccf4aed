"""Sorted-window table engine: host-side plans and the table kernels of
the FM and MVM inference and training paths.

The host sorts each batch's feature occurrences by table slot
(`plan_sorted_batch`: the native radix sort of `data/native.py`,
bit-identical to the JAX package's planners and to the numpy one here,
`plan_sorted_plain`) and ships `sorted_slots [Np]`, `sorted_row [Np]`, `sorted_mask [Np]` and
`win_off [S/WINDOW + 1]`. On the device:

- `table_gather_sorted` returns each occurrence's table row, transposed:
  `occ_t [K8, Np]`, rows K..K8 zero, pad columns holding row S-1; its
  backward is the windowed scatter-add `scatter_sorted` (`[S, K]`);
- `row_sums_sorted` reduces per-occurrence channels into per-row sums:
  `out [B, ch]`; its backward is the row gather `d_out.T[:, rows]`;
- `scatter_ftrl_sorted` is the scatter-add fused with the FTRL update:
  `(w', n', z')` from the occurrence cotangent, the gradient never
  materialised;
- `table_gather_sorted_multi` is the gather over a STACKED plan
  (`plan_sorted_stacked`: NS row-contiguous sub-batches, each sorted on
  its own, concatenated), window-major over the buffers; its backward is
  `scatter_sorted_multi`. `sorted_gather_map` runs a model's row side
  over either plan form;
- `segment_sum_channels` reduces occurrences into (row, field) segments
  (MVM's segment row side), plain PyTorch as in the JAX package.

Each kernel op (gather, row sum, scatter, scatter+FTRL, and the
multi-buffer gather and scatter) has a hand-written CUDA kernel
(`csrc/*.cu`) and a plain PyTorch version beside it. A wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. `LAUNCHES` counts kernel launches, so a
run can show that it went through the kernels.

Tables are logical `[S, K]` here (see the package docstring); `pack_of`
recognises the JAX package's packed `[S/8, 8K]` layout so
`weights.tables_from_jax` can unpack it.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from xflow_tpu_torch.optim.ftrl import update_one

WINDOW = 2048  # table slots per window of the plan's win_off
CHUNK = 512  # plan arrays are padded to a multiple of this
PACK = 8  # slots per packed table row in the JAX package's layout

LAUNCHES = {
    "gather_sorted": 0, "row_sums": 0, "scatter_sorted": 0, "scatter_ftrl": 0,
    "gather_sorted_multi": 0, "scatter_sorted_multi": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _k8(k: int) -> int:
    return max(8, ((k + 7) // 8) * 8)


def padded_len(n: int) -> int:
    return (n // CHUNK + 2) * CHUNK


class SortedPlan(NamedTuple):
    """Host-computed slot-sorted layout of one batch's occurrences,
    padded to `padded_len`; pads sit at slot S-1 with row 0 and mask 0.
    `distinct` is a host int: the distinct slots among the unpadded
    occurrences (the table rows the step touches; pads are none), summed
    over the sub-plans of a stacked plan."""

    sorted_slots: np.ndarray  # int32 [Np]
    sorted_row: np.ndarray  # int32 [Np]
    sorted_mask: np.ndarray  # float32 [Np]
    win_off: np.ndarray  # int32 [S/WINDOW + 1]
    sorted_fields: Optional[np.ndarray] = None  # int32 [Np]
    distinct: Optional[int] = None


def plan_sorted_plain(
    slots: np.ndarray,
    mask: np.ndarray,
    num_slots: int,
    fields: Optional[np.ndarray] = None,
) -> SortedPlan:
    """The numpy planner (the JAX package's): sort a [B, F] batch's
    occurrences by table slot (stable argsort), pad to `padded_len`, and
    record each WINDOW's first position in `win_off`. Masked occurrences
    keep their slot; their mask zeroes them later. The plain version the
    native planner is held to, in the tests."""
    flat_slots = np.ascontiguousarray(slots, np.int32).ravel()
    flat_mask = np.ascontiguousarray(mask, np.float32).ravel()
    if flat_slots.size and (
        int(flat_slots.min()) < 0 or int(flat_slots.max()) >= num_slots
    ):
        raise ValueError(
            f"slot out of range [0, {num_slots}): "
            f"min={int(flat_slots.min())} max={int(flat_slots.max())}"
        )
    n = flat_slots.shape[0]
    pad = padded_len(n) - n
    order = np.argsort(flat_slots, kind="stable").astype(np.int32)
    ss = np.concatenate([flat_slots[order], np.full(pad, num_slots - 1, np.int32)])
    distinct = int(np.count_nonzero(np.diff(ss[:n]))) + 1 if n else 0
    win_off = np.searchsorted(ss, np.arange(0, num_slots + 1, WINDOW)).astype(np.int32)
    sorted_fields = None
    if fields is not None:
        flat_fields = np.ascontiguousarray(fields, np.int32).ravel()
        sorted_fields = np.concatenate([flat_fields[order], np.zeros(pad, np.int32)])
    return SortedPlan(
        sorted_slots=ss,
        sorted_row=np.concatenate(
            [(order // slots.shape[1]).astype(np.int32), np.zeros(pad, np.int32)]
        ),
        sorted_mask=np.concatenate([flat_mask[order], np.zeros(pad, np.float32)]),
        win_off=win_off,
        sorted_fields=sorted_fields,
        distinct=distinct,
    )


def plan_sorted_batch(
    slots: np.ndarray,
    mask: np.ndarray,
    num_slots: int,
    fields: Optional[np.ndarray] = None,
    wire: bool = False,
) -> SortedPlan:
    """The slot-sorted plan of a [B, F] batch, bit-identical to
    `plan_sorted_plain`, by the native radix sort (`data/native.py`,
    O(n), the GIL released). `num_slots` must be a multiple of WINDOW,
    as every kernel of the plan requires. `wire=True` has the native
    planner emit the compact wire dtypes directly (uint16 rows, uint8
    mask and fields); the caller has checked the config bounds (rows <=
    2^16, fields < 2^8), and `compact_plan_wire` passes the result
    through untouched. A failed build of the native planner raises."""
    if num_slots % WINDOW:
        raise ValueError(f"num_slots={num_slots} is not a multiple of WINDOW={WINDOW}")
    from xflow_tpu_torch.data.native import native_plan_sorted, native_plan_sorted_wire

    plan = native_plan_sorted_wire if wire else native_plan_sorted
    ss, row, m, f, off, distinct = plan(
        np.ascontiguousarray(slots, np.int32), mask, fields, num_slots, WINDOW,
        padded_len(slots.size),
    )
    return SortedPlan(ss, row, m, off, f, distinct)


_PLAN_POOL = None  # one fixed-size executor a process, never shut down
_PLAN_POOL_LOCK = threading.Lock()


def _plan_pool():
    """The shared planning thread pool, one worker a usable core (at most
    16), created once and never resized, so concurrent callers' map()
    calls never race a pool's shutdown."""
    global _PLAN_POOL
    with _PLAN_POOL_LOCK:
        if _PLAN_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            size = max(1, min(len(os.sched_getaffinity(0)), 16))
            _PLAN_POOL = ThreadPoolExecutor(max_workers=size, thread_name_prefix="xflow-plan")
        return _PLAN_POOL


def map_host_parallel(fn, n: int) -> list:
    """[fn(0), ..., fn(n - 1)] on the shared planning pool (the native
    planner releases the GIL, so plans run on the host's cores), in
    order."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    return list(_plan_pool().map(fn, range(n)))


def plan_sorted_stacked(
    slots: np.ndarray,
    mask: np.ndarray,
    num_slots: int,
    fields: Optional[np.ndarray] = None,
    num_sub: int = 1,
    always_stack: bool = False,
    wire: bool = False,
) -> SortedPlan:
    """Per-sub-batch sorted plans stacked on a leading [NS] axis: the
    [B, F] batch is split into `num_sub` row-contiguous sub-batches,
    each planned on its own (row ids LOCAL to the sub-batch), on the
    shared planning pool. `num_sub=1`
    returns the FLAT plan unless `always_stack`. Each stacked
    `win_off[i]` ends at the sub-plan's length, the `loc_off` contract
    of `table_gather_sorted_multi`. `wire` as in `plan_sorted_batch`."""
    B = slots.shape[0]
    if num_sub <= 1:
        p = plan_sorted_batch(slots, mask, num_slots, fields=fields, wire=wire)
        if not always_stack:
            return p
        return p._replace(**{k: a[None] for k, a in p._asdict().items()
                             if isinstance(a, np.ndarray)})
    if B % num_sub:
        raise ValueError(f"batch {B} not divisible by num_sub {num_sub}")
    bs = B // num_sub

    def one(i):
        return plan_sorted_batch(
            slots[i * bs : (i + 1) * bs], mask[i * bs : (i + 1) * bs], num_slots,
            fields=None if fields is None else fields[i * bs : (i + 1) * bs], wire=wire,
        )

    plans = map_host_parallel(one, num_sub)
    return SortedPlan(*(
        None if parts[0] is None else np.stack(parts) for parts in zip(*(p[:5] for p in plans))
    ), distinct=sum(p.distinct for p in plans))


def auto_sub_batches(batch_size: int, row_state_bytes_per_row: int,
                     target_bytes: int = 1 << 24) -> int:
    """Smallest power-of-two NS (dividing batch_size) that keeps the
    per-sub-batch row-side state under `target_bytes`, with sub-batches
    of at least 1024 rows."""
    ns = 1
    while (
        batch_size % (ns * 2) == 0
        and batch_size // (ns * 2) >= 1024
        and (batch_size // ns) * row_state_bytes_per_row > target_bytes
    ):
        ns *= 2
    return ns


def resolve_sub_batches(cfg) -> int:
    """NS for the sorted layout (cfg.data.sorted_sub_batches; 0 = auto).

    Auto keeps MVM's segment-path [B/NS * nf, k+1] row aggregate under
    16 MiB; FM's row state and MVM's product path are small, so NS = 1
    there (a duplicate-field batch under mvm_exclusive=auto then runs
    the segment row side at NS = 1)."""
    ns = cfg.data.sorted_sub_batches
    B = cfg.data.batch_size
    if ns > 0:
        if B % ns:
            raise ValueError(
                f"data.sorted_sub_batches={ns} must divide batch_size={B}"
            )
        return ns
    if cfg.model.name == "mvm" and cfg.model.mvm_exclusive == "off":
        per_row = cfg.model.num_fields * (cfg.model.v_dim + 1) * 4
        return auto_sub_batches(B, per_row)
    if cfg.model.name == "ffm":
        per_row = cfg.model.num_fields * (cfg.model.num_fields * cfg.model.v_dim + 2) * 4
        return auto_sub_batches(B, per_row)
    return 1


def compact_plan_wire(arrays: dict, rows_bound: int, fields_bound: int = 0) -> dict:
    """Shrink the plan's host-to-device wire format: row ids to uint16
    (when `rows_bound` <= 2^16), fields to uint8 (when `fields_bound` <=
    2^8), the 0/1 mask to uint8, for the flat or stacked plan
    (`sorted_*`) and the fully-sharded engine's buffers (`fs_*`). The
    bounds come from the config, never the data, so every rank of a mesh
    picks the same dtypes. The device side widens them with `wire_rows` /
    `wire_mask`. Raises on a mask that is not 0/1. Arrays already compact
    (the native planner's wire form) pass through untouched."""
    out = dict(arrays)
    if rows_bound <= (1 << 16):
        for key in ("sorted_row", "fs_row"):
            if _dtype(out, key) == np.int32:
                out[key] = np.asarray(out[key]).astype(np.uint16)
    if 0 < fields_bound <= (1 << 8):
        for key in ("sorted_fields", "fs_fields"):
            if _dtype(out, key) == np.int32:
                out[key] = np.asarray(out[key]).astype(np.uint8)
    for key in ("sorted_mask", "fs_mask"):
        if _dtype(out, key) == np.float32:
            m = np.asarray(out[key])
            u8 = m.astype(np.uint8)
            if not (m == u8).all():
                raise ValueError(f"{key} carries non-0/1 values: the mask is a presence mask")
            out[key] = u8
    return out


def _dtype(arrays: dict, key: str):
    return np.asarray(arrays[key]).dtype if key in arrays else None


def wire_rows(sorted_row: torch.Tensor) -> torch.Tensor:
    """Widen a possibly compacted row-id tensor to int32."""
    return sorted_row.to(torch.int32)


def wire_mask(sorted_mask: torch.Tensor) -> torch.Tensor:
    """Widen a possibly compacted mask tensor to float32."""
    return sorted_mask.to(torch.float32)


def pack_of(table, K: int) -> int:
    """Layout of `table` given its logical row width K: 1 = logical
    [S, K] (or a 1-D scalar table), PACK = packed [S/PACK, PACK*K]."""
    if table.ndim != 2 or table.shape[1] == K:
        return 1
    if table.shape[1] == PACK * K:
        return PACK
    raise ValueError(
        f"table shape {tuple(table.shape)} is neither logical [S, {K}] nor "
        f"packed [S/{PACK}, {PACK * K}]"
    )


def dedup_slots(slots: np.ndarray, cap: int):
    """Host-side batch dedup for the row-major paths (`data.dedup`; the
    reference's per-minibatch unique-key Pull): (unique_slots [cap]
    padded with the last unique, inverse [B, F] int32), or None when the
    batch has more than `cap` uniques (or none), in which case the batch
    ships row-major and the direct gather runs."""
    got = dedup_slots_counted(slots, cap)
    return None if got is None else got[:2]


def dedup_slots_counted(slots: np.ndarray, cap: int):
    """`dedup_slots` with the number of uniques as a third item (a host
    int, the table rows the step touches), or None."""
    flat = np.asarray(slots, np.int32).ravel()
    u, inv = np.unique(flat, return_inverse=True)
    if u.size > cap or u.size == 0:
        return None
    pad = np.full(cap - u.size, u[-1], np.int32)
    return (
        np.concatenate([u.astype(np.int32), pad]),
        inv.astype(np.int32).reshape(np.asarray(slots).shape),
        int(u.size),
    )


def table_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Rows ``table[slots]`` of a logical table."""
    return table[slots.long()]


def batch_rows(table: torch.Tensor, batch: dict) -> torch.Tensor:
    """Per-occurrence rows of a row-major batch: the two-level gather when
    the host attached (unique_slots, inverse), else the direct one."""
    if "unique_slots" in batch:
        return table_rows(table, batch["unique_slots"])[batch["inverse"].long()]
    return table_rows(table, batch["slots"])


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "kernel inputs must all lie on one CUDA device, got "
            + ", ".join(str(t.device) for t in tensors)
        )


# ------------------------------------------------------------ windowed gather

def gather_sorted_plain(table: torch.Tensor, sorted_slots: torch.Tensor,
                        bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the gather: [K8, Np], rows K..K8 zero,
    out-of-range slots give 0, `bf16` rounds values to bfloat16."""
    S, K = table.shape
    valid = (sorted_slots >= 0) & (sorted_slots < S)
    rows = table[sorted_slots.clamp(0, S - 1).long()]
    occ = torch.where(valid[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))
    if bf16:
        occ = occ.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((_k8(K), sorted_slots.shape[0]), dtype=table.dtype, device=table.device)
    out[:K] = occ.T
    return out


def gather_sorted_cuda(table: torch.Tensor, sorted_slots: torch.Tensor,
                       bf16: bool = False) -> torch.Tensor:
    """Launch `csrc/gather_sorted.cu` on CUDA tensors.

    Replaces `_gather_pallas` (xflow_tpu/ops/sorted_table.py). Bound by
    bytes on the H100: a 4 B slot and one K-float row read per
    occurrence, K8 floats written. The flat walk (`csrc/gather_flat.cuh`,
    #5's body too): one thread per occurrence copies its row (8 B pairs
    where K is even) down an output column; stores coalesce along the
    occurrence axis and the slot order keeps row reads in shared L2
    sectors."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(table, sorted_slots)
    _check(table, "table", torch.float32, 2)
    _check(sorted_slots, "sorted_slots", torch.int32, 1)
    S, K = table.shape
    np_ = sorted_slots.shape[0]
    out = torch.empty((_k8(K), np_), dtype=torch.float32, device=table.device)
    lib = kernels.load("gather_sorted")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_gather_sorted(
            table.data_ptr(), sorted_slots.data_ptr(), out.data_ptr(),
            S, K, _k8(K), np_, int(bool(bf16)), stream,
        )
    kernels.check(err, "gather_sorted")
    LAUNCHES["gather_sorted"] += 1
    return out


def _gather_forward(table, sorted_slots, bf16):
    if _on_cpu(table, sorted_slots):
        return gather_sorted_plain(table, sorted_slots, bf16)
    return gather_sorted_cuda(table, sorted_slots, bf16)


class TableGatherSorted(torch.autograd.Function):
    """Differentiable in `table`; the backward is the windowed
    scatter-add `scatter_sorted` (`_scatter_pallas` in the JAX package),
    with the forward's `bf16` rounding of the cotangent terms."""

    @staticmethod
    def forward(ctx, table, sorted_slots, win_off, bf16):
        ctx.save_for_backward(sorted_slots, win_off)
        ctx.shape, ctx.bf16 = tuple(table.shape), bf16
        return _gather_forward(table, sorted_slots, bf16)

    @staticmethod
    def backward(ctx, d_occ_t):
        sorted_slots, win_off = ctx.saved_tensors
        num_slots, k = ctx.shape
        d_table = scatter_sorted(
            d_occ_t.contiguous(), sorted_slots, win_off, num_slots, k, ctx.bf16
        )
        return d_table, None, None, None


def table_gather_sorted(table: torch.Tensor, sorted_slots: torch.Tensor,
                        win_off: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Per-occurrence rows of logical `table [S, K]`, transposed:
    [K8, Np]. Pad columns hold row S-1 (multiply by the plan's mask
    before use). `win_off` is the plan's window index; the CUDA kernel
    does not need it, it is taken for the JAX signature."""
    return TableGatherSorted.apply(table, sorted_slots, win_off, bf16)


# ------------------------------------------------------------------- row sums

# The row sum's order (csrc/row_sums.cu): each row's terms are added one
# by one in ascending plan position from +0, terms whose channels are all
# +-0 dropped. A warp orders a row of at most ROW_SUMS_WARP_MAX terms by
# ranks; a longer row is ordered by a block, through a bitmap of
# ROW_SUMS_WINDOW positions at a time (the kernel's WMAX and WWORDS * 32).
ROW_SUMS_WARP_MAX = 128
ROW_SUMS_WINDOW = 40960 * 32


def row_sums_plain(vals_t: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the row sum: [num_rows, ch], any ch; rows
    outside [0, num_rows) skipped. On the CPU `index_add_` adds each
    row's terms in index order from +0, the kernel's order."""
    out = torch.zeros((num_rows, vals_t.shape[0]), dtype=vals_t.dtype, device=vals_t.device)
    keep = (rows >= 0) & (rows < num_rows)
    return out.index_add_(0, rows[keep].long(), vals_t[:, keep].T)


def row_sums_cuda(vals_t: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Launch `csrc/row_sums.cu` on CUDA tensors.

    Replaces `_rowsum_pallas` (xflow_tpu/ops/sorted_table.py). Adds each
    row's terms in ascending plan position from +0, as the TPU kernel and
    `row_sums_plain` on the CPU do, so the sums are bitwise theirs and the
    same from launch to launch. Bound by bytes on the H100 ((ch + 1) * 4 B
    read per occurrence); the fixed order costs about three times that:
    count each row's nonzero terms, reserve each row a segment of
    positions, copy the channels position-major while each position takes
    a slot of its row's segment, then a warp a row ranks the row's
    positions and adds its terms in that order (a block a row, on a side
    stream, for rows of more than ROW_SUMS_WARP_MAX terms). Any ch that is
    a multiple of 4 launches (the JAX kernel takes multiples of 8);
    another ch raises, as do Np not a multiple of 4 and inputs not 16 B
    aligned. Scratch: Np * (ch + 2.25) * 4 B and 12 B a row."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(vals_t, rows)
    _check(vals_t, "vals_t", torch.float32, 2)
    _check(rows, "rows", torch.int32, 1)
    ch, np_ = vals_t.shape
    if rows.shape[0] != np_:
        raise ValueError(f"rows has {rows.shape[0]} entries, vals_t {np_} columns")
    if ch % 4:
        raise ValueError(f"row_sums: ch={ch} must be a multiple of 4 (16 B output quads)")
    if np_ % 4 or vals_t.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError(
            f"row_sums loads 16 B aligned quads: Np={np_} must be a multiple of 4 and vals_t "
            "and rows must start 16 B aligned"
        )
    dev = vals_t.device
    out = torch.empty((num_rows, ch), dtype=torch.float32, device=dev)
    ws = torch.empty(2 + 3 * num_rows, dtype=torch.int32, device=dev)
    flags = torch.empty(np_, dtype=torch.uint8, device=dev)
    pj = torch.empty(np_, dtype=torch.int32, device=dev)
    order = torch.empty(np_, dtype=torch.int32, device=dev)
    copy = torch.empty(np_ * ch, dtype=torch.float32, device=dev)
    lib = kernels.load("row_sums")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_row_sums(
            vals_t.data_ptr(), rows.data_ptr(), out.data_ptr(), ch, np_, num_rows,
            ws.data_ptr(), flags.data_ptr(), pj.data_ptr(), order.data_ptr(), copy.data_ptr(),
            stream,
        )
    kernels.check(err, "row_sums")
    LAUNCHES["row_sums"] += 1
    return out


def _row_sums_forward(vals_t, rows, num_rows):
    if _on_cpu(vals_t, rows):
        return row_sums_plain(vals_t, rows, num_rows)
    return row_sums_cuda(vals_t, rows, num_rows)


class RowSumsSorted(torch.autograd.Function):
    """Differentiable in `vals_t`; the backward is the row gather
    ``d_out.T[:, rows]``, plain torch indexing as in the JAX package
    (`jnp.take` outside any Pallas kernel)."""

    @staticmethod
    def forward(ctx, vals_t, rows, num_rows):
        ctx.save_for_backward(rows)
        return _row_sums_forward(vals_t, rows, num_rows)

    @staticmethod
    def backward(ctx, d_out):
        (rows,) = ctx.saved_tensors
        return d_out.T[:, rows.long()], None, None


def row_sums_sorted(vals_t: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """out[r, c] = sum of vals_t[c, j] over occurrences j with rows[j] = r.
    Pads carry row 0 and value 0. No cap on `num_rows`."""
    return RowSumsSorted.apply(vals_t, rows, num_rows)


# ------------------------------------------------------- windowed scatter-add

# The staged scatters' order of adds (csrc/scatter_staged.cuh): a run (a
# maximal stretch of one slot in one buffer) of at most SCATTER_RUN_H
# positions adds its terms in plan order; a longer run is cut on a fixed
# grid of SCATTER_CELL stream positions, each piece summed in plan order
# from 0, the pieces of SCATTER_GROUP consecutive cells added in cell order
# from 0, the groups in order from 0; the slot's sum adds, from 0 in
# stream order, each short run's terms and each long run's sum.
SCATTER_RUN_H = 256
SCATTER_CELL = 256
SCATTER_GROUP = 64


def _first_of_groups(*keys: torch.Tensor) -> torch.Tensor:
    """True where any of the (equally long) key tensors changes from the
    element before, and at element 0."""
    change = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    change[:1] = True
    for key in keys:
        change[1:] |= key[1:] != key[:-1]
    return change


def _staged_plain(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor, num_slots: int, k: int,
                  bf16: bool, cap: int) -> torch.Tensor:
    """The staged scatters' sum over buffers of `cap` positions, in their
    order of adds, with `index_add_` alone (in index order on the CPU)."""
    d = d_occ_t[:k]
    if bf16:
        d = d.to(torch.bfloat16).to(d_occ_t.dtype)
    s = sorted_slots.long()
    valid = (s >= 0) & (s < num_slots)
    out = torch.zeros((num_slots, k), dtype=d_occ_t.dtype, device=d_occ_t.device)
    start = _first_of_groups(s)
    start[::cap] = True  # every buffer starts a run
    run = torch.cumsum(start, 0) - 1
    long_ = valid & (torch.bincount(run)[run] > SCATTER_RUN_H)
    pos = torch.arange(s.shape[0], device=s.device)[long_]
    lrun, cell = run[long_], pos // SCATTER_CELL
    first1 = _first_of_groups(lrun, cell)  # pieces: (run, cell)
    pieces = torch.zeros((int(first1.sum()), k), dtype=d.dtype, device=d.device).index_add_(
        0, torch.cumsum(first1, 0) - 1, d[:, long_].T)
    prun, pgroup = lrun[first1], cell[first1] // SCATTER_GROUP
    first2 = _first_of_groups(prun, pgroup)  # groups: (run, cell // GROUP)
    groups = torch.zeros((int(first2.sum()), k), dtype=d.dtype, device=d.device).index_add_(
        0, torch.cumsum(first2, 0) - 1, pieces)
    grun = prun[first2]
    first3 = _first_of_groups(grun)  # runs
    runs = torch.zeros((int(first3.sum()), k), dtype=d.dtype, device=d.device).index_add_(
        0, torch.cumsum(first3, 0) - 1, groups)
    take = (valid & ~long_) | (long_ & start)  # short runs' terms, long runs' first positions
    vals = d[:, take].T.contiguous()
    vals[(long_ & start)[take]] = runs
    return out.index_add_(0, s[take], vals)


def scatter_sorted_plain(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor, num_slots: int,
                         k: int, bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the scatter: [num_slots, k] with
    out[s] = sum of d_occ_t[:k, j] over j with sorted_slots[j] = s; slots
    outside [0, num_slots) dropped; `bf16` rounds each term to bfloat16
    before the sum. On the CPU it adds in the kernel's order
    (csrc/scatter_staged.cuh): on a plan with no run longer than
    SCATTER_RUN_H it equals `zeros` + `index_add_` (plan order) bitwise;
    a longer run's sum is its pieces' on the fixed grid, added in order."""
    return _staged_plain(d_occ_t, sorted_slots, num_slots, k, bf16,
                         max(sorted_slots.shape[0], 1))


def _check_cotangent(d_occ_t, sorted_slots, k) -> None:
    _check(d_occ_t, "d_occ_t", torch.float32, 2)
    _check(sorted_slots, "sorted_slots", torch.int32, 1)
    if d_occ_t.shape[1] != sorted_slots.shape[0] or d_occ_t.shape[0] < k:
        raise ValueError(
            f"d_occ_t {tuple(d_occ_t.shape)} does not fit {sorted_slots.shape[0]} "
            f"plan positions and k={k}"
        )


def _check_scatter(d_occ_t, sorted_slots, win_off, num_slots, k) -> None:
    _check_cotangent(d_occ_t, sorted_slots, k)
    _check(win_off, "win_off", torch.int32, 1)
    if num_slots % WINDOW or win_off.shape[0] != num_slots // WINDOW + 1:
        raise ValueError(
            f"num_slots={num_slots} must be a multiple of {WINDOW} with "
            f"win_off of {num_slots // WINDOW + 1} entries, got {win_off.shape[0]}"
        )


SCATTER_MAX_K = 2048  # the staged scatters: csrc/scatter_staged.cuh MAX_K


def _check_staged(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor, k: int) -> None:
    """What the staged scatters (`csrc/scatter_staged.cuh`) need beyond
    the shapes: they copy 16 B aligned pieces, so d's rows and the slots
    start 16 B aligned (Np a multiple of 4, as every padded plan is, and
    under 2^31: tile offsets are int32), and a tile's sums fit in shared
    memory (k at most SCATTER_MAX_K)."""
    if not 1 <= k <= SCATTER_MAX_K:
        raise ValueError(f"k={k}: the staged scatter takes 1 <= k <= {SCATTER_MAX_K}")
    if (sorted_slots.shape[0] % 4 or sorted_slots.shape[0] >= 2**31
            or d_occ_t.data_ptr() % 16 or sorted_slots.data_ptr() % 16):
        raise ValueError(
            f"the staged scatter copies 16 B aligned spans: Np={sorted_slots.shape[0]} must "
            "be a multiple of 4 under 2^31 and d_occ_t and sorted_slots must start 16 B aligned"
        )


def _staged_scratch(d_occ_t: torch.Tensor, num_slots: int, k: int, nbuf: int, tile: int):
    """(toff, psum): the staged scatters' scratch (csrc/scatter_staged.cuh
    `scratch_ints`, `scratch_floats`): int32 tile offsets, a tile counter,
    two records a cell, the heavy tiles' flags and count and their list;
    float32 two [k] piece sums a cell."""
    cells, tiles = -(-d_occ_t.shape[1] // SCATTER_CELL), num_slots // tile
    toff = torch.empty(nbuf * (tiles + 1) + 1 + 3 * cells + tiles + 1, dtype=torch.int32,
                       device=d_occ_t.device)
    psum = torch.empty(2 * k * cells, dtype=torch.float32, device=d_occ_t.device)
    return toff, psum


def scatter_sorted_cuda(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor,
                        win_off: torch.Tensor, num_slots: int, k: int,
                        bf16: bool = False) -> torch.Tensor:
    """Launch `csrc/scatter_sorted.cu` on CUDA tensors.

    Replaces `_scatter_pallas` (xflow_tpu/ops/sorted_table.py). Bound by
    bytes on the H100: the dense [S, K] gradient written once, d[:K]
    and the slots read once (0.0720 ms at the FM headline's S = 2^22,
    K = 11, Np = 1,180,672). The staged walk of `csrc/scatter_staged.cuh`
    with one buffer: tile offsets and long runs marked from the slots,
    each long run's pieces (256-position cells) summed by a warp a cell;
    then persistent blocks that stage each 256-slot tile's span in shared
    memory by 16 B asynchronous copies (the next chunk in flight), sum
    each short (slot, channel) run there in plan order, join each long
    run's pieces in order, and write the [256, K] tile once with 16 B
    stores: no atomics, the same bits on every run, in the order
    `scatter_sorted_plain` adds. On an NVIDIA H100 80GB HBM3, 700.00 W
    (`chip_smoke.py`): 0.1299 ms at that shape, against 0.2047 for
    `zeros` + `index_add_`; 0.1520 with a run of 65,536 at one slot
    (against 0.3590; 1.1002 before long runs were split)."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(d_occ_t, sorted_slots, win_off)
    _check_scatter(d_occ_t, sorted_slots, win_off, num_slots, k)
    _check_staged(d_occ_t, sorted_slots, k)
    out = torch.empty((num_slots, k), dtype=torch.float32, device=d_occ_t.device)
    lib = kernels.load("scatter_sorted")
    toff, psum = _staged_scratch(d_occ_t, num_slots, k, 1, lib.xf_scatter_sorted_tile(k))
    with torch.cuda.device(d_occ_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_scatter_sorted(
            d_occ_t.data_ptr(), sorted_slots.data_ptr(), toff.data_ptr(), toff.numel(),
            psum.data_ptr(), psum.numel(), out.data_ptr(), num_slots, k, d_occ_t.shape[1],
            int(bool(bf16)), stream,
        )
    kernels.check(err, "scatter_sorted")
    LAUNCHES["scatter_sorted"] += 1
    return out


def scatter_sorted(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor, win_off: torch.Tensor,
                   num_slots: int, k: int, bf16: bool = False) -> torch.Tensor:
    """The gather's VJP: dense [num_slots, k] table gradient from the
    occurrence cotangent `d_occ_t [K8, Np]` (rows k..K8 ignored)."""
    if _on_cpu(d_occ_t, sorted_slots):
        return scatter_sorted_plain(d_occ_t, sorted_slots, num_slots, k, bf16)
    return scatter_sorted_cuda(d_occ_t, sorted_slots, win_off, num_slots, k, bf16)


# ------------------------------------------------- fused scatter-add + FTRL

SCATTER_FTRL_MAX_K = 512  # csrc/scatter_ftrl.cu MAX_K


def count_nonfinite(leaves, counter: torch.Tensor) -> None:
    """Add the number of non-finite entries of `leaves` into the int32 [1]
    `counter`, on its device and without a host read."""
    total = sum((~torch.isfinite(t)).sum() for t in leaves)
    counter.add_(total.to(counter.dtype))


def _check_counter(nonfinite: torch.Tensor, device: torch.device) -> None:
    _check(nonfinite, "nonfinite", torch.int32, 1)
    if nonfinite.shape[0] != 1 or nonfinite.device != device:
        raise ValueError(
            f"nonfinite: expected an int32 [1] counter on {device}, got "
            f"{tuple(nonfinite.shape)} on {nonfinite.device}"
        )


def scatter_ftrl_plain(d_occ_t, sorted_slots, w, n, z, k: int, hp, bf16: bool = False,
                       nonfinite: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused step: the scatter, then
    `optim/ftrl.update_one` on every slot -> (w', n', z'); with
    `nonfinite` (int32 [1]), the count of non-finite w', n', z' entries
    is added into it."""
    g = scatter_sorted_plain(d_occ_t, sorted_slots, w.shape[0], k, bf16)
    outs = update_one(w, n, z, g, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)
    if nonfinite is not None:
        _check_counter(nonfinite, w.device)
        count_nonfinite(outs, nonfinite)
    return outs


def scatter_ftrl_cuda(d_occ_t, sorted_slots, win_off, w, n, z, k: int, hp, bf16: bool = False,
                      nonfinite: Optional[torch.Tensor] = None):
    """Launch `csrc/scatter_ftrl.cu` on CUDA tensors: one kernel, the
    [S, K] gradient summed in shared memory and never written.

    Replaces `_scatter_ftrl_pallas` (xflow_tpu/ops/sorted_table.py).
    Bound by bytes on the H100: w, n, z read and w', n', z' written
    once, d[:K] and the slots read once. One block a SM takes tiles
    from a counter; its producer warp finds four tiles' spans at once
    and streams each tile's w, n, z and its span of the slots and d[:K]
    by TMA bulk copies into two-stage rings, while sixteen consumer
    warps sum each run in 32-position pieces by segmented shuffle scans
    (a fixed tree: the same bits on every launch), run FTRL and store
    with 16 B stores. On an NVIDIA H100 80GB HBM3, 700.00 W
    (`chip_smoke.py`): 0.4279 ms at the FM headline's shape (81% of its
    bytes bound), 3.2252 at FFM's K = 73 (74%), 0.4328 with a run of
    65,536 at one slot; the earlier design took 0.5788 and 3.564.
    With `nonfinite` (int32 [1] on the same card), the kernel adds the
    count of non-finite w', n', z' entries into it, one atomic a block.
    Writes fresh output tensors: the step's non-finite guard may keep
    the pre-step state."""
    from xflow_tpu_torch.ops import kernels

    extra = () if nonfinite is None else (nonfinite,)
    _require_cuda(d_occ_t, sorted_slots, win_off, w, n, z, *extra)
    num_slots = w.shape[0]
    _check_scatter(d_occ_t, sorted_slots, win_off, num_slots, k)
    if nonfinite is not None:
        _check_counter(nonfinite, w.device)
    if not 1 <= k <= SCATTER_FTRL_MAX_K:
        raise ValueError(f"k={k}: the fused scatter + FTRL takes 1 <= k <= {SCATTER_FTRL_MAX_K}")
    np_ = sorted_slots.shape[0]
    if np_ % 4 or np_ >= 2**31 or d_occ_t.data_ptr() % 16 or sorted_slots.data_ptr() % 16:
        raise ValueError(
            f"the fused scatter + FTRL copies 16 B aligned spans: Np={np_} must be a multiple "
            "of 4 under 2^31 and d_occ_t and sorted_slots must start 16 B aligned"
        )
    if num_slots >= 2**31:
        raise ValueError(f"num_slots={num_slots}: the fused scatter + FTRL takes S under 2^31")
    for name, t in (("w", w), ("n", n), ("z", z)):
        _check(t, name, torch.float32, 2)
        if tuple(t.shape) != (num_slots, k):
            raise ValueError(f"{name}: expected shape {(num_slots, k)}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the state streams in 16 B units; it must start 16 B aligned")
    outs = [torch.empty_like(w) for _ in range(3)]
    counter = torch.empty(1, dtype=torch.int32, device=w.device)  # the tile counter
    lib = kernels.load("scatter_ftrl")
    with torch.cuda.device(d_occ_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_scatter_ftrl(
            d_occ_t.data_ptr(), sorted_slots.data_ptr(), win_off.data_ptr(),
            w.data_ptr(), n.data_ptr(), z.data_ptr(), *(o.data_ptr() for o in outs),
            counter.data_ptr(), None if nonfinite is None else nonfinite.data_ptr(),
            num_slots, k, np_, int(bool(bf16)),
            hp.alpha, hp.beta, hp.lambda1, hp.lambda2, stream,
        )
    kernels.check(err, "scatter_ftrl")
    LAUNCHES["scatter_ftrl"] += 1
    return tuple(outs)


def scatter_ftrl_sorted(d_occ_t, sorted_slots, win_off, w, n, z, k: int, hp,
                        bf16: bool = False, nonfinite: Optional[torch.Tensor] = None):
    """Windowed scatter-add of the occurrence cotangent + FTRL update in
    one table pass: returns (w', n', z'). `hp` carries (alpha, beta,
    lambda1, lambda2), cfg.optim.ftrl. The same function as
    `table_gather_sorted`'s VJP followed by `update_one`. With
    `nonfinite` (int32 [1]), the count of non-finite entries of the three
    outputs is added into it, so a guard reads one integer instead of
    sweeping the leaves."""
    if _on_cpu(d_occ_t, sorted_slots, w, n, z):
        return scatter_ftrl_plain(d_occ_t, sorted_slots, w, n, z, k, hp, bf16, nonfinite)
    return scatter_ftrl_cuda(d_occ_t, sorted_slots, win_off, w, n, z, k, hp, bf16, nonfinite)


# ------------------------------------------- multi-buffer gather and scatter

MULTI_MAX_BUFFERS = 112  # stacked sub-batches the multi-buffer kernels take


def _check_multi(sorted_slots: torch.Tensor, loc_off: torch.Tensor, num_slots: int) -> tuple:
    """(nbuf, cap) of a multi-buffer stream, after the shape checks
    `_gather_pallas_multi` asserts: `loc_off` [nbuf, S/WINDOW + 1]
    buffer-local window offsets, nbuf buffers of cap positions each (cap
    a multiple of CHUNK). Its values are not read here (that would stall
    the host on the device every call): the planner writes 0 and cap in
    the first and last columns, and the kernels cover each buffer's
    whole [0, cap) whatever those two columns hold."""
    _check(sorted_slots, "sorted_slots", torch.int32, 1)
    _check(loc_off, "loc_off", torch.int32, 2)
    nbuf, wpo1 = loc_off.shape
    np_ = sorted_slots.shape[0]
    if num_slots % WINDOW or wpo1 != num_slots // WINDOW + 1:
        raise ValueError(
            f"num_slots={num_slots} must be a multiple of {WINDOW} with loc_off of "
            f"{num_slots // WINDOW + 1} columns, got {tuple(loc_off.shape)}"
        )
    if not 1 <= nbuf <= MULTI_MAX_BUFFERS or np_ % nbuf or (np_ // nbuf) % CHUNK:
        raise ValueError(
            f"{np_} plan positions do not split into {nbuf} buffers of a multiple of "
            f"{CHUNK} (at most {MULTI_MAX_BUFFERS} buffers)"
        )
    return nbuf, np_ // nbuf


def gather_sorted_multi_plain(table: torch.Tensor, sorted_slots: torch.Tensor,
                              loc_off: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the multi-buffer gather: the gather of the
    flattened stream, [K8, nbuf * cap]."""
    _check_multi(sorted_slots, loc_off, table.shape[0])
    return gather_sorted_plain(table, sorted_slots, bf16)


def gather_sorted_multi_cuda(table: torch.Tensor, sorted_slots: torch.Tensor,
                             loc_off: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Launch `csrc/gather_sorted_multi.cu` on CUDA tensors.

    Replaces `_gather_pallas_multi` (xflow_tpu/ops/sorted_table.py).
    Bound by bytes on the H100: each distinct row's sectors read once
    across the buffers, a 4 B slot read and K8 floats written per
    position. The flat walk (`csrc/gather_flat.cuh`, #1's body too): a
    thread a position of the flattened stream, its row loaded as 8 B
    pairs where K is even, stored down its output column with
    evict-first stores; L2 keeps a row that several sub-batches share
    between their reads. `loc_off` is checked for its shape, not read."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(table, sorted_slots, loc_off)
    _check(table, "table", torch.float32, 2)
    S, K = table.shape
    _check_multi(sorted_slots, loc_off, S)
    np_ = sorted_slots.shape[0]
    out = torch.empty((_k8(K), np_), dtype=torch.float32, device=table.device)
    lib = kernels.load("gather_sorted_multi")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_gather_sorted_multi(
            table.data_ptr(), sorted_slots.data_ptr(), out.data_ptr(),
            S, K, _k8(K), np_, int(bool(bf16)), stream,
        )
    kernels.check(err, "gather_sorted_multi")
    LAUNCHES["gather_sorted_multi"] += 1
    return out


def scatter_sorted_multi_plain(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor,
                               loc_off: torch.Tensor, num_slots: int, k: int,
                               bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the multi-buffer scatter: the scatter of
    the flattened stream, [num_slots, k], in the kernel's order of adds
    (csrc/scatter_staged.cuh; a run is a slot's stretch in one buffer):
    on a plan with no run longer than SCATTER_RUN_H it equals `zeros` +
    `index_add_` bitwise (on the CPU: buffer 0's run of a slot, then
    buffer 1's, each in plan order)."""
    nbuf, cap = _check_multi(sorted_slots, loc_off, num_slots)
    return _staged_plain(d_occ_t, sorted_slots, num_slots, k, bf16, max(cap, 1))


def scatter_sorted_multi_cuda(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor,
                              loc_off: torch.Tensor, num_slots: int, k: int,
                              bf16: bool = False) -> torch.Tensor:
    """Launch `csrc/scatter_sorted_multi.cu` on CUDA tensors.

    Replaces `_scatter_pallas_multi` (xflow_tpu/ops/sorted_table.py).
    Bound by bytes on the H100: the dense [S, K] gradient written once,
    d[:K] and the slots read once (0.0656 ms at the MVM segment side's
    S = 2^22, K = 10, 4 x 295,936 positions). The staged walk of
    `csrc/scatter_staged.cuh`: tile offsets and long runs marked in each
    buffer, long runs' pieces summed a warp a cell; then persistent
    blocks that keep a 256-slot tile's sums in shared memory, stage its
    spans of all the buffers there by 16 B asynchronous copies, add each
    (slot, channel)'s short runs buffer after buffer in plan order and
    each long run's joined pieces at its place; the tile is written once
    with 16 B stores. No atomics, the same bits on every run, in the
    order `scatter_sorted_multi_plain` adds. On an NVIDIA H100 80GB HBM3,
    700.00 W (`chip_smoke.py`): 0.1582 ms at that shape, against 0.2059
    for `zeros` + `index_add_`; 0.1658 with a run of 65,536 at one slot
    (against 0.4491; 1.1272 before long runs were split) and 0.2166 on
    the fully-sharded buffer's 1,180,160 pads at one slot (against
    2.3688; 17.6 before)."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(d_occ_t, sorted_slots, loc_off)
    _check_cotangent(d_occ_t, sorted_slots, k)
    nbuf, cap = _check_multi(sorted_slots, loc_off, num_slots)
    _check_staged(d_occ_t, sorted_slots, k)
    out = torch.empty((num_slots, k), dtype=torch.float32, device=d_occ_t.device)
    lib = kernels.load("scatter_sorted_multi")
    toff, psum = _staged_scratch(d_occ_t, num_slots, k, nbuf,
                                 lib.xf_scatter_sorted_multi_tile(k))
    with torch.cuda.device(d_occ_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xf_scatter_sorted_multi(
            d_occ_t.data_ptr(), sorted_slots.data_ptr(), toff.data_ptr(), toff.numel(),
            psum.data_ptr(), psum.numel(), out.data_ptr(), num_slots, k, d_occ_t.shape[1],
            nbuf, cap, int(bool(bf16)), stream,
        )
    kernels.check(err, "scatter_sorted_multi")
    LAUNCHES["scatter_sorted_multi"] += 1
    return out


def scatter_sorted_multi(d_occ_t: torch.Tensor, sorted_slots: torch.Tensor,
                         loc_off: torch.Tensor, num_slots: int, k: int,
                         bf16: bool = False) -> torch.Tensor:
    """The multi-buffer gather's VJP: dense [num_slots, k] gradient."""
    if _on_cpu(d_occ_t, sorted_slots, loc_off):
        return scatter_sorted_multi_plain(d_occ_t, sorted_slots, loc_off, num_slots, k, bf16)
    return scatter_sorted_multi_cuda(d_occ_t, sorted_slots, loc_off, num_slots, k, bf16)


class TableGatherSortedMulti(torch.autograd.Function):
    """Differentiable in `table`; the backward is `scatter_sorted_multi`
    (`_scatter_pallas_multi` in the JAX package)."""

    @staticmethod
    def forward(ctx, table, sorted_slots, loc_off, bf16):
        ctx.save_for_backward(sorted_slots, loc_off)
        ctx.shape, ctx.bf16 = tuple(table.shape), bf16
        if _on_cpu(table, sorted_slots, loc_off):
            return gather_sorted_multi_plain(table, sorted_slots, loc_off, bf16)
        return gather_sorted_multi_cuda(table, sorted_slots, loc_off, bf16)

    @staticmethod
    def backward(ctx, d_occ_t):
        sorted_slots, loc_off = ctx.saved_tensors
        num_slots, k = ctx.shape
        d_table = scatter_sorted_multi(
            d_occ_t.contiguous(), sorted_slots, loc_off, num_slots, k, ctx.bf16
        )
        return d_table, None, None, None


def table_gather_sorted_multi(table: torch.Tensor, sorted_slots: torch.Tensor,
                              loc_off: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """`table_gather_sorted` over `nbuf` concatenated buffers, each
    slot-sorted over the same table: `sorted_slots [nbuf * cap]`,
    `loc_off [nbuf, S/WINDOW + 1]` buffer-local window offsets (the
    stacked plan's `win_off`, last column equal to cap). Output
    [K8, nbuf * cap]."""
    return TableGatherSortedMulti.apply(table, sorted_slots, loc_off, bf16)


def sorted_gather_map(table: torch.Tensor, batch: dict, row_keys: tuple, batch_rows: int,
                      row_fn, K: int, bf16: bool) -> torch.Tensor:
    """Gather the table once, then run the row side per sub-batch.

    `row_fn(occ_t [K8, Np], *row_arrays, rows)` computes one sub-batch's
    logits from its gathered rows. A flat plan takes `table_gather_sorted`;
    a stacked [NS, Np_sub] plan takes ONE `table_gather_sorted_multi` over
    the flattened stream (the table crosses memory once a step, not once
    a sub-batch), then `row_fn` over each sub-batch in order; the logits
    are concatenated to [batch_rows]."""
    if table.shape[1] != K:
        raise ValueError(f"table {tuple(table.shape)} is not of logical width {K}")
    ss, wo = batch["sorted_slots"], batch["win_off"]
    arrs = tuple(batch[k] for k in row_keys)
    if ss.ndim == 1:
        return row_fn(table_gather_sorted(table, ss, wo, bf16), *arrs, batch_rows)
    ns, np_sub = ss.shape
    occ_all = table_gather_sorted_multi(table, ss.reshape(-1), wo, bf16)
    return torch.cat([
        row_fn(occ_all[:, i * np_sub : (i + 1) * np_sub], *(a[i] for a in arrs),
               batch_rows // ns)
        for i in range(ns)
    ])


# ----------------------------------------------------------- segment sums

class SegmentSumChannels(torch.autograd.Function):
    """out[s, c] = sum of vals_t[c, j] over j with seg[j] = s: `index_add_`
    forward, the row gather ``d_out[seg].T`` backward (both outside any
    kernel, as in the JAX package)."""

    @staticmethod
    def forward(ctx, vals_t, seg, num_segments):
        ctx.save_for_backward(seg)
        out = torch.zeros((num_segments, vals_t.shape[0]), dtype=vals_t.dtype,
                          device=vals_t.device)
        return out.index_add_(0, seg.long(), vals_t.T)

    @staticmethod
    def backward(ctx, d_out):
        (seg,) = ctx.saved_tensors
        return d_out[seg.long()].T, None, None


def segment_sum_channels(vals_t: torch.Tensor, seg: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Occurrences into segments: [num_segments, ch] from vals_t [ch, Np]."""
    return SegmentSumChannels.apply(vals_t, seg, num_segments)
