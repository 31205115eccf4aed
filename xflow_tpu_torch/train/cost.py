"""The train step's work count on one device, `step_cost(cfg, batch) ->
{"flops", "bytes"}`: the numerators of the window records' roofline
gauges (`telemetry.StepTimer.window_record`), the port's counterpart of
the cost analysis XLA gives the JAX trainer for its compiled step
(`CompileRecorder`). The torch step has no compiled program to ask, so
the count is taken from the batch's shapes and the planner's distinct
count, on the host, with no device read.

It counts the work, not the implementation: the least traffic any
implementation of the same step must move, so a faster kernel leaves it
as it is. Hence the fused step (scatter and FTRL in one pass) and the
two-pass step count the same on the same plan. For a batch of B rows
whose plan holds p positions (the padded plan's length, or B·F
row-major occurrences) over U distinct table slots of K floats in all
(every table's width summed), L optimizer leaves a table (FTRL's n and
z: 2; SGD: 0) and the gathered rows' item size g (2 under
`data.sorted_bf16` on a sorted plan, else 4):

    bytes = each plan array the step reads, once
          + 2·(1 + L)·U·K·4       each distinct row read once and written
                                  once, with its optimizer leaves
          + 2·2·p·K·g             the gathered occurrence rows and their
                                  cotangent, each written once, read once
          + 2·2·B·R·4             the row side's per-row products and their
                                  cotangent
          + 2·2·B·4               the logits and their cotangent

    flops = 2·(2·p·ch + B·(row + 8)) + p·K + U·K·opt

with, by row side, ch the channels each occurrence contributes (one
masked multiply-add each), R the per-row products' width and row the
per-row arithmetic that turns them into a logit: LR ch 1, R 0, row 0;
FM ch 2K-1 (w, the latents, their squares), R 2K-1, row 3(K-1)+2;
MVM's product side ch 3K (log, sign and zero channels), R 3K, row 4K;
MVM's segment side ch K+1, R nf·(K+1), row nf·K+K; FFM ch 1 (the w
column; the latent blocks are placed, not computed), R nf·K (the placed
rows), row 5·nf·(K-1)+nf. The loss is 8 operations a row; the backward
repeats the forward's arithmetic and adds each occurrence's cotangent
into its row (p·K); the optimizer costs opt a table element (FTRL's
`update_one`, 16 with a square root or a division as one; SGD 2).

The distinct count U is a host int that the planner counted while it
placed the sorted occurrences (`SortedPlan.distinct`, the native
planner's and the plain one's), or the row-major dedup's unique count
(`evaluate.HostArrays.distinct`). Where no planner counted it (a
row-major batch without dedup) the count takes the occurrences for U:
the bytes are then an upper estimate of the traffic, and the gauge is
no share of the card's peak. A stacked plan's U is its sub-plans' sum,
exact for one sub-plan and an upper estimate for more. The part that
does not depend on the data is cached by the batch's shape signature.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

FTRL_OPS_PER_ELEMENT = 16  # update_one's float ops, sqrt and division as one each
SGD_OPS_PER_ELEMENT = 2
LOSS_OPS_PER_ROW = 8  # the BCE from a logit, its mask and the mean's add
_OPT = {"ftrl": (2, FTRL_OPS_PER_ELEMENT), "sgd": (0, SGD_OPS_PER_ELEMENT)}
# the array whose size is the plan's positions, first present wins
_POSITION_KEYS = ("sorted_slots", "inverse", "slots")


def row_side(cfg, batch: dict) -> str:
    """The step's row side for this batch: "lr", "fm", "mvm_product",
    "mvm_segment" or "ffm" (MVM's row-major batches reduce per (row,
    field), as the segment side does)."""
    name = cfg.model.name
    if name == "mvm":
        product = "sorted_slots" in batch and "sorted_fields" not in batch
        return "mvm_product" if product else "mvm_segment"
    if name not in ("lr", "fm", "ffm"):
        raise ValueError(f"step_cost: no work count for model.name={name!r}")
    return name


def _row_terms(side: str, K: int, nf: int) -> tuple:
    """(ch, R, row) of a row side (the module docstring's table)."""
    if side == "lr":
        return 1, 0, 0
    if side == "fm":
        return 2 * K - 1, 2 * K - 1, 3 * (K - 1) + 2
    if side == "mvm_product":
        return 3 * K, 3 * K, 4 * K
    if side == "mvm_segment":
        return K + 1, nf * (K + 1), nf * K + K
    return 1, nf * K, 5 * nf * (K - 1) + nf  # ffm


def _form(cfg, batch: dict) -> tuple:
    """What the count needs of the config: (row side, K, nf, L, opt ops,
    g), cheap enough to take every step."""
    from xflow_tpu_torch.models import get_model

    side = row_side(cfg, batch)
    K = sum(t[0] if t else 1 for t in get_model(cfg.model.name).table_specs(cfg).values())
    if cfg.optim.name not in _OPT:
        raise ValueError(f"step_cost: no work count for optim.name={cfg.optim.name!r}")
    leaves, opt_ops = _OPT[cfg.optim.name]
    g = 2 if "sorted_slots" in batch and cfg.data.sorted_bf16 else 4
    return side, K, cfg.model.num_fields, leaves, opt_ops, g


def _signature(side: str, batch: dict) -> tuple:
    """(key, shape, item size) of each array the step reads: all of the
    batch's, less the row-major `fields` that LR and FM never read."""
    skip = ("fields",) if side in ("lr", "fm") else ()
    return tuple(sorted((k, np.shape(v), np.asarray(v).itemsize)
                        for k, v in batch.items()
                        if isinstance(v, np.ndarray) and k not in skip))


@functools.lru_cache(maxsize=256)
def _linear(form: tuple, sig: tuple) -> tuple:
    """(bytes, bytes a distinct row, flops, flops a distinct row) of a
    form and signature: the count is bytes + U·(bytes a row), and so
    for the flops."""
    side, K, nf, leaves, opt_ops, g = form
    shapes = {k: shape for k, shape, _ in sig}
    plan = sum(int(np.prod(shape)) * item for _, shape, item in sig)
    B = int(np.prod(shapes["labels"]))
    p = int(np.prod(shapes[next(k for k in _POSITION_KEYS if k in shapes)]))
    ch, R, row = _row_terms(side, K, nf)
    nbytes = plan + 2 * 2 * p * K * g + 2 * 2 * B * R * 4 + 2 * 2 * B * 4
    flops = 2 * (2 * p * ch + B * (row + LOSS_OPS_PER_ROW)) + p * K
    return nbytes, 2 * (1 + leaves) * K * 4, flops, K * opt_ops


def positions(batch: dict) -> int:
    """The plan's positions: the sorted plan's length, else the row-major
    occurrences."""
    for k in _POSITION_KEYS:
        if k in batch:
            return int(np.size(batch[k]))
    raise ValueError("step_cost: the batch has no plan (sorted_slots, inverse or slots)")


def distinct_rows(batch: dict) -> tuple[int, bool]:
    """(U, exact): the batch's distinct table slots as its planner counted
    them, or its occurrence count with exact False where none did."""
    u: Optional[int] = getattr(batch, "distinct", None)
    if u is not None:
        return int(u), True
    return positions(batch), False


def step_cost(cfg, batch: dict) -> dict:
    """{"flops", "bytes"} of one train step on `batch`, the host arrays
    `evaluate.batch_arrays` gives (see the module docstring)."""
    form = _form(cfg, batch)
    nbytes, row_bytes, flops, row_flops = _linear(form, _signature(form[0], batch))
    u, _ = distinct_rows(batch)
    return {"flops": flops + u * row_flops, "bytes": nbytes + u * row_bytes}
