"""Offline evaluation on one device: the exact single-device path of the
JAX trainer's `evaluate` (`xflow_tpu/train/trainer.py`).

Each batch of the libffm file is planned on the host (slot-sorted plan,
stacked into sub-batches where configured, compact wire format) when the
sorted layout is on, shipped to the device, and run through the shared
`predict_fn`; the pCTRs of real rows
feed the rank-sum AUC and the mean log-likelihood.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data.libffm import iter_batches
from xflow_tpu_torch.data.schema import SparseBatch
from xflow_tpu_torch.metrics import auc_logloss
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models.predict import make_predict_fn
from xflow_tpu_torch.models.mvm import has_field_duplicates, resolve_mvm_product
from xflow_tpu_torch.ops.sorted_table import (
    WINDOW,
    compact_plan_wire,
    dedup_slots,
    plan_sorted_stacked,
    resolve_sub_batches,
)


def sorted_layout_on(cfg: Config) -> bool:
    """Whether batches ship as sorted plans: the JAX trainer's
    single-device rule (fused FM or MVM, S a multiple of WINDOW) under
    data.sorted_layout "auto", forced by "on", never under "off"."""
    mode = cfg.data.sorted_layout
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"data.sorted_layout={mode!r}: expected auto|on|off")
    if cfg.model.name == "ffm":
        raise ValueError("model.name=ffm is not ported to xflow_tpu_torch yet")
    supported = (cfg.model.name == "fm" and cfg.model.fm_fused) or cfg.model.name == "mvm"
    if mode == "on" and not (supported and cfg.num_slots % WINDOW == 0):
        raise ValueError(
            "sorted_layout=on needs model.name=fm with model.fm_fused=true or "
            f"model.name=mvm, and num_slots divisible by {WINDOW}"
        )
    return mode == "on" or (mode == "auto" and supported and cfg.num_slots % WINDOW == 0)


def mvm_wants_fields(batch: SparseBatch, cfg: Config) -> bool:
    """Whether an MVM batch takes the segment row side (its plan carries
    per-occurrence fields): the JAX trainer's single-process routing,
    per batch under mvm_exclusive=auto."""
    excl = cfg.model.mvm_exclusive
    dup = excl != "off" and has_field_duplicates(batch.fields, batch.mask)
    return not resolve_mvm_product(excl, dup, 1)


class HostDedup:
    """`data.dedup` for the row-major batches of one process (the JAX
    trainer's `_maybe_dedup`): attach (unique_slots, inverse) in place of
    `slots` when the batch's unique slots fit the capacity. The first
    batch decides for the run: if it overflows, later batches skip the
    host sort. Raises on a mode other than auto|off."""

    def __init__(self, cfg: Config):
        d = cfg.data
        if d.dedup not in ("auto", "off"):
            raise ValueError(f"data.dedup={d.dedup!r}: expected auto|off")
        self.cap = int(d.batch_size * d.max_nnz * d.dedup_cap_frac) if d.dedup == "auto" else 0
        self.on: Optional[bool] = None

    def __call__(self, arrays: dict) -> dict:
        if not self.cap or self.on is False:
            return arrays
        got = dedup_slots(arrays["slots"], self.cap)
        if got is None:
            if self.on is None:
                self.on = False
            return arrays
        self.on = True
        arrays = {k: v for k, v in arrays.items() if k != "slots"}
        arrays["unique_slots"], arrays["inverse"] = got
        return arrays


def batch_arrays(batch: SparseBatch, cfg: Config, dedup: Optional[HostDedup] = None) -> dict:
    """Host arrays the step or the forward consumes: the sorted plan
    (stacked into `resolve_sub_batches` sub-batches, with fields when an
    MVM batch takes the segment row side, compacted wire dtypes) plus
    labels/row_mask, or the row-major arrays (through `dedup` when
    given). MVM field ids must lie below model.num_fields."""
    mvm = cfg.model.name == "mvm"
    if mvm and batch.fields.size and int(batch.fields.max()) >= cfg.model.num_fields:
        raise ValueError(
            f"libffm field id {int(batch.fields.max())} >= model.num_fields="
            f"{cfg.model.num_fields}; raise model.num_fields"
        )
    arrays = {"labels": batch.labels, "row_mask": batch.row_mask}
    if not sorted_layout_on(cfg):
        arrays.update(slots=batch.slots, fields=batch.fields, mask=batch.mask)
        return arrays if dedup is None else dedup(arrays)
    want_fields = mvm and mvm_wants_fields(batch, cfg)
    ns = resolve_sub_batches(cfg)
    plan = plan_sorted_stacked(
        batch.slots, batch.mask, cfg.num_slots,
        fields=batch.fields if want_fields else None, num_sub=ns,
    )
    arrays.update(
        sorted_slots=plan.sorted_slots,
        sorted_row=plan.sorted_row,
        sorted_mask=plan.sorted_mask,
        win_off=plan.win_off,
    )
    if want_fields:
        arrays["sorted_fields"] = plan.sorted_fields
    return compact_plan_wire(
        arrays, rows_bound=cfg.data.batch_size // ns,
        fields_bound=cfg.model.num_fields if want_fields else 0,
    )


def to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def predict_batches(cfg: Config, tables: dict, path: str,
                    device="cuda") -> Iterator[tuple[SparseBatch, np.ndarray]]:
    """(batch, pctr [B] on the host) for every batch of libffm file `path`,
    predicted on `device` with `tables` (already on that device)."""
    step = make_predict_fn(get_model(cfg.model.name)(cfg))
    dedup = HostDedup(cfg)
    for batch in iter_batches(path, cfg.data):
        p = step(tables, to_device(batch_arrays(batch, cfg, dedup), device))
        yield batch, p.cpu().numpy()


def evaluate(cfg: Config, tables: dict, path: str, device="cuda") -> tuple[float, float]:
    """(auc, logloss) of `tables` on libffm file `path`; logloss keeps the
    reference's sign (a mean log-likelihood)."""
    pctrs, labels = [], []
    for batch, p in predict_batches(cfg, tables, path, device):
        rm = batch.row_mask > 0
        pctrs.append(p[rm])
        labels.append(batch.labels[rm])
    if not pctrs:
        return float("nan"), float("nan")
    return auc_logloss(np.concatenate(pctrs), np.concatenate(labels))
