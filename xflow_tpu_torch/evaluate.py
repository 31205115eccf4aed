"""Offline evaluation on one device: the exact single-device path of the
JAX trainer's `evaluate` (`xflow_tpu/train/trainer.py`).

Each batch of the libffm file (read by `data/pipeline.batch_iterator`:
its `.xfc` cache, or the native parser) is planned on the host
(slot-sorted plan by the native planner, stacked into sub-batches where
configured, in the compact wire format) when the sorted layout is on, in
a prefetch thread, then shipped to the device on the caller's thread and
run through the shared `predict_fn`; the pCTRs of real rows feed the
rank-sum AUC and the mean log-likelihood.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data.pipeline import batch_iterator, prefetch
from xflow_tpu_torch.data.schema import SparseBatch
from xflow_tpu_torch.metrics import auc_logloss
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models.ffm import count_route, ffm_invperm, resolve_ffm_aligned
from xflow_tpu_torch.models.mvm import has_field_duplicates, resolve_mvm_product
from xflow_tpu_torch.models.predict import make_predict_fn
from xflow_tpu_torch.ops.sorted_table import (
    WINDOW,
    compact_plan_wire,
    dedup_slots,
    plan_sorted_stacked,
    resolve_sub_batches,
)


def sorted_layout_on(cfg: Config) -> bool:
    """Whether batches ship as sorted plans: the JAX trainer's
    single-device rule (fused FM, MVM or FFM, S a multiple of WINDOW)
    under data.sorted_layout "auto", forced by "on", never under "off"."""
    mode = cfg.data.sorted_layout
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"data.sorted_layout={mode!r}: expected auto|on|off")
    supported = (cfg.model.name == "fm" and cfg.model.fm_fused) or cfg.model.name in (
        "mvm", "ffm")
    if mode == "on" and not (supported and cfg.num_slots % WINDOW == 0):
        raise ValueError(
            "sorted_layout=on needs model.name=fm with model.fm_fused=true, "
            f"model.name=mvm or model.name=ffm, and num_slots divisible by {WINDOW}"
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


def ffm_takes_aligned(batch: SparseBatch, cfg: Config) -> bool:
    """Route an FFM batch under the sorted layout (the JAX trainer's
    single-process rule): the aligned hybrid unless a row repeats a
    field; such a batch goes row-major, or raises under
    sorted_layout=on."""
    if resolve_ffm_aligned(batch.fields, batch.mask):
        return True
    if cfg.data.sorted_layout == "on":
        raise ValueError(
            "FFM aligned hybrid: a row carries two masked occurrences of the same "
            "field. sorted_layout=on requires aligned batches; use auto for the "
            "per-batch row-major fallback"
        )
    return False


def batch_arrays(batch: SparseBatch, cfg: Config, dedup: Optional[HostDedup] = None) -> dict:
    """Host arrays the step or the forward consumes: the sorted plan
    (stacked into `resolve_sub_batches` sub-batches, with fields when an
    MVM batch takes the segment row side, compacted wire dtypes) plus
    labels/row_mask, or the row-major arrays (through `dedup` when
    given). An FFM plan is always flat, with fields and its placement
    `ffm_invperm`; an FFM batch that repeats a field in a row goes
    row-major (`ffm_takes_aligned`; both routes counted in
    `models/ffm.ROUTES`). MVM and FFM field ids must lie below
    model.num_fields."""
    mvm, ffm = cfg.model.name == "mvm", cfg.model.name == "ffm"
    if (mvm or ffm) and batch.fields.size and int(batch.fields.max()) >= cfg.model.num_fields:
        raise ValueError(
            f"libffm field id {int(batch.fields.max())} >= model.num_fields="
            f"{cfg.model.num_fields}; raise model.num_fields"
        )
    arrays = {"labels": batch.labels, "row_mask": batch.row_mask}
    row_major = not sorted_layout_on(cfg)
    if not row_major and ffm:
        row_major = not ffm_takes_aligned(batch, cfg)
        count_route("row_major" if row_major else "aligned")
    if row_major:
        arrays.update(slots=batch.slots, fields=batch.fields, mask=batch.mask)
        return arrays if dedup is None else dedup(arrays)
    want_fields = ffm or (mvm and mvm_wants_fields(batch, cfg))
    # FFM's placement is defined over the whole batch: one flat plan
    ns = 1 if ffm else resolve_sub_batches(cfg)
    rows_bound = cfg.data.batch_size // ns
    plan = plan_sorted_stacked(
        batch.slots, batch.mask, cfg.num_slots,
        fields=batch.fields if want_fields else None, num_sub=ns,
        # the config's bounds, the rule compact_plan_wire applies: the
        # native planner then emits the wire dtypes itself
        wire=rows_bound <= (1 << 16)
        and (not want_fields or cfg.model.num_fields <= (1 << 8)),
    )
    arrays.update(
        sorted_slots=plan.sorted_slots,
        sorted_row=plan.sorted_row,
        sorted_mask=plan.sorted_mask,
        win_off=plan.win_off,
    )
    if want_fields:
        arrays["sorted_fields"] = plan.sorted_fields
    if ffm:
        arrays["ffm_invperm"] = ffm_invperm(plan.sorted_row, plan.sorted_fields,
                                            plan.sorted_mask, len(batch.labels),
                                            cfg.model.num_fields)
    return compact_plan_wire(
        arrays, rows_bound=rows_bound,
        fields_bound=cfg.model.num_fields if want_fields else 0,
    )


def _host_array(v) -> np.ndarray:
    """A contiguous, writable array: views of a read-only `.xfc` memmap
    are copied, as torch does not take a read-only buffer."""
    a = np.ascontiguousarray(v)
    return a if a.flags.writeable else a.copy()


def to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(_host_array(v)).to(device) for k, v in arrays.items()}


def predict_batches(cfg: Config, tables: dict, path: str,
                    device="cuda") -> Iterator[tuple[SparseBatch, np.ndarray]]:
    """(batch, pctr [B] on the host) for every batch of libffm file `path`,
    predicted on `device` with `tables` (already on that device). Batches
    are read and planned in a prefetch thread, counting bad rows without
    raising or quarantining them (an eval pass, as in the JAX trainer)."""
    step = make_predict_fn(get_model(cfg.model.name)(cfg))
    dedup = HostDedup(cfg)

    def feed():
        for batch in batch_iterator(path, cfg.data, enforce_bad_rows=False,
                                    quarantine=False):
            yield batch, batch_arrays(batch, cfg, dedup)

    stream = prefetch(feed())
    try:
        for batch, host in stream:
            p = step(tables, to_device(host, device))
            yield batch, p.cpu().numpy()
    finally:
        stream.close()  # an early close stops the reader at once


def dump_rows(fout, p, y) -> None:
    """The reference's prediction rows, `pctr\t1-label\tlabel`, into
    `fout` (nothing when it is None)."""
    if fout is not None:
        fout.writelines(f"{pi:.6f}\t{int(1 - yi)}\t{int(yi)}\n" for pi, yi in zip(p, y))


def evaluate(cfg: Config, tables: dict, path: str, device="cuda",
             fout=None) -> tuple[float, float]:
    """(auc, logloss) of `tables` on libffm file `path`; logloss keeps the
    reference's sign (a mean log-likelihood). With `fout`, each real
    row's prediction goes there too (`dump_rows`), in file order."""
    pctrs, labels = [], []
    for batch, p in predict_batches(cfg, tables, path, device):
        rm = np.asarray(batch.row_mask) > 0
        p, y = p[rm], np.asarray(batch.labels)[rm]
        pctrs.append(p)
        labels.append(y)
        dump_rows(fout, p, y)
    if not pctrs:
        return float("nan"), float("nan")
    return auc_logloss(np.concatenate(pctrs), np.concatenate(labels))
