"""Multi-view machine (`xflow_tpu/models/mvm.py`): per latent dim k, the
view sum of v over each field's features in the row, the product over
the fields present in the row, summed over k:

    logit = Σ_k Π_{f present} (plus + Σ_{occ of field f} v_k[occ])

with plus = 0 (the plain form) or 1 (`model.mvm_plus_one`). Absent
fields contribute the multiplicative identity.

Table: ``v [S, k]``. Three forward forms, one function:

- row-major (serving): the per-(row, field) view sums as a masked sum
  over the row's occurrences;
- sorted, PRODUCT row side (no `sorted_fields` in the batch): the host
  checked that no row repeats a field (`has_field_duplicates`), so each
  view sum is a single v and the product over fields is a product over
  the row's occurrences, taken in log space through the row-sum kernel
  (`row_sums_sorted`) with a hand-written backward;
- sorted, SEGMENT row side (`sorted_fields` present): one segment sum
  keyed on ``row * num_fields + field``, then the product over fields.
  Its plan may be stacked into NS sub-batches (`sorted_gather_map`).
"""

from __future__ import annotations

import numpy as np
import torch

from xflow_tpu_torch.models.base import Model, register_model
from xflow_tpu_torch.ops.sorted_table import (
    _k8,
    batch_rows,
    row_sums_sorted,
    segment_sum_channels,
    sorted_gather_map,
    wire_mask,
    wire_rows,
)

# The product row side's log-space constants: LOG_TINY guards ln(0) (exact
# zeros are counted in their own channel, and every formula uses
# differences of ln sums, where the clamped value cancels); the clip
# bounds exp: past e^60 the model has diverged, below e^-87 float32
# underflows to the 0 the true product rounds to.
MVM_LOG_TINY = 1e-30
MVM_LOG_CLIP = (-87.0, 60.0)


def has_field_duplicates(fields: np.ndarray, mask: np.ndarray) -> bool:
    """Does any row carry two masked occurrences of the same field? The
    product row side requires it false."""
    f = np.asarray(fields)
    m = np.asarray(mask) > 0
    if f.size == 0 or f.shape[1] <= 1:
        return False
    if int(f.max(initial=0)) < 64 and hasattr(np, "bitwise_count"):
        bits = np.where(m, np.uint64(1) << f.astype(np.uint64), np.uint64(0))
        distinct = np.bitwise_count(np.bitwise_or.reduce(bits, axis=1))
        return bool((distinct.astype(np.int64) < m.sum(axis=1)).any())
    # masked-out entries get distinct negative keys: never an equal pair
    keyed = np.where(m, f.astype(np.int64), -1 - np.arange(f.shape[1])[None, :])
    s = np.sort(keyed, axis=1)
    return bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())


def resolve_mvm_product(mvm_exclusive: str, has_dup: bool, num_processes: int) -> bool:
    """Route one batch: the product row side (True) or the segment row
    side (False). Under "on" a repeated field raises; so does any
    repeated field in a multi-process run, which cannot route per batch."""
    if mvm_exclusive == "off":
        return False
    if mvm_exclusive not in ("auto", "on"):
        raise ValueError(
            f"model.mvm_exclusive={mvm_exclusive!r}: expected auto|on|off"
        )
    if has_dup:
        if mvm_exclusive == "on" or num_processes > 1:
            raise ValueError(
                "MVM exclusive-fields product path: a row carries two masked "
                "occurrences of the same field. Set model.mvm_exclusive=off "
                "to use the segment-sum path"
                + (
                    " (this multi-process configuration cannot fall back per "
                    "batch: the two paths' collective sequences differ across "
                    "ranks — only the fullshard engine's `auto` coordinates "
                    "the choice. Peer ranks that hit no duplicate may block "
                    "in their collectives until the launcher's fail-fast "
                    "teardown — set mvm_exclusive=off up front)"
                    if num_processes > 1
                    else ""
                )
            )
        return False
    return True


def mvm_product_channels(occ_t_k: torch.Tensor, sorted_mask: torch.Tensor,
                         k: int) -> torch.Tensor:
    """[k, Np] gathered factors + [Np] mask -> [_k8(3k), Np] channels
    whose row sums carry each row's factor products in log space: ln|v|
    (zeros clamped to ln LOG_TINY), the negative count and the exact-zero
    count per latent dim, zero rows to a multiple of 8."""
    m = sorted_mask[None, :]
    L = m * torch.log(torch.clamp(occ_t_k.abs(), min=MVM_LOG_TINY))
    N = m * (occ_t_k < 0.0)
    Z = m * (occ_t_k == 0.0)
    pad = torch.zeros((_k8(3 * k) - 3 * k, occ_t_k.shape[1]), dtype=occ_t_k.dtype,
                      device=occ_t_k.device)
    return torch.cat([L, N, Z, pad], dim=0)


def _products_from_sums(S, NC, ZC):
    """(ln sum, negative count, zero count) -> signed products. The counts
    are integer-valued floats, exact in float32."""
    sign = 1.0 - 2.0 * torch.remainder(NC, 2.0)
    return torch.where(ZC > 0, torch.zeros((), dtype=S.dtype, device=S.device),
                       sign * torch.exp(torch.clamp(S, *MVM_LOG_CLIP)))


class RowProducts(torch.autograd.Function):
    """P [rows, k], P[r, c] = Π over row r's masked occurrences of
    occ_t_k[c, occ], through `row_sums_sorted` in log space. The backward
    is written by hand (`make_row_products` in the JAX package):

        dP/dv_j = sign_ex · exp(S − L_j) · [ZC − Z_j == 0]

    the exclusive product of the row's other factors. It is exact at
    zeros: a zero occurrence keeps its nonzero gradient (the clamped ln
    cancels in S − L_j) and the other occurrences of a row that holds a
    zero get exactly 0, the zero pattern FTRL's lazy-init guard reads.
    Autograd through log/exp would not give those zeros."""

    @staticmethod
    def forward(ctx, occ_t_k, mask, rows, num_rows, k):
        sums = row_sums_sorted(mvm_product_channels(occ_t_k, mask, k), rows, num_rows)
        ctx.save_for_backward(occ_t_k, mask, rows, sums)
        ctx.k = k
        return _products_from_sums(sums[:, :k], sums[:, k : 2 * k], sums[:, 2 * k : 3 * k])

    @staticmethod
    def backward(ctx, dP):
        occ_t_k, mask, rows, sums = ctx.saved_tensors
        k = ctx.k
        per = torch.cat([dP, sums[:, : 3 * k]], dim=1)[rows.long()].T  # [4k, Np]
        dPo, S, NC, ZC = (per[i * k : (i + 1) * k] for i in range(4))
        m = mask[None, :]
        L = torch.log(torch.clamp(occ_t_k.abs(), min=MVM_LOG_TINY))
        S_ex = S - m * L
        NC_ex = NC - m * (occ_t_k < 0.0)
        ZC_ex = ZC - m * (occ_t_k == 0.0)
        P_ex = _products_from_sums(S_ex, NC_ex, ZC_ex)
        return dPo * P_ex * m, None, None, None, None


def row_products(occ_t_k, mask, rows, num_rows: int, k: int) -> torch.Tensor:
    """The product op (`make_row_products` on one device): [rows, k]."""
    return RowProducts.apply(occ_t_k, mask, rows, num_rows, k)


def _product_row_side(occ_t, sorted_row, sorted_mask, rows: int, k: int,
                      plus: float = 0.0) -> torch.Tensor:
    """One (sub-)batch's logits on the product row side: the row-sum
    kernel at ch = _k8(3k), no per-(row, field) state at all. With
    exclusive fields the per-occurrence factor (plus + v) equals the
    per-field (plus + s), so one op covers both factor forms."""
    sorted_row, sorted_mask = wire_rows(sorted_row), wire_mask(sorted_mask)
    P = row_products(occ_t[:k] + plus, sorted_mask, sorted_row, rows, k)
    return P.sum(dim=1)


def _segment_row_side(occ_t, sorted_row, sorted_mask, sorted_fields, rows: int,
                      nf: int, k: int, plus: float = 0.0) -> torch.Tensor:
    """One (sub-)batch's logits on the segment row side: one segment sum
    keyed on ``row * nf + field``, the mask stacked as an extra channel
    so the same sum counts each (row, field)'s occurrences."""
    sorted_row, sorted_mask = wire_rows(sorted_row), wire_mask(sorted_mask)
    seg = sorted_row * nf + wire_rows(sorted_fields)
    occm_t = occ_t[:k] * sorted_mask[None, :]
    stacked = torch.cat([occm_t, sorted_mask[None, :]], dim=0)  # [k+1, Np]
    sums = segment_sum_channels(stacked, seg, rows * nf)  # [rows*nf, k+1]
    s = sums[:, :k].reshape(rows, nf, k)
    present = (sums[:, k] > 0).reshape(rows, nf)
    factors = torch.where(present[..., None], s + plus, torch.ones((), dtype=s.dtype,
                                                                  device=s.device))
    return torch.prod(factors, dim=1).sum(dim=-1)


def _forward_sorted(tables: dict, batch: dict, cfg) -> torch.Tensor:
    v = tables["v"]
    bf16 = cfg.data.sorted_bf16
    plus = 1.0 if cfg.model.mvm_plus_one else 0.0
    k = cfg.model.v_dim
    B = batch["labels"].shape[0]
    if "sorted_fields" not in batch:
        return sorted_gather_map(
            v, batch, ("sorted_row", "sorted_mask"), B,
            lambda occ, sr, sm, rows: _product_row_side(occ, sr, sm, rows, k, plus),
            k, bf16,
        )
    nf = cfg.model.num_fields
    return sorted_gather_map(
        v, batch, ("sorted_row", "sorted_mask", "sorted_fields"), B,
        lambda occ, sr, sm, sf, rows: _segment_row_side(occ, sr, sm, sf, rows, nf, k, plus),
        k, bf16,
    )


@register_model
class MVM(Model):
    name = "mvm"

    @staticmethod
    def table_specs(cfg):
        return {"v": (cfg.model.v_dim,)}

    def forward(self, tables: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if "sorted_slots" in batch:
            return _forward_sorted(tables, batch, cfg)
        nf = cfg.model.num_fields
        mask = batch["mask"]
        vg = batch_rows(tables["v"], batch) * mask[..., None]  # [B, F, k]
        onehot = (batch["fields"][..., None] == torch.arange(nf, device=mask.device)) \
            * mask[..., None]  # [B, F, nf]
        # the view sums as a masked sum, not a matmul: no TF32 on the card,
        # and the product over fields amplifies any rounding
        s = (onehot[..., None] * vg[:, :, None, :]).sum(dim=1)  # [B, nf, k]
        present = onehot.sum(dim=1) > 0
        plus = 1.0 if cfg.model.mvm_plus_one else 0.0
        factors = torch.where(present[..., None], s + plus,
                              torch.ones((), dtype=s.dtype, device=s.device))
        return torch.prod(factors, dim=1).sum(dim=-1)
