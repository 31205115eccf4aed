"""Factorization machine: logit = Σᵢ wᵢ + second-order term over the
row's masked latent vectors (`xflow_tpu/models/fm.py`).

- `fm_standard=True`: ½ Σₖ [(Σᵢ v_ik)² − Σᵢ v_ik²] (the ½ only with
  `fm_half`);
- `fm_standard=False`: the reference's coupled form, one scalar
  accumulator over (i, k): (Σᵢₖ v_ik)² − Σᵢₖ v_ik².

Tables: one fused ``wv [S, 1+k]`` (column 0 = w) or, with
`fm_fused=False`, ``w [S]`` and ``v [S, k]``. Row-major batches gather
rows per occurrence; sorted-plan batches (fused table only, flat or
stacked into sub-batches) run the windowed gather and the row-sum
kernels.
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.models.base import Model, register_model
from xflow_tpu_torch.ops.sorted_table import (
    _k8,
    batch_rows,
    row_sums_sorted,
    sorted_gather_map,
    wire_mask,
    wire_rows,
)


def _second_order(vg: torch.Tensor, cfg) -> torch.Tensor:
    """vg: [B, F, k] masked latent rows -> [B] second-order term."""
    if cfg.model.fm_standard:
        s = vg.sum(dim=1)
        q = (vg * vg).sum(dim=1)
        second = (s * s - q).sum(dim=-1)
        if cfg.model.fm_half:
            second = 0.5 * second
    else:
        s = vg.sum(dim=(1, 2))
        q = (vg * vg).sum(dim=(1, 2))
        second = s * s - q
    return second


def stack_channels(occm_t: torch.Tensor, K: int) -> torch.Tensor:
    """[K, Np] masked rows -> [ch, Np]: w, the k latents, their squares,
    zero rows up to a multiple of 8."""
    nch = 2 * K - 1
    ch = _k8(nch)
    return torch.cat(
        [occm_t, occm_t[1:] ** 2,
         torch.zeros((ch - nch, occm_t.shape[1]), dtype=occm_t.dtype, device=occm_t.device)],
        dim=0,
    )


def fm_logits_from_sums(sums: torch.Tensor, K: int, cfg) -> torch.Tensor:
    """[rows, ch] per-row channel sums -> [rows] logits."""
    nch = 2 * K - 1
    wx = sums[:, 0]
    s, q = sums[:, 1:K], sums[:, K:nch]
    if cfg.model.fm_standard:
        second = (s * s - q).sum(dim=-1)
        if cfg.model.fm_half:
            second = 0.5 * second
    else:
        s_all, q_all = s.sum(dim=-1), q.sum(dim=-1)
        second = s_all * s_all - q_all
    return wx + second


def _row_side_sorted(occ_t, sorted_row, sorted_mask, rows: int, cfg) -> torch.Tensor:
    K = 1 + cfg.model.v_dim
    sorted_row, sorted_mask = wire_rows(sorted_row), wire_mask(sorted_mask)
    occm_t = occ_t[:K] * sorted_mask[None, :]
    stacked = stack_channels(occm_t, K).contiguous()
    sums = row_sums_sorted(stacked, sorted_row, rows)
    return fm_logits_from_sums(sums, K, cfg)


def _forward_sorted(tables: dict, batch: dict, cfg) -> torch.Tensor:
    """Sorted-window path: gather every occurrence's row once (one
    multi-buffer gather for a stacked plan), then reduce each
    (sub-)batch's channels into per-row sums."""
    return sorted_gather_map(
        tables["wv"], batch, ("sorted_row", "sorted_mask"), batch["labels"].shape[0],
        lambda occ, sr, sm, rows: _row_side_sorted(occ, sr, sm, rows, cfg),
        1 + cfg.model.v_dim, cfg.data.sorted_bf16,
    )


@register_model
class FM(Model):
    name = "fm"

    @staticmethod
    def table_specs(cfg):
        if cfg.model.fm_fused:
            return {"wv": (1 + cfg.model.v_dim,)}
        return {"w": (), "v": (cfg.model.v_dim,)}

    def forward(self, tables: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if "sorted_slots" in batch and "wv" in tables:
            return _forward_sorted(tables, batch, cfg)
        mask = batch["mask"]
        if "wv" in tables:
            wvg = batch_rows(tables["wv"], batch)
            wx = (wvg[..., 0] * mask).sum(dim=-1)
            vg = wvg[..., 1:] * mask[..., None]
        else:
            wg = batch_rows(tables["w"], batch)
            wx = (wg * mask).sum(dim=-1)
            vg = batch_rows(tables["v"], batch) * mask[..., None]
        return wx + _second_order(vg, cfg)
