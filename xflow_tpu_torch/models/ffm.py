"""Field-aware factorization machine (`xflow_tpu/models/ffm.py`): feature
i carries one latent vector per opposing field, and the pair (i, j)
interacts through its field-crossed vectors:

    logit = wx + Σ_{i<j} ⟨v_{i, f_j}, v_{j, f_i}⟩

Table: one fused ``wv [S, 1 + nf·k]`` row per feature, column 0 = w,
then nf contiguous k-blocks (block c = the vector against field c).

With the field sums S[b, c1, c2, :] = Σ_{i : f_i = c1} v_{i, c2} the
pairwise term is ½ (Σ_{c1,c2} ⟨S[b,c1,c2], S[b,c2,c1]⟩ − Σ_i ‖v_{i,f_i}‖²),
exact for multi-valued fields too. Two forward forms, one function:

- row-major (serving, and the per-batch fallback for a batch whose rows
  repeat a field): S from a field one-hot product, the c1 <-> c2 swap as
  a static index on the flattened minor dim (`block_transpose_perm`);
- sorted, the ALIGNED HYBRID (a batch with at most one masked occurrence
  per (row, field), `ffm_invperm` in the batch): the windowed gather (#1)
  hands every occurrence's row in slot order, one host-planned index
  places it as A [B, nf, K], and the pairwise term is an index gather of
  A (`AlignedRowMath`). Both steps carry hand-written backwards. The
  JAX package pads the placement to [B, nfp, K8] and contracts A with a
  0/1 selector on the MXU, both for the TPU's tiles; here the placement
  is [B, nf, K] and the swap a gather, which moves the same values.

- sorted, the per-(row, field) SEGMENT row side (a sorted batch without
  `ffm_invperm`, flat or stacked): one segment sum keyed on
  ``row * nf + field`` of the occurrence channels (w, the v blocks,
  ‖v_self‖²) and the field-sum contraction, with a hand-written backward
  exact at zeros (`make_ffm_row_op`). It is the fully-sharded mesh
  engine's row side (`parallel/sorted_fullshard.py`), where the row
  aggregates cross the ranks; the single-device trainer plans aligned
  batches, and the hybrid above, as before.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from xflow_tpu_torch.models.base import Model, register_model
from xflow_tpu_torch.models.mvm import has_field_duplicates
from xflow_tpu_torch.ops.sorted_table import (
    batch_rows,
    segment_sum_channels,
    sorted_gather_map,
    table_gather_sorted,
    wire_mask,
    wire_rows,
)

# Host routing of FFM batches under the sorted layout (`evaluate.batch_arrays`):
# "aligned" batches take the hybrid, "row_major" ones (a row repeats a field)
# the row-major fallback. Counted so a run can show which route its batches took.
ROUTES = {"aligned": 0, "row_major": 0}
_ROUTES_LOCK = threading.Lock()  # batches are routed in the prefetch thread


def count_route(name: str) -> None:
    with _ROUTES_LOCK:
        ROUTES[name] += 1


def reset_routes() -> None:
    with _ROUTES_LOCK:
        for k in ROUTES:
            ROUTES[k] = 0


def _dims(cfg) -> tuple[int, int]:
    return cfg.model.num_fields, cfg.model.v_dim


def resolve_ffm_aligned(fields: np.ndarray, mask: np.ndarray) -> bool:
    """Route one batch: the aligned hybrid (True) or the row-major
    fallback (False, a row carries two masked occurrences of a field)."""
    return not has_field_duplicates(fields, mask)


def ffm_invperm(sorted_row, sorted_fields, sorted_mask, rows: int, nf: int) -> np.ndarray:
    """The placement of an aligned plan, on the host: int32 [rows, nf],
    (row, field) -> the plan position of its one masked occurrence, Np-1
    (a pad position: plans end in a spare chunk) where the row has none.
    The JAX package's `ffm_invperm` with its rows cut from nfp to nf
    fields. Raises on a duplicate (row, field) occurrence."""
    Np = np.asarray(sorted_row).shape[0]
    inv = np.full(rows * nf, Np - 1, np.int32)
    real = np.asarray(sorted_mask) > 0
    dest = (np.asarray(sorted_row)[real].astype(np.int64) * nf
            + np.asarray(sorted_fields)[real])
    inv[dest] = np.nonzero(real)[0].astype(np.int32)
    # a duplicate overwrites a destination: fewer occupied than real
    if int((inv != Np - 1).sum()) != dest.size:
        raise ValueError(
            "ffm_invperm: duplicate (row, field) occurrence in an aligned plan; "
            "route duplicate-field batches to the row-major path (resolve_ffm_aligned)"
        )
    return inv.reshape(rows, nf)


@functools.lru_cache(maxsize=None)
def _block_transpose_np(nf: int, k: int) -> np.ndarray:
    c1, c2, kk = np.meshgrid(np.arange(nf), np.arange(nf), np.arange(k), indexing="ij")
    return (c2 * nf * k + c1 * k + kk).reshape(-1)


def block_transpose_perm(nf: int, k: int, device="cpu") -> torch.Tensor:
    """The static involution (c1, c2, kk) <-> (c2, c1, kk) on a flattened
    [nf·nf·k] field-sum index, as int64 indices on `device`."""
    return torch.as_tensor(_block_transpose_np(nf, k), device=device)


# ------------------------------------------------------------ aligned hybrid

@functools.lru_cache(maxsize=None)
def _swap_index_np(nf: int, k: int) -> np.ndarray:
    """Flat index into A [nf, K] of Xv [nf, nf·k]: Xv[c2, c1·k + kk] =
    A[c1, 1 + c2·k + kk]."""
    K = 1 + nf * k
    c2, c1, kk = np.meshgrid(np.arange(nf), np.arange(nf), np.arange(k), indexing="ij")
    return (c1 * K + 1 + c2 * k + kk).reshape(-1)


@functools.lru_cache(maxsize=None)
def _own_block_np(nf: int, k: int) -> np.ndarray:
    q = np.zeros((nf, nf * k), np.float32)
    for c in range(nf):
        q[c, c * k : (c + 1) * k] = 1.0
    return q


class Place(torch.autograd.Function):
    """A [B, nf, K] = the gathered rows of `occ_t [K8, Np]` at the
    placement `invperm [B, nf]`, 0 where the row has no occurrence of the
    field. The backward is the reverse gather,
    ``d_occ[:, p] = d_A[src[p]] * smask[p]`` (src = row·nf + field), never
    an `index_add_`: the placement is a partial permutation. Rows K..K8
    of d_occ are zero."""

    @staticmethod
    def forward(ctx, occ_t, invperm, src, smask, K):
        np_ = occ_t.shape[1]
        inv = invperm.long()
        # one transpose to position-major rows, then whole-row gathers
        A = occ_t[:K].T.contiguous()[inv]
        A = torch.where((inv != np_ - 1)[..., None], A, torch.zeros((), dtype=A.dtype,
                                                                    device=A.device))
        ctx.save_for_backward(src, smask)
        ctx.occ_shape = tuple(occ_t.shape)
        return A

    @staticmethod
    def backward(ctx, d_A):
        src, smask = ctx.saved_tensors
        B, nf, K = d_A.shape
        rows = d_A.reshape(B * nf, K)[src.long()] * smask[:, None]  # [Np, K]
        d_occ = d_A.new_zeros(ctx.occ_shape)
        d_occ[:K] = rows.T
        return d_occ, None, None, None, None


class AlignedRowMath(torch.autograd.Function):
    """Logits [B] from the placed rows A [B, nf, K] (K = 1 + nf·k):

        X = T(A):  X[b, c2, 1 + c1·k + kk] = A[b, c1, 1 + c2·k + kk]
        logit = Σ_c A[b, c, 0] + ½ (Σ A·X − Σ A²·Q)

    with Q the own-block select (block c of field c's row). X is one
    index gather of A's v columns. The backward is written by hand,

        d_A = dl · (X − A·Q + W)        (W: the w column)

    with the two terms in one subtraction, so it is exactly 0 where a
    field has one occupant (X at its own block is A's bits) and towards
    absent fields (A = 0 there): the zeros FTRL's lazy-init guard reads
    (g == 0 and n == 0 keeps w)."""

    @staticmethod
    def forward(ctx, A, nf, k):
        B = A.shape[0]
        Av = A[:, :, 1:]
        # X's w column is 0 and is not formed: Xv holds its v columns
        swap = torch.as_tensor(_swap_index_np(nf, k), device=A.device)
        Xv = A.reshape(B, -1)[:, swap].view(B, nf, nf * k)
        own = torch.as_tensor(_own_block_np(nf, k), device=A.device)
        full = (Av * Xv).sum(dim=(1, 2))
        qsum = (Av * Av * own).sum(dim=(1, 2))
        ctx.save_for_backward(A, Xv, own)
        return A[:, :, 0].sum(dim=1) + 0.5 * (full - qsum)

    @staticmethod
    def backward(ctx, dl):
        A, Xv, own = ctx.saved_tensors
        d_A = torch.empty_like(A)
        d_A[:, :, 0] = dl[:, None]
        d_A[:, :, 1:] = dl[:, None, None] * (Xv - A[:, :, 1:] * own)
        return d_A, None, None


def ffm_aligned_logits(occ_t: torch.Tensor, batch: dict, cfg) -> torch.Tensor:
    """Row-side logits of an aligned batch from its gathered rows
    `occ_t [K8, Np]`: shared by the forward, evaluation and the fused
    train step."""
    nf, k = _dims(cfg)
    src = wire_rows(batch["sorted_row"]) * nf + wire_rows(batch["sorted_fields"])
    A = Place.apply(occ_t, batch["ffm_invperm"], src, wire_mask(batch["sorted_mask"]),
                    1 + nf * k)
    return AlignedRowMath.apply(A, nf, k)


# ------------------------------------------------------- segment row side

def ffm_logits_from_sums(sums: torch.Tensor, nf: int, k: int) -> torch.Tensor:
    """[rows, nf, K+1] per-(row, field) channel sums -> [rows] logits.
    Channel 0 is w, 1..nf·k the v blocks, K = nf·k+1 the ‖v_self‖² term;
    ``sums[r, c1]`` sums row r's field-c1 occurrences. The field-sum
    contraction Σ ⟨S[c1, c2], S[c2, c1]⟩ is an elementwise product and a
    sum (no matmul, so no reduced-precision path on the card)."""
    K = 1 + nf * k
    R = sums.shape[0]
    wx = sums[:, :, 0].sum(dim=1)
    S = sums[:, :, 1:K].reshape(R, nf, nf, k)
    qsum = sums[:, :, K].sum(dim=1)
    full = (S * S.transpose(1, 2)).sum(dim=(1, 2, 3))
    return wx + 0.5 * (full - qsum)


def ffm_occurrence_channels(occ_t, mask, fields, nf: int, k: int) -> torch.Tensor:
    """[K8, Np] gathered rows, mask and per-occurrence field ids ->
    [K+1, Np]: the masked w and v blocks, then ‖v_{occ, f_occ}‖² (the
    own-field block by a one-hot sum, not a gather)."""
    K = 1 + nf * k
    occm = occ_t[:K] * mask[None, :]
    v3 = occm[1:].reshape(nf, k, occm.shape[1])
    onehot = (fields[None, :] == torch.arange(nf, device=fields.device)[:, None]).to(occm.dtype)
    vself = (v3 * onehot[:, None, :]).sum(dim=0)  # [k, Np]
    q = (vself * vself).sum(dim=0)
    return torch.cat([occm, q[None, :]], dim=0)


class FFMRowOp(torch.autograd.Function):
    """Logits [R] of the segment row side from the gathered rows, through
    `reduce_segments(data [K+1, Np], seg [Np]) -> [R, nf, K+1]`. The
    backward is JAX's `make_ffm_row_op` hand VJP:

        d v_i[c] = dl_b · (S[b, c, f_i] − [c == f_i] · v_i[c]),  d w_i = dl_b

    the two terms in one subtraction, so it is exactly 0 where
    S[b, c, f_i] is v_i's own bits (a single-occupant field) or 0 (an
    absent field): the zeros FTRL's lazy-init guard reads. The row
    aggregates reach the occurrences through `broadcast_rows` (the
    identity on one device, `all_gather` over `data` in the fully-sharded
    engine) after `restore_dl` fixes up the cotangent."""

    @staticmethod
    def forward(ctx, occ_t, mask, fields, rows, hooks):
        reduce_segments, _, _, nf, k = hooks
        data = ffm_occurrence_channels(occ_t, mask, fields, nf, k)
        sums = reduce_segments(data, rows * nf + fields)  # [R, nf, K+1]
        ctx.save_for_backward(occ_t, mask, fields, rows, sums)
        ctx.hooks = hooks
        return ffm_logits_from_sums(sums, nf, k)

    @staticmethod
    def backward(ctx, dl):
        occ_t, mask, fields, rows, sums = ctx.saved_tensors
        _, broadcast_rows, restore_dl, nf, k = ctx.hooks
        K = 1 + nf * k
        R = sums.shape[0]
        dl = restore_dl(dl)
        packed = broadcast_rows(torch.cat([dl[:, None], sums.reshape(R, -1)], dim=1))
        dl_all, sums_all = packed[:, 0], packed[:, 1:]
        R_all = sums_all.shape[0]
        A = sums_all.reshape(R_all, nf, K + 1)[:, :, 1:K].reshape(R_all, nf, nf, k)
        # Tmat[b*nf + f, c*k + kk] = S[b, c, f, kk]
        Tmat = A.transpose(1, 2).reshape(R_all * nf, nf * k)
        ri = rows.long()
        G = Tmat[ri * nf + fields.long()].T  # [nf*k, Np]
        occm_v = occ_t[1:K] * mask[None, :]
        blockmask = torch.repeat_interleave(
            (fields[None, :] == torch.arange(nf, device=fields.device)[:, None]).to(occ_t.dtype),
            k, dim=0)
        dl_occ = dl_all[ri] * mask
        d_v = (G - occm_v * blockmask) * dl_occ[None, :]
        d_occ = occ_t.new_zeros(occ_t.shape)
        d_occ[0] = dl_occ
        d_occ[1:K] = d_v
        return d_occ, None, None, None, None


def make_ffm_row_op(reduce_segments, broadcast_rows, nf: int, k: int, restore_dl=None):
    """`op(occ_t [K8, Np], mask, fields, rows) -> logits [R]` with the
    hooks of JAX's `make_ffm_row_op` (None: the identity)."""
    ident = lambda x: x  # noqa: E731
    hooks = (reduce_segments, broadcast_rows or ident, restore_dl or ident, nf, k)
    return lambda occ_t, mask, fields, rows: FFMRowOp.apply(occ_t, mask, fields, rows, hooks)


def _row_side_sorted(occ_t, sorted_row, sorted_mask, sorted_fields, rows: int, cfg):
    """One (sub-)batch's segment row side on one device: the segment sum
    into [rows·nf, K+1] field sums, then the logits."""
    nf, k = _dims(cfg)
    K = 1 + nf * k
    op = make_ffm_row_op(
        lambda data, seg: segment_sum_channels(data, seg, rows * nf).reshape(rows, nf, K + 1),
        None, nf, k,
    )
    return op(occ_t, wire_mask(sorted_mask), wire_rows(sorted_fields), wire_rows(sorted_row))


def _forward_sorted(tables: dict, batch: dict, cfg) -> torch.Tensor:
    """The aligned hybrid for a batch with its placement, else the
    segment row side (flat or stacked plans)."""
    if "ffm_invperm" in batch:
        occ_t = table_gather_sorted(tables["wv"], batch["sorted_slots"], batch["win_off"],
                                    cfg.data.sorted_bf16)
        return ffm_aligned_logits(occ_t, batch, cfg)
    nf, k = _dims(cfg)
    return sorted_gather_map(
        tables["wv"], batch, ("sorted_row", "sorted_mask", "sorted_fields"),
        batch["labels"].shape[0],
        lambda occ, sr, sm, sf, rows: _row_side_sorted(occ, sr, sm, sf, rows, cfg),
        1 + nf * k, cfg.data.sorted_bf16,
    )


@register_model
class FFM(Model):
    name = "ffm"

    @staticmethod
    def table_specs(cfg):
        nf, k = _dims(cfg)
        return {"wv": (1 + nf * k,)}

    def forward(self, tables: dict, batch: dict) -> torch.Tensor:
        """Sorted batches take the aligned hybrid; row-major ones the
        field-sum form: vm [B, F, nf·k] masked v blocks, S [B, nf, nf·k]
        their field sums (one product with the field one-hot), the
        pairwise sum against S's block transpose, the self terms as one
        masked elementwise pass."""
        cfg = self.cfg
        if "sorted_slots" in batch:
            return _forward_sorted(tables, batch, cfg)
        nf, k = _dims(cfg)
        mask = batch["mask"]
        wvg = batch_rows(tables["wv"], batch)  # [B, F, 1 + nf*k]
        wx = (wvg[..., 0] * mask).sum(dim=-1)
        vm = wvg[..., 1:] * mask[..., None]
        onehot = (batch["fields"][..., None] == torch.arange(nf, device=mask.device)
                  ).to(vm.dtype) * mask[..., None]  # [B, F, nf]
        S = torch.einsum("bfc,bfe->bce", onehot, vm)  # [B, nf, nf*k]
        Sf = S.reshape(S.shape[0], -1)
        full = (Sf * Sf[:, block_transpose_perm(nf, k, mask.device)]).sum(dim=-1)
        blocksel = onehot.repeat_interleave(k, dim=-1)  # [B, F, nf*k]
        qsum = (vm * vm * blocksel).sum(dim=(-1, -2))
        return wx + 0.5 * (full - qsum)
