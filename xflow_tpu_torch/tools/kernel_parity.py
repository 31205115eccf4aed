"""On-device parity gate for the port's CUDA kernels: the counterpart of
`xflow_tpu/tools/kernel_parity.py`.

    python -m xflow_tpu_torch.tools.kernel_parity     # on the card; exits 2 without one

CPU tests cannot run a CUDA kernel, so this re-checks on the card, with
the JAX gate's inputs drawn in the JAX gate's numpy order (2^15 slots,
2^17 occurrences, k = 11, 4,096-row batch, the table scaled by e^U(-8,8)
so that each check spans the full float32 range), each kernel against an
independent torch oracle computed on the CPU (`index_select` for
gathers, `index_add_` for sums, the two-pass `index_add_` + `update_one`
for the fused step; on the CPU `index_add_` adds in index order, so its
sums repeat from run to run where the card's atomics do not):

- the gathers (#1 single-stream, #5 multi-buffer, and #1 at the aligned
  width k = 16, where K8 == K) bit-exact; the bf16 gather within 2^-7;
- the scatters (#4, #6, #4 at k = 16) within 1e-4 over a 1e-2 floor
  (reduction reorder);
- the fused scatter+FTRL (#3) within 1e-3 over a 1e-4 floor for w, n and
  z, with the upper half of the table untouched (zero gradient, zero n
  and z) so that the lazy-init guard runs;
- the row sum #2 at ch = 24 bitwise (`rowsum_bitwise`, the number of
  sums whose bits differ, 0), and within the JAX gate's 1e-4 over a 1e-2 floor
  (`rowsum`): it adds a row's terms in plan order from +0, as
  `index_add_` does on the CPU;
- the lab's row sum #11 within the float32 reorder bound
  (`bench_lab.reorder_err`: under 1 is reordering alone). It adds with
  float atomics in an order that changes from run to run, and a row here
  sums about 29 unit-scale terms: two orders differ by up to a few ulps
  of the partial sums, which is 0.8e-4 to 1.4e-4 relative over the JAX
  gate's 1e-2 floor (measured on the H100), so that figure is reported
  (`rel_floor`) and not gated.

The JAX gate's `gather_packed` and `scatter_packed` have no counterpart:
the port stores tables logical `[S, K]` (see the package docstring), so
there is no packed path to check.

On CUDA tensors each op launches its kernel or raises; on CPU tensors
(`device="cpu"`, for the tests) it takes its plain version, so the same
checks hold the plain versions against the oracles. `main` never falls
back to the CPU: without a CUDA device it reports ``"ok": false`` and
exits 2.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from xflow_tpu_torch.tools.bench_lab import rel_err, reorder_err

TOLERANCES = {
    "gather_exact": 0.0,
    "gather_multi_exact": 0.0,
    "gather_bf16": 2.0 ** -7,
    # scatters sum duplicate-slot terms in kernel order, index_add_ in its
    # own: with the 1e-2 floor, reorder noise reads as <= 1e-4, while a
    # routing bug moves O(1) mass
    "scatter_exact": 1e-4,
    "scatter_multi_exact": 1e-4,
    "gather_aligned_k": 0.0,
    "scatter_aligned_k": 1e-4,
    # gradient reorder noise (scatter class) flows through FTRL's
    # sqrt/divide
    "scatter_ftrl_w": 1e-3,
    "scatter_ftrl_n": 1e-3,
    "scatter_ftrl_z": 1e-3,
    # the row sum adds in plan order: bitwise, and the JAX gate
    "rowsum_bitwise": 0.0,
    "rowsum": 1e-4,
    # a share of the float32 reorder bound (see the module docstring)
    "lab_rowsum": 1.0,
}
FLOORS = {"scatter_exact": 1e-2, "scatter_multi_exact": 1e-2, "scatter_aligned_k": 1e-2,
          "scatter_ftrl_w": 1e-4, "scatter_ftrl_n": 1e-4, "scatter_ftrl_z": 1e-4,
          "rowsum": 1e-2, "lab_rowsum": 1e-2}


def _gather_oracle(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[K8, Np] on the CPU: rows of `table` by `index_select`, transposed,
    zero rows K..K8 and zero columns for slots outside the table."""
    from xflow_tpu_torch.ops.sorted_table import _k8

    table, slots = table.cpu(), slots.cpu()
    S, K = table.shape
    valid = (slots >= 0) & (slots < S)
    rows = table.index_select(0, slots.clamp(0, S - 1).long()) * valid[:, None]
    out = torch.zeros((_k8(K), slots.shape[0]), dtype=table.dtype, device=table.device)
    out[:K] = rows.T
    return out


def _sum_oracle(d_t: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ch] on the CPU: the columns of d_t [ch, Np] summed by index
    (`index_add_`, in index order)."""
    out = torch.zeros((n, d_t.shape[0]), dtype=d_t.dtype)
    return out.index_add_(0, idx.long().cpu(), d_t.cpu().T)


def check_kernel_parity(
    log2_slots: int = 15,
    n_occ: int = 1 << 17,
    k: int = 11,
    batch: int = 4096,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Returns {"ok": bool, "checks": {name: max_rel_err}, "backend": str,
    "rel_floor": {row-sum check: its relative error over the 1e-2 floor}}
    (the backend is "cuda" or "cpu", the device the ops ran on; the lab's
    row-sum check is a share of the float32 reorder bound)."""
    from xflow_tpu_torch.config import FTRLConfig
    from xflow_tpu_torch.ops import lab
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim.ftrl import update_one

    dev = torch.device(device)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rng = np.random.default_rng(seed)
    S = 1 << log2_slots
    nnz = n_occ // batch
    slots = rng.integers(0, S, (batch, nnz)).astype(np.int32)
    mask = (rng.random((batch, nnz)) < 0.9).astype(np.float32)
    table = rng.standard_normal((S, k)).astype(np.float32)
    # the full f32 mantissa and exponent range: magnitudes over e^-8..e^8
    table *= np.exp(rng.uniform(-8, 8, (S, 1))).astype(np.float32)
    plan = st.plan_sorted_batch(slots, mask, S)
    Np = plan.sorted_slots.shape[0]
    checks: dict[str, float] = {}

    tbl, ss, wo = on(table), on(plan.sorted_slots), on(plan.win_off)
    # --- gather (#1): bit-exact against index_select
    want = _gather_oracle(tbl, ss)
    checks["gather_exact"] = rel_err(st.table_gather_sorted(tbl, ss, wo, False), want)
    # --- gather, bf16 opt-in: a rounding trade, not a routing bug
    checks["gather_bf16"] = rel_err(st.table_gather_sorted(tbl, ss, wo, True), want)

    # --- scatter (#4, the gather's VJP) against index_add_
    d_occ = rng.standard_normal((st._k8(k), Np)).astype(np.float32)
    d_occ *= plan.sorted_mask[None, :]
    t_d = on(d_occ)
    checks["scatter_exact"] = rel_err(st.scatter_sorted(t_d, ss, wo, S, k, False),
                                       _sum_oracle(t_d[:k], ss, S), FLOORS["scatter_exact"])

    # --- multi-buffer gather/scatter (#5, #6): the sorted stream split in
    # two, each buffer padded to a fixed capacity with slot S-1 (each half
    # of a sorted stream is itself sorted)
    cap = ((Np // 2) // st.CHUNK + 1) * st.CHUNK
    split = (Np // 2 // st.CHUNK) * st.CHUNK
    bufs, offs = [], []
    for part in (plan.sorted_slots[:split], plan.sorted_slots[split:]):
        buf = np.concatenate([part.astype(np.int32), np.full(cap - part.size, S - 1, np.int32)])
        off = np.searchsorted(buf, np.arange(0, S + 1, st.WINDOW)).astype(np.int32)
        off[-1] = cap  # pads ride in the last window
        bufs.append(buf)
        offs.append(off)
    mslots, moff = on(np.concatenate(bufs)), on(np.stack(offs))
    got_m = st.table_gather_sorted_multi(tbl, mslots, moff, False)
    checks["gather_multi_exact"] = rel_err(got_m, _gather_oracle(tbl, mslots))
    d_m = on(rng.standard_normal(tuple(got_m.shape)).astype(np.float32))
    checks["scatter_multi_exact"] = rel_err(
        st.scatter_sorted_multi(d_m, mslots, moff, S, k, False), _sum_oracle(d_m[:k], mslots, S),
        FLOORS["scatter_multi_exact"])

    # --- the aligned row width (K8 == K): no pad rows in the gather's
    # output or the scatter's cotangent (FFM/MVM widths like 96 or 128)
    k_al = 16
    tbl_al = on(rng.standard_normal((S, k_al)).astype(np.float32))
    got_al = st.table_gather_sorted(tbl_al, ss, wo, False)
    checks["gather_aligned_k"] = rel_err(got_al, _gather_oracle(tbl_al, ss))
    d_al = on(rng.standard_normal(tuple(got_al.shape)).astype(np.float32)
              * plan.sorted_mask[None, :])
    checks["scatter_aligned_k"] = rel_err(st.scatter_sorted(d_al, ss, wo, S, k_al, False),
                                           _sum_oracle(d_al, ss, S), FLOORS["scatter_aligned_k"])

    # --- fused scatter+FTRL (#3) against the two-pass composition. The
    # upper half of the table gets no gradient (its occurrences' d columns
    # zeroed) and zero n and z, so without the lazy-init guard the closed
    # form would zero those w's
    hp = FTRLConfig()
    w0 = rng.standard_normal((S, k)).astype(np.float32) * 0.01
    n0 = np.abs(rng.standard_normal((S, k))).astype(np.float32) * 0.1
    z0 = rng.standard_normal((S, k)).astype(np.float32) * 1e-4
    n0[S // 2:] = 0.0
    z0[S // 2:] = 0.0
    d_f = on(rng.standard_normal((st._k8(k), Np)).astype(np.float32)
             * plan.sorted_mask[None, :] * (plan.sorted_slots < S // 2)[None, :])
    w0, n0, z0 = on(w0), on(n0), on(z0)
    got_f = st.scatter_ftrl_sorted(d_f, ss, wo, w0, n0, z0, k, hp, False)
    want_f = update_one(w0.cpu(), n0.cpu(), z0.cpu(), _sum_oracle(d_f[:k], ss, S), hp.alpha,
                        hp.beta, hp.lambda1, hp.lambda2)
    for i, name in enumerate(("scatter_ftrl_w", "scatter_ftrl_n", "scatter_ftrl_z")):
        checks[name] = rel_err(got_f[i], want_f[i], FLOORS[name])

    # --- row sums: #2 (the FM forward's occurrence -> row reduction)
    # bitwise, and the lab's #11 on the same channels as a share of the
    # reorder bound
    ch = 24
    vals_t = on(rng.standard_normal((ch, Np)).astype(np.float32) * plan.sorted_mask[None, :])
    rows = on(plan.sorted_row)
    want_r = _sum_oracle(vals_t, rows, batch)
    got_r = st.row_sums_sorted(vals_t, rows, batch)
    checks["rowsum_bitwise"] = float(
        (got_r.cpu().view(torch.int32) != want_r.view(torch.int32)).sum())
    checks["rowsum"] = rel_err(got_r, want_r, FLOORS["rowsum"])
    got_l = lab.lab_rowsum(vals_t, rows, batch)
    checks["lab_rowsum"] = reorder_err(got_l, want_r, vals_t, rows, batch)
    rel_floor = {"rowsum": checks["rowsum"],
                 "lab_rowsum": rel_err(got_l, want_r, FLOORS["lab_rowsum"])}

    ok = all(checks[name] <= tol for name, tol in TOLERANCES.items())
    return {"ok": ok, "checks": checks, "backend": dev.type, "rel_floor": rel_floor}


def main() -> int:
    if not torch.cuda.is_available():
        # the checks would hold the plain versions against the oracles and
        # no kernel would run: "ok" here would be a false all-clear
        print("kernel_parity: no CUDA device: the kernels were never executed", file=sys.stderr)
        print(json.dumps({"ok": False, "checks": {}, "backend": "cpu",
                          "error": "no CUDA device"}))
        return 2
    res = check_kernel_parity()
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
