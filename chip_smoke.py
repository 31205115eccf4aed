#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit as nvidia-smi reports them;
2. build every CUDA kernel from `xflow_tpu_torch/csrc/` (one nvcc per
   source, started together);
3. write the inputs from a seed at the FM headline's full width (fused
   `wv [2^22, 11]`, 18 fields, 65,536-row batches): a committed full
   training checkpoint (tables, FTRL n and z with the upper half of the
   slots never touched) and a libffm shard of 2 x 65,536 rows;
4. inference kernels on the evaluate path's own inputs (the first
   batch's plan and gathered rows): the gather bit-exact with bf16 off
   and on, the row sum within 1e-4 relative over a 1e-2 floor
   (|got - want| <= 1e-4 * (|want| + 1e-2): float reductions reorder the
   sum), with its time, its plain version's, `zeros` + `index_add_`'s and
   its bound (`check_row_sums`, as at every width below);
5. training kernels on the training path's own inputs (the first batch's
   plan and the occurrence cotangent the fused step's backward produces
   on the restored state), bf16 off and on: the scatter bitwise equal to
   its plain version on the CPU and across two launches; the fused
   scatter+FTRL within 1e-3 over 1e-4 for w, n and z, within 1e-3 over a
   floor of 1e-2 of its largest magnitude for the gradient z' implies,
   and the new w within 1e-3 of the FTRL rule on (z', n') (the gradient
   is far under the fixed floor; see `ftrl_errs`), and w of
   never-touched slots bitwise kept. Then one fused train step from that
   state on the card and on the CPU: loss within 1e-5 relative, w, n, z
   as for the fused kernel. For every kernel, CUDA-event times of the
   kernel, its plain version and one PyTorch library call (or
   composition) computing the same function; for the scatter also
   `torch.zeros((S, K))` (`zeros_ms`), the dense write any scatter into a
   fresh output pays;
6. the evaluate path: `evaluate` over the shard on the card, the first
   batch's pCTRs against the CPU's, `predict_rows` against evaluate;
7. the training main path: `python -m xflow_tpu_torch train` (in
   process) on the card, 2 epochs over the shard (4 fused steps); then
   one epoch of the two-pass step (`optim.fused_scatter=off`). Each run
   has the launch counts set to 0 just before and read just after, and
   each kernel of its path must have launched. Then the default model:
   `train` with no `--model` (LR, `w [2^22]`, row-major, FTRL), 2 epochs
   (4 steps), every kernel's launch count 0 (LR runs none), and one step
   from its checkpoint on the card against the CPU (`run_lr`);
8. train -> serve: the trained checkpoint loads in `ServeRunner` at the
   trained step and evaluates to a finite AUC above 0.5 on its own
   training shard; one more fused step from that checkpoint on the card
   and on the CPU agrees as in phase 5 (at the default FTRL
   hyperparameters and 65,536-row batches nearly every trained w stays
   0, so the end-to-end checks alone would pass a wrong w);
9. where the time goes: host clock per stage of an evaluate batch and of
   a train step, CUDA-event times of the forward and of the step (with
   the non-finite guard on and off), and the step's device busy time by
   `torch.profiler`;
10. MVM at bench.py's full width (`v [2^22, 10]`, 18 fields, 65,536-row
   batches), on a committed step-1 MVM checkpoint (v ~ N(0, 0.5²), FTRL
   n and z on the lower half) and the same shard's first batch, parsed
   once. The multi-buffer kernels on the segment row side's own inputs
   (the NS = 4 stacked plan, and the occurrence cotangent of the
   segment step's backward on the restored state), bf16 off and on: the
   gather bit-exact against its plain version, the scatter bitwise
   equal to its plain version on the CPU and across two launches; with
   their times, and the single-stream gather's time on the same
   flattened stream. The single-stream kernels on the product row side's
   own inputs (its flat plan, the plus-one form's log-space channels at
   ch = 32, and the fused step's occurrence cotangent), checked and timed
   as in phases 4 and 5, and the product step's time fused and two-pass. Then
   the scatters on a skewed plan at the same S and Np (one slot in every
   row's first field: a run of 65,536, over the 4 stacked buffers for the
   multi-buffer one), bitwise against the CPU plain version and across two
   launches, with their times (`hot_ms`, not a target). Then one product
   step (two-pass and fused) and one segment step on the card and on the
   CPU, plain and plus-one factor forms, as in phase 5;
11. the MVM main paths through `python -m xflow_tpu_torch train --model
   mvm` with `model.mvm_plus_one=true`: the product row side (2 epochs,
   two-pass: gather, row sums, scatter), one fused epoch
   (`optim.fused_scatter=on`: scatter+FTRL) and the segment row side
   (`model.mvm_exclusive=off`, 2 epochs: the multi-buffer gather and
   scatter once a step each, never the single-stream pair), each with
   the launch counts set to 0 just before and read just after; then
   evaluate on the segment checkpoint (the multi-buffer gather forward),
   `predict_rows` (row-major) against it, and the segment step's stage
   breakdown;
12. the Hopper lab and the wide row sums: (a) the row sum at ch = 104,
   128 and 136 (FM's row side at v_dim 50, 63 and 64: four and five
   channel groups) against its plain version on the first batch's plan,
   timed as in phase 4, and one FM forward at v_dim = 64 on the card
   against the CPU, pCTRs within 1e-5; (b) `bench_lab --suite mosaic`
   (kernels #7-#10 at the probe's own shapes, `off` from the seed, each
   bitwise against its plain version and its numpy slice, and the TMA
   encode of each shape's plain tensor map: B and C must encode; each
   probe's time is its device time by `torch.profiler`, with the CUDA
   events' figure around back-to-back calls, the host's dispatch, beside
   it as `host_ms`) and `--suite rowsum` at the JAX shapes (#11 within the float32 reorder
   bound of its plain version and of `np.add.at`), in process with the
   lab's launch counts set to 0 just before and read just after: each of
   #7-#11 must have launched; (c) `kernel_parity.check_kernel_parity()`
   on the card, every check within its tolerance; (d) `--suite core` at
   its defaults (S = 2^22, N = 2^21, K = 11: 3 cells) into the temporary
   directory, then `micro`, `layout` and `scatter` once each at the JAX
   shapes. Each suite's output is echoed as comments.

The last three lines of standard output: the card line, the kernels
JSON (each entry with `share_of_bound` = bound_ms / ms; the row sum's
`widths` hold its entry at each of ch 24, 32, 104, 128 and 136), and
``{"ok": true, "device": {...}}``. Without a CUDA device, or
run outside a checkout of the repository, it fails before printing any.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

LOG2_SLOTS, V_DIM, NUM_FIELDS, BATCH = 22, 10, 18, 65536
SHARD_ROWS = 2 * BATCH
IDS_PER_FIELD = 200_000  # bench.py's end-to-end FM data
SEED = 0
DEVICE = "cuda"
RTOL, FLOOR = 1e-4, 1e-2  # gather / row sum / scatter (kernel_parity's reductions)
FTRL_RTOL, FTRL_FLOOR = 1e-3, 1e-4  # kernel_parity's scatter_ftrl_*
LOSS_RTOL = 1e-5
PCTR_ATOL = 1e-5
FTRL_OPS_PER_ELEMENT = 16  # update_one's float ops, sqrt and division as one each
HOT_SLOT = 12345  # the skewed plan's hot slot (check_hot_scatters)
# the restored MVM state's init scale: at 18 fields it keeps both factor
# forms' gradients, and their squares in n, in float32's normal range
MVM_V_SCALE = 0.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of fn() over `reps` launches, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want, floor: float) -> float:
    """Max of |got - want| / (|want| + floor), elementwise."""
    return ((got - want).abs() / (want.abs() + floor)).max().item()


def ftrl_errs(got, want, prev, hp, what: str, leaves: bool = True) -> dict:
    """Errors of an FTRL step's (w', n', z') against a reference, from the
    pre-step (w, n, z); all must be within FTRL_RTOL (with `leaves`
    False, the three leaf errors are reported and only `g` and `w_rule`
    must be: where the gradient is large, n' moves, and each side's own
    sqrt of it moves z' by an ulp of √n over alpha times w, up to 1e-6
    at |w| near 1, which is no error of g and far over the fixed floor).
    Each leaf over the fixed FTRL_FLOOR; but the gradient of a mean over
    65,536 rows is about 1e-5 a slot, far under that floor, and n moves
    by g², which no f32 n near 0.1 holds, so n is no witness of g. Two
    more checks are:

    - `g`: the gradient each side's z' implies, z' - z + (√n' - √n) /
      alpha * w, over a floor of 1e-2 of its largest magnitude. Each
      side's own n' and own device's sqrt enter: where g² is far under
      an ulp of n, √n' - √n is 0 or an ulp of √n, so a last bit of n'
      or of sqrt (torch's CPU sqrt is not always correctly rounded)
      moves z' by an ulp of √n over alpha times w, which is no error of
      g and cancels here. z' - z holds g only to half an ulp of z' on
      each side (7e-12 an ulp at |z| near 1e-4), so the two sides'
      implied g may differ by one ulp of the larger of |z|, |z'| with no
      error of g: that much of each difference is not counted. It
      matters where g is near an ulp of z (MVM's plain factor form gives
      gradients of 1e-12..1e-8 at 18 fields);
    - `w_rule`: the new w against the FTRL rule on the same side's own
      (z', n'), with the lazy-init guard, over 1e-2 of the largest |w|
      the rule gives off the guard. The table may be FM's `wv` or MVM's
      `v`."""
    import torch

    from xflow_tpu_torch.optim.ftrl import weight_of

    errs = {name: rel_err(a.to(b.device), b, FTRL_FLOOR) for name, a, b in zip("wnz", got, want)}

    def implied_g(out):
        w, n, z = (p.to(out[2].device) for p in prev)
        return (out[2] - z) + (torch.sqrt(out[1]) - torch.sqrt(n)) / hp.alpha * w

    g_want = implied_g(want)
    scale = g_want.abs().max().item()
    if not scale > 0:
        fail(f"{what}: the FTRL step moved no z: the gradient is all zero")
    g_got = implied_g(got).to(g_want.device)
    mag = torch.maximum(want[2].abs(), prev[2].to(g_want.device).abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    g_err = ((g_got - g_want).abs() - ulp).clamp(min=0) / (g_want.abs() + 1e-2 * scale)
    errs["g"] = g_err.max().item()
    if not errs["g"] <= FTRL_RTOL:
        i = int(g_err.argmax())
        at = lambda t: t.reshape(-1)[i].item()  # noqa: E731
        fail(f"{what}: g err {errs['g']} at flat index {i}: implied g {at(g_got)} vs "
             f"{at(g_want)} (floor {1e-2 * scale}, ulp of z {at(ulp)}), z {at(prev[2])}, "
             f"z' {at(got[2])} vs {at(want[2])}, n {at(prev[1])}, n' {at(got[1])} vs "
             f"{at(want[1])}, w {at(prev[0])}")
    w_new, n_new, z_new = got
    w, n, z = (p.to(w_new.device) for p in prev)
    # the lazy-init guard ran where the step left n = 0 and z as they were
    # (a gradient whose square underflows leaves n' = 0 but moves z)
    lazy = (n == 0) & (n_new == 0) & (z_new == z)
    rule = weight_of(z_new, n_new, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)
    floor = max(1e-2 * rule[~lazy].abs().max().item(), 1e-30)
    errs["w_rule"] = rel_err(w_new, torch.where(lazy, w, rule), floor)
    gated = errs if leaves else {k: errs[k] for k in ("g", "w_rule")}
    if not all(e <= FTRL_RTOL for e in gated.values()):
        fail(f"{what}: {errs} beyond {FTRL_RTOL} relative")
    return errs


def check_row_sums(vals, rows, what: str) -> dict:
    """#2 on one path's channels `vals [ch, Np]` and rows against its plain
    version (within RTOL over FLOOR), with the times of the kernel, its
    plain version and `zeros` + `index_add_` on the same inputs, and its
    bound: vals and rows read once, the [B, ch] sums written once."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    ch = vals.shape[0]
    got, want = st.row_sums_cuda(vals, rows, BATCH), st.row_sums_plain(vals, rows, BATCH)
    torch.cuda.synchronize()
    rel = rel_err(got, want, FLOOR)
    if not rel <= RTOL:
        fail(f"row_sums {what} at ch = {ch} differs from its plain version: {rel} > {RTOL} "
             f"(over a {FLOOR} floor)")
    rows_l = rows.long()
    out = {
        "ch": ch, "rel_err": rel, "max_abs_err": (got - want).abs().max().item(),
        "ms": cuda_ms(lambda: st.row_sums_cuda(vals, rows, BATCH)),
        "plain_ms": cuda_ms(lambda: st.row_sums_plain(vals, rows, BATCH)),
        "library_ms": cuda_ms(
            lambda: torch.zeros((BATCH, ch), device=DEVICE).index_add_(0, rows_l, vals.T)),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(
        vals.numel() * 4 + rows.numel() * rows.element_size() + BATCH * ch * 4, vals.numel())
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    print(f"# row_sums {what} at ch = {ch}: max err {rel:.3g} relative over a {FLOOR} floor "
          f"(tolerance {RTOL}); {out['ms']:.4f} ms, plain {out['plain_ms']:.4f}, zeros + "
          f"index_add_ {out['library_ms']:.4f}, bound {out['bound_ms']:.4f} "
          f"({out['share_of_bound']:.0%})", flush=True)
    return out


def gather_bytes(sorted_slots, K: int, K8: int) -> float:
    """Bytes the gather must move for this plan: each slot read once, the
    32 B sectors that hold the distinct rows it touches, the output
    written once."""
    import torch

    u = torch.unique(sorted_slots.long())
    first = (u * K * 4) // 32
    last = (u * K * 4 + K * 4 - 1) // 32
    sectors = torch.cat([first + d for d in range(3)])
    keep = torch.cat([first + d <= last for d in range(3)])
    n_sectors = torch.unique(sectors[keep]).numel()
    np_ = sorted_slots.numel()
    return np_ * 4 + n_sectors * 32 + K8 * np_ * 4


def write_state(ck_dir: str, name: str, K: int, scale: float, seed: int) -> int:
    """A committed step-1 training checkpoint of one [2^22, K] table ~
    N(0, scale²), with FTRL state as a run that has touched the lower
    half of the slots: the upper half keeps n = z = 0, so the lazy-init
    guard runs there. Returns its bytes."""
    import numpy as np

    from xflow_tpu_torch.train.checkpoint import save_state

    rng = np.random.default_rng(seed)
    S = 1 << LOG2_SLOTS
    t = rng.standard_normal((S, K), dtype=np.float32) * np.float32(scale)
    n = np.abs(rng.standard_normal((S, K), dtype=np.float32)) * np.float32(0.1)
    z = rng.standard_normal((S, K), dtype=np.float32) * np.float32(1e-4)
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    save_state(ck_dir, {name: t}, {name: {"n": n, "z": z}}, step=1)
    return 3 * t.nbytes


def make_inputs(work: str, cfg):
    """The full training checkpoint (step 1) and the shard `<work>/data-00000`."""
    from xflow_tpu_torch.data.synth import generate_shards

    t0 = time.perf_counter()
    nbytes = write_state(cfg.train.checkpoint_dir, "wv", 1 + V_DIM, 0.05, SEED)
    t_ck = time.perf_counter() - t0
    t0 = time.perf_counter()
    (path,) = generate_shards(
        os.path.join(work, "data"), 1, SHARD_ROWS, num_fields=NUM_FIELDS,
        ids_per_field=IDS_PER_FIELD, seed=SEED,
    )
    print(f"# inputs: checkpoint {nbytes / 1e6:.1f} MB in {t_ck:.1f} s, "
          f"shard {os.path.getsize(path) / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return path


def first_arrays(cfg, path, device):
    from xflow_tpu_torch.data.libffm import iter_batches
    from xflow_tpu_torch.evaluate import batch_arrays, to_device

    batch = next(iter_batches(path, cfg.data))
    host = batch_arrays(batch, cfg)
    return host, to_device(host, device)


def check_kernels(cfg, gen, path) -> list:
    """The inference kernels against their plain versions on the
    evaluate path's inputs."""
    import torch

    from xflow_tpu_torch.models.fm import stack_channels
    from xflow_tpu_torch.ops import sorted_table as st

    _, arrays = first_arrays(cfg, path, DEVICE)
    table = gen.tables["wv"]
    ss = arrays["sorted_slots"]
    S, K = table.shape
    K8, np_ = st._k8(K), ss.numel()
    if np_ != st.padded_len(BATCH * NUM_FIELDS):
        fail(f"plan length {np_} is not the full-width {st.padded_len(BATCH * NUM_FIELDS)}")

    results = []
    # --- gather (bit-exact, bf16 off and on)
    for bf16 in (False, True):
        got = st.gather_sorted_cuda(table, ss, bf16)
        want = st.gather_sorted_plain(table, ss, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_sorted (bf16={bf16}) differs from its plain version: "
                 f"max abs err {(got - want).abs().max().item()}")
        print(f"# gather_sorted bf16={bf16}: bit-exact over {tuple(got.shape)}", flush=True)
    occ_t = st.gather_sorted_cuda(table, ss)
    g_err = (occ_t - st.gather_sorted_plain(table, ss)).abs().max().item()
    g_ms = cuda_ms(lambda: st.gather_sorted_cuda(table, ss))
    g_plain = cuda_ms(lambda: st.gather_sorted_plain(table, ss))
    g_lib = cuda_ms(lambda: torch.index_select(table, 0, ss).T.contiguous())
    g_bound, g_by = bound_ms(gather_bytes(ss, K, K8), 0.0)
    results.append({
        "name": "gather_sorted", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/gather_sorted.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:775",
        "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib,
    })

    # --- row sum on the main path's stacked channels
    rows = st.wire_rows(arrays["sorted_row"])
    mask = st.wire_mask(arrays["sorted_mask"])
    vals = stack_channels(occ_t[:K] * mask[None, :], K).contiguous()
    rs = check_row_sums(vals, rows, "on the FM evaluate path's channels")
    results.append({
        "name": "row_sums", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/row_sums.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:1162",
        **{key: rs[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "widths": {rs["ch"]: rs},
    })
    return results


def restored_state(cfg, device):
    """The step-1 training checkpoint as a TrainState on `device`."""
    import torch

    from xflow_tpu_torch.train.checkpoint import restore_state
    from xflow_tpu_torch.train.state import TrainState
    from xflow_tpu_torch.weights import table_shapes

    tables, opt, step = restore_state(cfg.train.checkpoint_dir, table_shapes(cfg), ("n", "z"))
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return TrainState(
        {k: put(v) for k, v in tables.items()},
        {k: {leaf: put(v) for leaf, v in d.items()} for k, d in opt.items()},
        step,
    )


def check_train_kernels(cfg, path) -> list:
    """The training kernels against their plain versions on the training
    path's inputs, and one fused step on the card against the CPU's."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim.ftrl import update_one
    from xflow_tpu_torch.train.step import fused_cotangent

    state = restored_state(cfg, DEVICE)
    host, arrays = first_arrays(cfg, path, DEVICE)
    w, n, z = state.tables["wv"], state.opt_state["wv"]["n"], state.opt_state["wv"]["z"]
    ss, wo = arrays["sorted_slots"], arrays["win_off"]
    S, K = w.shape
    np_ = ss.numel()
    _, d_occ = fused_cotangent(w, arrays, cfg)
    hp = cfg.optim.ftrl
    results = []

    # --- scatter (#4): the gather's VJP. The plain version on the CPU sums
    # each slot's run in plan order, as the kernel does, so the two agree
    # bit for bit (on the card the plain version's atomics reorder sums).
    d_cpu, ss_cpu = d_occ.cpu(), ss.cpu()
    for bf16 in (False, True):
        got = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        again = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, K, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"scatter_sorted (bf16={bf16}) gave different bits on two launches")
        got = got.cpu()
        if not torch.equal(got, want):
            fail(f"scatter_sorted (bf16={bf16}) differs from its plain version on the CPU: "
                 f"max abs err {(got - want).abs().max().item()} "
                 f"(largest |want| {want.abs().max().item()})")
        print(f"# scatter_sorted bf16={bf16}: bit-exact against the CPU plain version and "
              f"across two launches, over {tuple(got.shape)} "
              f"(largest |g| {want.abs().max().item():.3g})", flush=True)
        if not bf16:
            s_err = (got - want).abs().max().item()
    s_ms = cuda_ms(lambda: st.scatter_sorted_cuda(d_occ, ss, wo, S, K))
    s_plain = cuda_ms(lambda: st.scatter_sorted_plain(d_occ, ss, S, K))
    ss_l = ss.long()
    s_lib = cuda_ms(lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T))
    s_zeros = cuda_ms(lambda: torch.zeros((S, K), device=DEVICE))  # the write floor
    s_bound, s_by = bound_ms(S * K * 4 + K * np_ * 4 + np_ * 4 + wo.numel() * 4, K * np_)
    print(f"# scatter_sorted {s_ms:.4f} ms, zeros + index_add_ {s_lib:.4f} ms, zeros "
          f"{s_zeros:.4f} ms, bound {s_bound:.4f} ms", flush=True)
    results.append({
        "name": "scatter_sorted", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/scatter_sorted.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:938",
        "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain,
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": s_lib, "zeros_ms": s_zeros,
    })

    # --- fused scatter + FTRL (#3)
    for bf16 in (False, True):
        got = st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp, bf16)
        want = st.scatter_ftrl_plain(d_occ, ss, w, n, z, K, hp, bf16)
        g = st.scatter_sorted_plain(d_occ, ss, S, K, bf16)
        torch.cuda.synchronize()
        errs = ftrl_errs(got, want, (w, n, z), hp,
                         f"scatter_ftrl (bf16={bf16}) against its plain version")
        lazy = (g == 0) & (n == 0)
        n_lazy = int(lazy.sum())
        if n_lazy == 0 or not torch.equal(got[0][lazy], w[lazy]):
            fail(f"scatter_ftrl (bf16={bf16}) did not keep w of the {n_lazy} "
                 "never-touched (slot, channel) entries bitwise")
        print(f"# scatter_ftrl bf16={bf16}: max err {errs} relative (w, n, z over a "
              f"{FTRL_FLOOR} floor; g, w_rule over 1e-2 of their largest magnitude) "
              f"(tolerance {FTRL_RTOL}); w kept bitwise on {n_lazy} lazy-init entries", flush=True)
        if not bf16:
            f_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    f_ms = cuda_ms(lambda: st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp))
    f_plain = cuda_ms(lambda: st.scatter_ftrl_plain(d_occ, ss, w, n, z, K, hp))

    def composition():
        g = torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T)
        return update_one(w, n, z, g, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)

    f_lib = cuda_ms(composition)
    f_bound, f_by = bound_ms(
        6 * S * K * 4 + K * np_ * 4 + np_ * 4 + wo.numel() * 4,
        K * np_ + FTRL_OPS_PER_ELEMENT * S * K,
    )
    results.append({
        "name": "scatter_ftrl", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/scatter_ftrl.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:1064",
        "max_abs_err": f_err, "ms": f_ms, "plain_ms": f_plain,
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib,
    })
    print(f"# scatter_ftrl library_ms is a composition (index_add_ + the torch FTRL "
          f"expression): {f_lib:.4f} ms", flush=True)
    step_card_vs_cpu(cfg, host, "fused", "the restored step-1 state")
    return results


def step_card_vs_cpu(cfg, host: dict, kind: str, what: str, leaves: bool = True) -> None:
    """One train step on the host arrays `host` from the checkpoint under
    cfg.train.checkpoint_dir, on the card and on the CPU: the loss within
    LOSS_RTOL, the table's (w, n, z) by `ftrl_errs` (`leaves` as there)."""
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.step import make_train_step

    model = get_model(cfg.model.name)(cfg)
    (tname,) = model.table_specs(cfg)  # "wv" (fused FM), "v" (MVM) or "w" (LR)
    step = make_train_step(model, get_optimizer("ftrl"), cfg)
    s_gpu, m_gpu = step(restored_state(cfg, DEVICE), to_device(host, DEVICE))
    prev = restored_state(cfg, "cpu")
    s_cpu, m_cpu = step(prev, to_device(host, "cpu"))
    lg, lc = m_gpu["loss"].item(), m_cpu["loss"].item()
    if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
        fail(f"{kind} step from {what}: loss on the card {lg} vs the CPU {lc}, beyond "
             f"{LOSS_RTOL} relative")

    def state_leaves(s):
        return s.tables[tname], s.opt_state[tname]["n"], s.opt_state[tname]["z"]

    if not m_gpu["update_ok"]:
        fail(f"{kind} step from {what} on the card: update_ok is false")
    errs = ftrl_errs(state_leaves(s_gpu), state_leaves(s_cpu), state_leaves(prev),
                     cfg.optim.ftrl, f"{kind} step from {what}, card vs CPU", leaves)
    trained = s_cpu.tables[tname][s_cpu.opt_state[tname]["n"] > 0]
    print(f"# {kind} step from {what}, card vs CPU: loss {lg} vs {lc}; max err {errs}; "
          f"w' of the {trained.numel()} trained entries (n' > 0): "
          f"{int((trained != 0).sum())} nonzero, largest |w'| "
          f"{trained.abs().max().item():.3g}", flush=True)


def first_batch(cfg, tables, path, device):
    from xflow_tpu_torch.evaluate import predict_batches

    it = predict_batches(cfg, tables, path, device)
    try:
        return next(it)
    finally:
        it.close()


def run_slice(cfg, gen, path) -> dict:
    """The evaluate path on the card, with the launch counts around it."""
    import numpy as np
    import torch

    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.serve.runner import ServeRunner

    st.reset_launches()
    t0 = time.perf_counter()
    auc, ll = evaluate(cfg, gen.tables, path, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    n_batches = -(-SHARD_ROWS // BATCH)
    for name in ("gather_sorted", "row_sums"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the evaluate path ({launches})")
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.0 <= auc <= 1.0 and ll < 0.0):
        fail(f"evaluate gave auc={auc} logloss={ll}")
    # the weights are random, so an AUC near 0.5 is what a right path gives
    print(f"# evaluate on cuda: auc={auc} logloss={ll} over {n_batches} batches, "
          f"{wall / n_batches * 1e3:.1f} ms per batch end to end (host parse + plan + "
          f"forward); launches {launches}", flush=True)

    # first batch: the card against the CPU
    _, p_gpu = first_batch(cfg, gen.tables, path, DEVICE)
    cpu_gen = ServeRunner(cfg, device="cpu").load()
    _, p_cpu = first_batch(cfg, cpu_gen.tables, path, "cpu")
    if p_gpu.shape != (BATCH,) or not np.all(np.isfinite(p_gpu)):
        fail(f"pctr shape {p_gpu.shape} or non-finite values")
    d = float(np.abs(p_gpu - p_cpu).max())
    if not d <= PCTR_ATOL:
        fail(f"first batch: cuda and cpu pctrs differ by {d} > {PCTR_ATOL}")
    print(f"# first batch: cuda vs cpu pctr max abs diff {d}", flush=True)

    # serve == evaluate on 8 rows of the shard
    with open(path) as f:
        rows = [next(f).split("\t", 1)[1].strip() for _ in range(8)]
    runner = ServeRunner(cfg, device=DEVICE)
    runner.load()
    served, sgen = runner.predict_rows(rows)
    ds = float(np.abs(served - p_gpu[:8]).max())
    if not ds <= PCTR_ATOL:
        fail(f"predict_rows differs from evaluate by {ds} > {PCTR_ATOL}")
    print(f"# predict_rows on 8 rows (step {sgen.step}) vs evaluate: max abs diff {ds}",
          flush=True)

    stage_breakdown(cfg, gen, path)
    return launches


def stage_breakdown(cfg, gen, path) -> None:
    """Where an evaluate batch's time goes: host clock per stage over the
    shard (each device stage ends in a synchronize), and the forward's
    CUDA-event time on one resident batch."""
    import torch

    from xflow_tpu_torch.data.libffm import iter_batches
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.models.predict import make_predict_fn

    step = make_predict_fn(get_model(cfg.model.name)(cfg))
    acc = dict.fromkeys(("parse", "plan", "to_device", "forward", "to_host"), 0.0)
    n = 0
    pc = time.perf_counter
    it = iter_batches(path, cfg.data)
    while True:
        t = pc()
        batch = next(it, None)
        acc["parse"] += pc() - t
        if batch is None:
            break
        t = pc()
        host = batch_arrays(batch, cfg)
        acc["plan"] += pc() - t
        t = pc()
        arrays = to_device(host, DEVICE)
        torch.cuda.synchronize()
        acc["to_device"] += pc() - t
        t = pc()
        p = step(gen.tables, arrays)
        torch.cuda.synchronize()
        acc["forward"] += pc() - t
        t = pc()
        p.cpu().numpy()
        acc["to_host"] += pc() - t
        n += 1
    print("# evaluate stages, ms per batch (host clock): "
          + ", ".join(f"{k} {v / n * 1e3:.3f}" for k, v in acc.items()), flush=True)
    fwd_ms = cuda_ms(lambda: step(gen.tables, arrays), reps=10)
    print(f"# forward on the card (CUDA events): {fwd_ms:.3f} ms per {BATCH}-row batch",
          flush=True)


def train_cli(prefix: str, ckpt_dir: str, epochs: int, *extra: str,
              model: str | None = "fm") -> tuple[dict, dict]:
    """`python -m xflow_tpu_torch train` in process on the card (`model`
    None: no `--model`, the CLI's default), with the launch counts set to
    0 just before and read just after. Returns (summary, launches); the
    CLI's own stdout is echoed as comments."""
    import torch

    from xflow_tpu_torch.__main__ import main as cli
    from xflow_tpu_torch.ops import sorted_table as st

    argv = [
        "train", "--train", prefix, *(("--model", model) if model else ()),
        "--epochs", str(epochs),
        "--batch-size", str(BATCH), "--log2-slots", str(LOG2_SLOTS),
        "--checkpoint-dir", ckpt_dir, "--device", DEVICE,
        "--set", f"model.v_dim={V_DIM}", "--set", f"model.num_fields={NUM_FIELDS}",
        "--set", f"data.max_nnz={NUM_FIELDS}", "--set", "train.log_every=1", *extra,
    ]
    out = io.StringIO()
    st.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    for line in out.getvalue().splitlines():
        print(f"#   {line}")
    if rc != 0:
        fail(f"train {' '.join(extra)} exited {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"# train --model {model or '(the default)'} {' '.join(extra)}: {wall:.1f} s wall, "
          f"launches {launches}", flush=True)
    return summary, launches


def run_training(cfg, work: str, path: str) -> tuple[dict, dict]:
    """The training main path, the two-pass epoch, and train -> serve."""
    import math

    import numpy as np

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.serve.runner import ServeRunner

    prefix = path[: -len("-00000")]
    n_batches = -(-SHARD_ROWS // BATCH)
    ck = os.path.join(work, "ck_train")
    summary, launches = train_cli(prefix, ck, 2)
    want_steps = 2 * n_batches
    if (summary["steps"], summary["epochs"], summary["examples"], summary["bad_steps"]) != (
        want_steps, 2, 2 * SHARD_ROWS, 0
    ) or not math.isfinite(summary["last_loss"]):
        fail(f"train summary {summary}: expected {want_steps} steps over 2 epochs, "
             "no bad step, a finite loss")
    for name in ("gather_sorted", "row_sums", "scatter_ftrl"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the training main path ({launches})")
    if launches["scatter_sorted"]:
        fail(f"the fused training path launched the two-pass scatter ({launches})")

    _, two_pass = train_cli(prefix, os.path.join(work, "ck_two_pass"), 1,
                            "--set", "optim.fused_scatter=off")
    for name in ("gather_sorted", "row_sums", "scatter_sorted"):
        if two_pass[name] < 1:
            fail(f"kernel {name} was not launched on the two-pass path ({two_pass})")
    if two_pass["scatter_ftrl"]:
        fail(f"the two-pass path launched the fused kernel ({two_pass})")

    tcfg = override(cfg, **{"train.checkpoint_dir": ck})
    gen = ServeRunner(tcfg, device=DEVICE).load()
    if gen.step != want_steps:
        fail(f"the trained checkpoint serves step {gen.step}, expected {want_steps}")
    auc, ll = evaluate(tcfg, gen.tables, path, device=DEVICE)
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.5 < auc <= 1.0):
        fail(f"the trained model evaluates to auc={auc} logloss={ll} on its training shard")
    print(f"# train -> serve: step {gen.step}, auc={auc} logloss={ll} on the training shard",
          flush=True)
    step_card_vs_cpu(tcfg, first_arrays(tcfg, path, DEVICE)[0], "fused",
                     f"the main path's trained step-{want_steps} state")
    train_breakdown(tcfg, path, "fused")
    return launches, two_pass


def run_lr(cfg, work: str, path: str, batch) -> dict:
    """The default model's main path: `python -m xflow_tpu_torch train`
    with no `--model` (LR: table `w [2^22]`, row-major batches, FTRL), 2
    epochs = 4 steps, with the launch counts around it: every kernel's
    count must stay 0 (LR's gather is torch indexing and its gradient
    autograd's `index_add_`, as both are XLA ops in the JAX package). Then
    one step from the trained checkpoint on the card and on the CPU on
    `batch` (the shard's first batch, parsed once for the MVM phases):
    the loss within LOSS_RTOL, w, n and z by `ftrl_errs`. Returns the
    launch counts."""
    import math

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import batch_arrays
    from xflow_tpu_torch.ops import sorted_table as st

    ck = os.path.join(work, "ck_lr")
    summary, launches = train_cli(path[: -len("-00000")], ck, 2, model=None)
    want_steps = 2 * -(-SHARD_ROWS // BATCH)
    if (summary["steps"], summary["bad_steps"], set(summary["occupancy"])) != (
            want_steps, 0, {"w"}) or not math.isfinite(summary["last_loss"]):
        fail(f"train with no --model: summary {summary}, expected LR's table w over "
             f"{want_steps} steps")
    if any(launches.values()):
        fail(f"the LR main path launched a kernel ({launches})")
    lcfg = override(cfg, **{"model.name": "lr", "train.checkpoint_dir": ck})
    host = batch_arrays(batch, lcfg)
    if "slots" not in host or "sorted_slots" in host:
        fail(f"the LR batch is not row-major: {sorted(host)}")
    st.reset_launches()
    step_card_vs_cpu(lcfg, host, "lr", f"the LR main path's trained step-{want_steps} state")
    if any(st.LAUNCHES.values()):
        fail(f"the LR step launched a kernel ({st.LAUNCHES})")
    print(f"# lr: every kernel's launch count 0 on the main path ({launches}) and the "
          "card-vs-CPU step", flush=True)
    return launches


def train_breakdown(cfg, path, kind: str) -> None:
    """Where a train step's time goes: host clock per stage over the
    shard from a fresh state (each device stage ends in a synchronize),
    and the step's CUDA-event time on one resident batch."""
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data.libffm import iter_batches
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.train.step import make_train_step
    from xflow_tpu_torch.train.trainer import Trainer

    trainer = Trainer(override(cfg, **{"train.checkpoint_dir": ""}), device=DEVICE)
    acc = dict.fromkeys(("parse", "plan", "to_device", "step"), 0.0)
    n = 0
    pc = time.perf_counter
    it = iter_batches(path, cfg.data)
    while True:
        t = pc()
        batch = next(it, None)
        acc["parse"] += pc() - t
        if batch is None:
            break
        t = pc()
        host = batch_arrays(batch, cfg)
        acc["plan"] += pc() - t
        t = pc()
        arrays = to_device(host, DEVICE)
        torch.cuda.synchronize()
        acc["to_device"] += pc() - t
        t = pc()
        trainer.state, _ = trainer.train_step(trainer.state, arrays)
        torch.cuda.synchronize()
        acc["step"] += pc() - t
        n += 1
    print(f"# {cfg.model.name} {kind} train stages, ms per batch (host clock): "
          + ", ".join(f"{k} {v / n * 1e3:.3f}" for k, v in acc.items()), flush=True)
    state = trainer.state
    step_ms = cuda_ms(lambda: trainer.train_step(state, arrays), reps=10)
    unguarded = make_train_step(
        trainer.model, trainer.optimizer, override(cfg, **{"train.nonfinite_guard": "off"})
    )
    off_ms = cuda_ms(lambda: unguarded(state, arrays), reps=10)
    print(f"# {cfg.model.name} {kind} train step on the card (CUDA events): {step_ms:.3f} ms per "
          f"{BATCH}-row batch; {off_ms:.3f} ms with the non-finite guard off "
          "(no isfinite sweep, no host read)", flush=True)
    profile_step(lambda: trainer.train_step(state, arrays), f"{cfg.model.name} {kind}")


def profile_step(step, what: str, reps: int = 5) -> None:
    """Device busy time of a train step by `torch.profiler` (the sum of
    the kernels' own device time), its share of the profiled window, the
    largest kernels, and the operators that launched the most device
    time (the port's own kernels launch from ctypes, outside any
    operator)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    own = lambda e: e.self_device_time_total  # noqa: E731
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA and own(e) > 0]
    if not kern:
        print(f"# {what} train step profile: the profiler saw no device time (not measured)")
        return
    busy_us = sum(own(e) for e in kern)
    ops = [e for e in avgs if e.device_type == DeviceType.CPU and own(e) > 0]
    ms = lambda e: f"{own(e) / reps / 1e3:.4f} ms"  # noqa: E731
    print(f"# {what} train step profile (torch.profiler, {reps} steps): device busy "
          f"{busy_us / reps / 1e3:.3f} ms per step, {busy_us / wall_us:.1%} of the profiled "
          f"window ({wall_us / reps / 1e3:.3f} ms per step host clock)", flush=True)
    print("#   largest kernels: " + "; ".join(
        f"{e.key[:48]} {ms(e)}" for e in sorted(kern, key=own, reverse=True)[:6]))
    print("#   operators by device time launched: " + "; ".join(
        f"{e.key} x{e.count // reps} {ms(e)}" for e in sorted(ops, key=own, reverse=True)[:12]))


def mvm_config(cfg, ck_dir: str, **extra):
    """The MVM configuration at the FM phases' widths: `v [2^22, 10]`,
    18 fields, 65,536-row batches, the plus-one factor form."""
    from xflow_tpu_torch.config import override

    return override(cfg, **{"model.name": "mvm", "train.checkpoint_dir": ck_dir,
                            "model.mvm_plus_one": True, **extra})


def segment_cotangent(table, arrays: dict, cfg):
    """d_occ [K8, NS * cap] of a stacked segment-side batch: the
    multi-buffer gather, then autograd of the row side's loss (one
    segment row side per sub-batch, as `sorted_gather_map` runs it) with
    respect to the gathered occurrences only."""
    import torch

    from xflow_tpu_torch.models.mvm import _segment_row_side
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.train.step import masked_mean_logloss

    ns, np_sub = arrays["sorted_slots"].shape
    with torch.no_grad():
        occ = st.table_gather_sorted_multi(
            table, arrays["sorted_slots"].reshape(-1), arrays["win_off"], cfg.data.sorted_bf16
        )
    occ.requires_grad_(True)
    plus = 1.0 if cfg.model.mvm_plus_one else 0.0
    rows = arrays["labels"].shape[0] // ns
    with torch.enable_grad():
        logits = torch.cat([
            _segment_row_side(occ[:, i * np_sub:(i + 1) * np_sub], arrays["sorted_row"][i],
                              arrays["sorted_mask"][i], arrays["sorted_fields"][i], rows,
                              cfg.model.num_fields, cfg.model.v_dim, plus)
            for i in range(ns)
        ])
        loss = masked_mean_logloss(logits, arrays["labels"], arrays["row_mask"])
        (d,) = torch.autograd.grad(loss, occ)
    return d.contiguous()


def check_multi_kernels(seg_cfg, batch) -> list:
    """The multi-buffer gather (#5) and scatter (#6) against their plain
    versions on the segment row side's inputs: the first batch's stacked
    plan and its cotangent on the restored MVM state."""
    import torch

    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.ops import sorted_table as st

    arrays = to_device(batch_arrays(batch, seg_cfg), DEVICE)
    ss2, loc = arrays["sorted_slots"], arrays["win_off"]
    if ss2.ndim != 2 or ss2.shape[0] != 4 or "sorted_fields" not in arrays:
        fail(f"the segment plan is {tuple(ss2.shape)}, not 4 stacked sub-batches with fields")
    ss = ss2.reshape(-1)
    v = restored_state(seg_cfg, DEVICE).tables["v"]
    S, K = v.shape
    K8, np_ = st._k8(K), ss.numel()
    print(f"# segment plan: {tuple(ss2.shape)} stacked, {np_} positions, "
          f"{torch.unique(ss.long()).numel()} distinct slots", flush=True)
    results = []

    # --- multi-buffer gather (#5), bit-exact, bf16 off and on
    for bf16 in (False, True):
        got = st.gather_sorted_multi_cuda(v, ss, loc, bf16)
        want = st.gather_sorted_multi_plain(v, ss, loc, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_sorted_multi (bf16={bf16}) differs from its plain version: "
                 f"max abs err {(got - want).abs().max().item()}")
        print(f"# gather_sorted_multi bf16={bf16}: bit-exact over {tuple(got.shape)}",
              flush=True)
    g_err = (st.gather_sorted_multi_cuda(v, ss, loc)
             - st.gather_sorted_multi_plain(v, ss, loc)).abs().max().item()
    g_ms = cuda_ms(lambda: st.gather_sorted_multi_cuda(v, ss, loc))
    g_flat = cuda_ms(lambda: st.gather_sorted_cuda(v, ss))
    g_plain = cuda_ms(lambda: st.gather_sorted_multi_plain(v, ss, loc))
    g_lib = cuda_ms(lambda: torch.index_select(v, 0, ss).T.contiguous())
    g_bytes = gather_bytes(ss, K, K8) + loc.numel() * 4
    g_bound, g_by = bound_ms(g_bytes, 0.0)
    print(f"# gather_sorted_multi {g_ms:.4f} ms; gather_sorted on the same flattened stream "
          f"{g_flat:.4f} ms; bound {g_bound:.4f} ms ({g_bytes / 1e6:.1f} MB)", flush=True)
    results.append({
        "name": "gather_sorted_multi", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/gather_sorted_multi.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:811",
        "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib,
        "flat_gather_sorted_ms": g_flat,
    })

    # --- multi-buffer scatter (#6): bitwise against the CPU plain version,
    # which adds each slot's terms buffer by buffer in plan order, as the
    # kernel does, and across two launches
    d = segment_cotangent(v, arrays, seg_cfg)
    d_cpu, ss_cpu, loc_cpu = d.cpu(), ss.cpu(), loc.cpu()
    for bf16 in (False, True):
        got = st.scatter_sorted_multi_cuda(d, ss, loc, S, K, bf16)
        again = st.scatter_sorted_multi_cuda(d, ss, loc, S, K, bf16)
        want = st.scatter_sorted_multi_plain(d_cpu, ss_cpu, loc_cpu, S, K, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"scatter_sorted_multi (bf16={bf16}) gave different bits on two launches")
        got = got.cpu()
        if not torch.equal(got, want):
            fail(f"scatter_sorted_multi (bf16={bf16}) differs from its plain version on the "
                 f"CPU: max abs err {(got - want).abs().max().item()} "
                 f"(largest |want| {want.abs().max().item()})")
        if not want.abs().max().item() > 0:
            fail("scatter_sorted_multi: the segment cotangent is all zero")
        print(f"# scatter_sorted_multi bf16={bf16}: bit-exact against the CPU plain version "
              f"and across two launches, over {tuple(got.shape)} "
              f"(largest |g| {want.abs().max().item():.3g})", flush=True)
        if not bf16:
            s_err = (got - want).abs().max().item()
    s_ms = cuda_ms(lambda: st.scatter_sorted_multi_cuda(d, ss, loc, S, K))
    s_plain = cuda_ms(lambda: st.scatter_sorted_multi_plain(d, ss, loc, S, K))
    ss_l = ss.long()
    s_lib = cuda_ms(lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d[:K].T))
    s_zeros = cuda_ms(lambda: torch.zeros((S, K), device=DEVICE))  # the write floor
    s_bound, s_by = bound_ms(S * K * 4 + K * np_ * 4 + np_ * 4 + loc.numel() * 4, K * np_)
    print(f"# scatter_sorted_multi {s_ms:.4f} ms, zeros + index_add_ {s_lib:.4f} ms, zeros "
          f"{s_zeros:.4f} ms, bound {s_bound:.4f} ms", flush=True)
    results.append({
        "name": "scatter_sorted_multi", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/scatter_sorted_multi.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:998",
        "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain,
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": s_lib, "zeros_ms": s_zeros,
    })
    return results


def check_mvm_product_kernels(mcfg, batch) -> dict:
    """Kernels #1-#4 on the MVM product row side's own inputs: the first
    batch's flat plan on the restored `v [2^22, 10]` state, the plus-one
    form the main path trains (so the row sum runs at ch = 32 on the log
    space channels), and the occurrence cotangent of the fused step's
    backward. The checks of `check_kernels` and `check_train_kernels`;
    the fused kernel's plain version runs on the CPU, and of its leaves
    w is gated and n, z are reported, as in the MVM steps (see
    `ftrl_errs`). Then the product step's CUDA-event time, fused and
    two-pass. Returns each kernel's error and time here, by name, and
    the multi-buffer scatter's time on this plan as one buffer."""
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.models.mvm import mvm_product_channels
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.step import fused_cotangent, make_train_step

    arrays = to_device(batch_arrays(batch, mcfg), DEVICE)
    ss, wo = arrays["sorted_slots"], arrays["win_off"]
    if ss.ndim != 1 or "sorted_fields" in arrays:
        fail(f"the MVM product configuration planned {tuple(ss.shape)}, not a flat "
             "product-side plan")
    state = restored_state(mcfg, DEVICE)
    v, n, z = state.tables["v"], state.opt_state["v"]["n"], state.opt_state["v"]["z"]
    S, K = v.shape
    hp = mcfg.optim.ftrl
    out = {}

    # --- gather (#1), bit-exact, bf16 off and on
    for bf16 in (False, True):
        got, want = st.gather_sorted_cuda(v, ss, bf16), st.gather_sorted_plain(v, ss, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_sorted on the MVM product plan (bf16={bf16}) differs from its plain "
                 f"version: max abs err {(got - want).abs().max().item()}")
    occ = st.gather_sorted_cuda(v, ss)
    out["gather_sorted"] = {"max_abs_err": (occ - st.gather_sorted_plain(v, ss)).abs().max().item(),
                            "ms": cuda_ms(lambda: st.gather_sorted_cuda(v, ss))}

    # --- row sum (#2) on the product row side's log-space channels
    rows, mask = st.wire_rows(arrays["sorted_row"]), st.wire_mask(arrays["sorted_mask"])
    vals = mvm_product_channels(occ[:K] + 1.0, mask, K).contiguous()
    out["row_sums"] = check_row_sums(vals, rows, "on the MVM product's log-space channels")
    rel = out["row_sums"]["rel_err"]

    # --- scatter (#4), bitwise against the CPU plain version and across
    # two launches; fused scatter + FTRL (#3) against its plain version on
    # the CPU, which sums each slot's run in plan order as the kernel does.
    # On the card the plain version's atomics reorder the sums, and where a
    # slot's terms cancel to exactly 0 in one order only, the lazy-init
    # guard keeps v on that side alone: w then differs by a whole v.
    _, d_occ = fused_cotangent(v, arrays, mcfg)
    d_cpu, ss_cpu = d_occ.cpu(), ss.cpu()
    prev_cpu = (v.cpu(), n.cpu(), z.cpu())
    for bf16 in (False, True):
        got = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        again = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, K, bf16)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got.cpu(), want)):
            fail(f"scatter_sorted on the MVM product cotangent (bf16={bf16}) is not bitwise "
                 f"equal across two launches and to its CPU plain version: max abs err "
                 f"{(got.cpu() - want).abs().max().item()}")
        ftrl = st.scatter_ftrl_cuda(d_occ, ss, wo, v, n, z, K, hp, bf16)
        ftrl_want = st.scatter_ftrl_plain(d_cpu, ss_cpu, *prev_cpu, K, hp, bf16)
        what = f"scatter_ftrl on the MVM product cotangent (bf16={bf16})"
        errs = ftrl_errs(ftrl, ftrl_want, prev_cpu, hp, what, leaves=False)
        if not errs["w"] <= FTRL_RTOL:
            fail(f"{what}: w err {errs['w']} beyond {FTRL_RTOL} relative over {FTRL_FLOOR}")
        lazy = (got == 0) & (n == 0)
        n_lazy = int(lazy.sum())
        if n_lazy == 0 or not torch.equal(ftrl[0][lazy], v[lazy]):
            fail(f"scatter_ftrl on the MVM product cotangent (bf16={bf16}) did not keep v of "
                 f"the {n_lazy} never-touched (slot, channel) entries bitwise")
        print(f"# mvm product kernels bf16={bf16}: gather bit-exact over {tuple(occ.shape)}; "
              f"row_sums max err {rel:.3g} relative over {tuple(vals.shape)} channels; scatter "
              f"bitwise (largest |g| {want.abs().max().item():.3g}); scatter_ftrl max err "
              f"{errs} (w, g, w_rule within {FTRL_RTOL}), v kept bitwise on {n_lazy} lazy-init "
              "entries", flush=True)
        if not bf16:
            out["scatter_sorted"] = {"max_abs_err": 0.0}
            out["scatter_ftrl"] = {"max_abs_err": max(
                (a.cpu() - b).abs().max().item() for a, b in zip(ftrl, ftrl_want))}
    out["scatter_sorted"]["ms"] = cuda_ms(lambda: st.scatter_sorted_cuda(d_occ, ss, wo, S, K))
    ss_l = ss.long()
    out["scatter_sorted"]["library_ms"] = cuda_ms(
        lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T))
    out["scatter_sorted"]["zeros_ms"] = cuda_ms(lambda: torch.zeros((S, K), device=DEVICE))
    # the multi-buffer scatter (#6) on the same positions in one buffer
    # (the segment side stacks a batch in four): the time of its pieces
    one = st.scatter_sorted_multi_cuda(d_occ, ss, wo.view(1, -1), S, K)
    if not torch.equal(one, st.scatter_sorted_cuda(d_occ, ss, wo, S, K)):
        fail("scatter_sorted_multi over one buffer differs from scatter_sorted on its plan")
    out["scatter_sorted_multi"] = {"one_buffer_ms": cuda_ms(
        lambda: st.scatter_sorted_multi_cuda(d_occ, ss, wo.view(1, -1), S, K))}
    out["scatter_sorted"]["bound_ms"], _ = bound_ms(
        S * K * 4 + K * ss.numel() * 4 + ss.numel() * 4 + wo.numel() * 4, K * ss.numel())
    out["scatter_ftrl"]["ms"] = cuda_ms(lambda: st.scatter_ftrl_cuda(d_occ, ss, wo, v, n, z, K, hp))

    # --- the product step, fused against two-pass (the `auto` rule keeps
    # MVM two-pass, as measured on the TPU)
    step_ms = {}
    for fuse in ("on", "off"):
        step = make_train_step(get_model("mvm")(mcfg), get_optimizer("ftrl"),
                               override(mcfg, **{"optim.fused_scatter": fuse}))
        step_ms[fuse] = cuda_ms(lambda step=step: step(state, arrays), reps=10)
    print(f"# mvm product train step on the card (CUDA events): fused {step_ms['on']:.3f} ms, "
          f"two-pass {step_ms['off']:.3f} ms per {BATCH}-row batch", flush=True)
    return out


def check_hot_scatters() -> dict:
    """#4 and #6 on a skewed plan at the main paths' S and Np: B x F slots
    drawn uniformly from the table (seeded), except that one slot takes
    every row's first field, a run of B = 65,536 occurrences (16,384 in each
    of #6's 4 stacked buffers). #4 at FM's K = 11 on the flat plan, #6 at
    MVM's K = 10 on the stacked one, d ~ N(0, 1) masked as the plan's pads
    are: bitwise against the CPU plain version and across two launches, bf16
    off and on. Returns {name: {hot_ms, hot_library_ms}}: the times on this
    plan (a hot slot's terms are added one at a time, so its run is serial;
    not a target), and zeros + index_add_ on it."""
    import numpy as np
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    S = 1 << LOG2_SLOTS
    rng = np.random.default_rng(SEED + 5)
    slots = rng.integers(0, S, (BATCH, NUM_FIELDS)).astype(np.int32)
    slots[:, 0] = HOT_SLOT
    mask = np.ones((BATCH, NUM_FIELDS), np.float32)
    flat = st.plan_sorted_batch(slots, mask, S)
    stacked = st.plan_sorted_stacked(slots, mask, S, num_sub=4)
    cases = (
        ("scatter_sorted", 1 + V_DIM, flat.sorted_slots, flat.win_off, flat.sorted_mask,
         lambda d, ss, off, K, bf16: st.scatter_sorted_cuda(d, ss, off, S, K, bf16)),
        ("scatter_sorted_multi", V_DIM, stacked.sorted_slots.reshape(-1), stacked.win_off,
         stacked.sorted_mask.reshape(-1),
         lambda d, ss, off, K, bf16: st.scatter_sorted_multi_cuda(d, ss, off, S, K, bf16)),
    )
    out = {}
    for name, K, ss_np, off_np, m_np, run in cases:
        d_np = rng.standard_normal((st._k8(K), ss_np.size), dtype=np.float32)
        d_np[:K] *= m_np[None, :]
        d_cpu, ss_cpu = torch.from_numpy(d_np), torch.from_numpy(np.ascontiguousarray(ss_np))
        d, ss = d_cpu.to(DEVICE), ss_cpu.to(DEVICE)
        off = torch.from_numpy(np.ascontiguousarray(off_np)).to(DEVICE)
        for bf16 in (False, True):
            got, again = run(d, ss, off, K, bf16), run(d, ss, off, K, bf16)
            want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, K, bf16)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(got.cpu(), want)):
                fail(f"{name} on the hot-slot plan (bf16={bf16}) is not bitwise equal across "
                     f"two launches and to its CPU plain version: max abs err "
                     f"{(got.cpu() - want).abs().max().item()}")
        ss_l = ss.long()
        out[name] = {
            "hot_ms": cuda_ms(lambda: run(d, ss, off, K, False), reps=5, warmup=1),
            "hot_library_ms": cuda_ms(
                lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d[:K].T),
                reps=5, warmup=1),
        }
        print(f"# {name} on the hot-slot plan ({ss_np.size} positions, a run of {BATCH} at "
              f"slot {HOT_SLOT}): bitwise, bf16 off and on; {out[name]['hot_ms']:.4f} ms, "
              f"zeros + index_add_ {out[name]['hot_library_ms']:.4f} ms", flush=True)
    return out


def mvm_steps_card_vs_cpu(mcfg, batch) -> None:
    """One product step (two-pass and fused) and one segment step from the
    restored MVM state, plain and plus-one factor forms, on the card and
    on the CPU: the loss, and (w, n, z) by the gradient z' implies and
    the FTRL w rule (the plus-one form's gradients reach 1e-2, see
    `ftrl_errs`)."""
    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import batch_arrays

    for plus in (False, True):
        for side, excl, fuse in (("product", "auto", "auto"), ("product fused", "auto", "on"),
                                 ("segment", "off", "auto")):
            cfg = override(mcfg, **{"model.mvm_plus_one": plus, "model.mvm_exclusive": excl,
                                    "optim.fused_scatter": fuse})
            host = batch_arrays(batch, cfg)
            if ("sorted_fields" in host) != (excl == "off"):
                fail(f"the {side} configuration planned the other row side")
            step_card_vs_cpu(cfg, host, f"mvm {side} (plus_one={plus})",
                             "the restored MVM step-1 state", leaves=False)


def run_mvm_training(mcfg, work: str, path: str) -> dict:
    """The MVM main paths through the train CLI, then train -> serve on
    the segment run's checkpoint and the segment step's breakdown.
    Returns the segment run's launch counts."""
    import math

    import numpy as np

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.serve.runner import ServeRunner

    prefix = path[: -len("-00000")]
    n_batches = -(-SHARD_ROWS // BATCH)
    want_steps = 2 * n_batches
    plus = ("--set", "model.mvm_plus_one=true")

    def ran(launches, must, never, what):
        for name in must:
            if launches[name] < 1:
                fail(f"kernel {name} was not launched on the {what} ({launches})")
        for name in never:
            if launches[name]:
                fail(f"the {what} launched {name} ({launches})")

    summary, product = train_cli(prefix, os.path.join(work, "ck_mvm_product"), 2, *plus,
                                 model="mvm")
    if (summary["steps"], summary["bad_steps"]) != (want_steps, 0) or not math.isfinite(
            summary["last_loss"]):
        fail(f"mvm product train summary {summary}")
    ran(product, ("gather_sorted", "row_sums", "scatter_sorted"),
        ("scatter_ftrl", "gather_sorted_multi", "scatter_sorted_multi"), "MVM product path")

    _, fused = train_cli(prefix, os.path.join(work, "ck_mvm_fused"), 1, *plus,
                         "--set", "optim.fused_scatter=on", model="mvm")
    ran(fused, ("gather_sorted", "row_sums", "scatter_ftrl"), ("scatter_sorted",),
        "MVM fused product path")

    seg_ck = os.path.join(work, "ck_mvm_segment")
    summary, segment = train_cli(prefix, seg_ck, 2, *plus,
                                 "--set", "model.mvm_exclusive=off", model="mvm")
    if (summary["steps"], summary["bad_steps"]) != (want_steps, 0) or not math.isfinite(
            summary["last_loss"]):
        fail(f"mvm segment train summary {summary}")
    ran(segment, (), ("gather_sorted", "scatter_sorted", "row_sums", "scatter_ftrl"),
        "MVM segment path")
    for name in ("gather_sorted_multi", "scatter_sorted_multi"):
        if segment[name] != want_steps:
            fail(f"the MVM segment path launched {name} {segment[name]} times in "
                 f"{want_steps} steps ({segment})")

    scfg = override(mcfg, **{"train.checkpoint_dir": seg_ck, "model.mvm_exclusive": "off"})
    st.reset_launches()
    runner = ServeRunner(scfg, device=DEVICE)
    gen = runner.load()
    if gen.step != want_steps:
        fail(f"the MVM segment checkpoint serves step {gen.step}, expected {want_steps}")
    auc, ll = evaluate(scfg, gen.tables, path, device=DEVICE)
    launches = dict(st.LAUNCHES)
    if launches["gather_sorted_multi"] < 1:
        fail(f"MVM evaluate did not launch gather_sorted_multi ({launches})")
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.0 <= auc <= 1.0):
        fail(f"the trained MVM model evaluates to auc={auc} logloss={ll}")
    print(f"# mvm train -> serve: step {gen.step}, auc={auc} logloss={ll} on the training "
          f"shard; evaluate launches {launches}", flush=True)
    _, p_eval = first_batch(scfg, gen.tables, path, DEVICE)
    with open(path) as f:
        rows = [next(f).split("\t", 1)[1].strip() for _ in range(8)]
    served, _ = runner.predict_rows(rows)
    ds = float(np.abs(served - p_eval[:8]).max())
    if not ds <= PCTR_ATOL:
        fail(f"MVM predict_rows (row-major) differs from evaluate (sorted) by {ds}")
    print(f"# mvm predict_rows on 8 rows vs evaluate: max abs diff {ds} "
          f"(pctrs {served[:3]})", flush=True)
    train_breakdown(scfg, path, "segment")
    print(f"# mvm launches: product {product}, fused {fused}, segment {segment}", flush=True)
    return segment


WIDE_V_DIMS = (50, 63, 64)  # FM row sides at ch = 104, 128, 136


def check_wide_row_sums(cfg, path) -> dict:
    """The row sum (#2) at the wide channel counts (four and five channel
    groups) against its plain version on the first batch's plan, each on
    FM's own channels at that width (a random `wv [2^22, 1 + v_dim]` ~
    N(0, 0.05²) gathered by #1), by `check_row_sums`, and the FM forward
    at v_dim = 64 on the card against the CPU. Returns {ch: that entry
    and v_dim}."""
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.models.fm import stack_channels
    from xflow_tpu_torch.models.predict import make_predict_fn
    from xflow_tpu_torch.ops import sorted_table as st

    host, arrays = first_arrays(cfg, path, DEVICE)
    ss = arrays["sorted_slots"]
    rows, mask = st.wire_rows(arrays["sorted_row"]), st.wire_mask(arrays["sorted_mask"])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    out = {}
    for v_dim in WIDE_V_DIMS:
        K = 1 + v_dim
        wv = torch.randn((1 << LOG2_SLOTS, K), generator=gen, device=DEVICE) * 0.05
        vals = stack_channels(st.gather_sorted_cuda(wv, ss)[:K] * mask[None, :], K).contiguous()
        rs = check_row_sums(vals, rows, f"on FM's channels at v_dim {v_dim}")
        out[rs["ch"]] = {"v_dim": v_dim, **rs}
    predict = make_predict_fn(get_model("fm")(override(cfg, **{"model.v_dim": 64})))
    st.reset_launches()
    p_card = predict({"wv": wv}, arrays).cpu()
    launched = st.LAUNCHES["row_sums"]
    p_cpu = predict({"wv": wv.cpu()}, to_device(host, "cpu"))
    d = (p_card - p_cpu).abs().max().item()
    if launched != 1 or p_card.shape != (BATCH,) or not d <= PCTR_ATOL:
        fail(f"FM forward at v_dim 64: {launched} row_sums launches, card vs CPU pCTRs differ "
             f"by {d} (tolerance {PCTR_ATOL})")
    print(f"# FM forward at v_dim 64 (ch 136) on the card vs the CPU: pCTR max abs diff {d}",
          flush=True)
    return out


def echo(fn):
    """fn() with its stdout and stderr echoed as comments afterwards."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            return fn()
    finally:
        for line in buf.getvalue().splitlines():
            print(f"#   {line}")
        sys.stdout.flush()


LAB_PROBES = (  # (launch key, suite key, TPU kernel)
    ("mosaic_a", "a", "xflow_tpu/tools/bench_lab.py:441"),
    ("mosaic_b", "b", "xflow_tpu/tools/bench_lab.py:462"),
    ("mosaic_c", "c", "xflow_tpu/tools/bench_lab.py:484"),
    ("mosaic_d", "d", "xflow_tpu/tools/bench_lab.py:506"),
)


def run_lab(work: str) -> list:
    """The lab's suites in process: mosaic and rowsum with the lab's
    launch counts around them, the parity gate, then core, micro, layout
    and scatter. Returns the kernels JSON entries of #7-#11."""
    from xflow_tpu_torch.ops import lab
    from xflow_tpu_torch.tools import bench_lab, kernel_parity

    lab.reset_launches()
    t0 = time.perf_counter()
    mosaic = echo(lambda: bench_lab.suite_mosaic(device=DEVICE))
    rowsum = echo(lambda: bench_lab.suite_rowsum(device=DEVICE))
    launches = dict(lab.LAUNCHES)
    print(f"# lab mosaic + rowsum: {time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    if not mosaic["ok"]:
        fail(f"the mosaic suite failed: probes {mosaic['probes_ok']}, TMA {mosaic['tma']}")
    for name, n in launches.items():
        if n < 1:
            fail(f"lab kernel {name} was not launched in the lab run ({launches})")

    res = kernel_parity.check_kernel_parity()
    print(f"# kernel_parity {json.dumps(res)}", flush=True)
    if not (res["ok"] and res["backend"] == "cuda"):
        fail(f"kernel_parity on the card: {res}")

    t0 = time.perf_counter()
    out = os.path.join(work, "BENCH_LAB_TORCH.json")
    core = echo(lambda: bench_lab.suite_core(["--out", out], device=DEVICE))
    print("# core sweep: " + ", ".join(
        f"{c['op']} {c['ns_per_element']} ns/element ({c['achieved_gbps']} GB/s)"
        for c in core["cells"]), flush=True)
    for suite in ("micro", "layout", "scatter"):
        echo(lambda suite=suite: bench_lab.SUITES[suite]((), device=DEVICE))
    print(f"# lab core, micro, layout, scatter: {time.perf_counter() - t0:.1f} s", flush=True)

    kern = []
    tma = {key: lab.tma_result(code) for key, code in mosaic["tma"].items()}
    for name, key, replaces in LAB_PROBES:
        k = mosaic["kernels"][key]
        b_ms, b_by = bound_ms(k["bytes"], 0.0)
        kern.append({
            "name": name, "route": "cuda", "source": "xflow_tpu_torch/csrc/lab_mosaic.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": k["library_ms"], "ms_by": k["ms_by"], "host_ms": k["host_ms"],
            **({"tma_encode": tma} if key == "d" else {}),
        })
    b_ms, b_by = bound_ms(rowsum["bytes"], rowsum["adds"])
    kern.append({
        "name": "lab_rowsum", "route": "cuda", "source": "xflow_tpu_torch/csrc/lab_rowsum.cu",
        "replaces": "xflow_tpu/tools/bench_lab.py:714", "launches": launches["lab_rowsum"],
        "max_abs_err": rowsum["errors"]["max_abs_err"],
        "ms": rowsum["ms"]["lab rowsum (red.v4)"], "plain_ms": rowsum["ms"]["plain"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": rowsum["ms"]["zeros + index_add_"],
        "row_sums_ms": rowsum["ms"]["row_sums (#2)"],
    })
    return kern


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "xflow_tpu_torch")):
        fail(f"{HERE} holds no xflow_tpu_torch package: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a CUDA card only")
    card = card_line()
    print(f"# card: {card}", flush=True)

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"# built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {name}: {line.strip()}")

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as work:
        cfg = override(Config(), **{
            "model.name": "fm", "model.v_dim": V_DIM, "model.num_fields": NUM_FIELDS,
            "data.log2_slots": LOG2_SLOTS, "data.max_nnz": NUM_FIELDS,
            "data.batch_size": BATCH, "train.checkpoint_dir": os.path.join(work, "ck"),
        })
        path = make_inputs(work, cfg)
        mcfg = mvm_config(cfg, os.path.join(work, "ck_mvm"))
        write_state(mcfg.train.checkpoint_dir, "v", V_DIM, MVM_V_SCALE, SEED + 1)
        from xflow_tpu_torch.data.libffm import iter_batches
        from xflow_tpu_torch.serve.runner import ServeRunner

        gen = ServeRunner(cfg, device=DEVICE).load()
        kern = check_kernels(cfg, gen, path)
        kern += check_train_kernels(cfg, path)
        mvm_batch = next(iter_batches(path, mcfg.data))  # parsed once for the MVM checks
        seg_cfg = mvm_config(cfg, mcfg.train.checkpoint_dir, **{"model.mvm_exclusive": "off"})
        kern += check_multi_kernels(seg_cfg, mvm_batch)
        mvm_product = check_mvm_product_kernels(mcfg, mvm_batch)
        hot = check_hot_scatters()
        mvm_steps_card_vs_cpu(mcfg, mvm_batch)
        eval_launches = run_slice(cfg, gen, path)
        train_launches, two_pass = run_training(cfg, work, path)
        lr_launches = run_lr(cfg, work, path, mvm_batch)
        segment = run_mvm_training(mcfg, work, path)
        wide = check_wide_row_sums(cfg, path)
        lab_kern = run_lab(work)
    print(f"# launches: evaluate path {eval_launches}, training main path {train_launches}, "
          f"two-pass epoch {two_pass}, LR (the default model) {lr_launches}, "
          f"MVM segment path {segment}")
    for k in kern:
        src = {"scatter_sorted": two_pass, "gather_sorted_multi": segment,
               "scatter_sorted_multi": segment}.get(k["name"], train_launches)
        k["launches"] = src[k["name"]]
        if k["name"] in mvm_product:
            k["mvm_product"] = mvm_product[k["name"]]
        if k["name"] == "row_sums":
            k["widths"].update({32: mvm_product["row_sums"], **wide})
        k.update(hot.get(k["name"], {}))
    kern += lab_kern
    for k in kern:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
