#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit as nvidia-smi reports them, and the
   host's usable cores;
2. build every CUDA kernel from `xflow_tpu_torch/csrc/` (one nvcc per
   source, started together);
3. write the inputs from a seed at the FM headline's full width (fused
   `wv [2^22, 11]`, 18 fields, 65,536-row batches): a committed full
   training checkpoint (tables, FTRL n and z with the upper half of the
   slots never touched), a libffm shard of 2 x 65,536 rows, the rate
   shard of 20 x 65,536 rows (the bulk writer's data) and their `.xfc`
   caches (the port's `build_cache`, into the work directory).
   Every path below reads the text through the native MT parser and
   plans with the native planner (`data/native.py`): the host input
   plane's call counts (`data/pipeline.host_calls`) are set to 0 just
   before each train and evaluate path and read just after, and the
   path fails unless it read native stream (or, where asked, `.xfc`)
   batches, made native plans (LR plans nothing) and parsed no row in
   Python. Each phase's first batch is read from the text and from the
   cache, bitwise equal, with parse and plan timed;
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
   process) on the card, 2 epochs over the shard (4 fused steps); two
   rate runs of one epoch over the rate shard (20 steps, no checkpoint),
   from the text and from the `.xfc` cache (`data.cache=on`), each
   printing its `examples_per_sec`; then one epoch of the two-pass step
   (`optim.fused_scatter=off`). Each run
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
9. where the time goes: host clock per stage (parse, plan, to_device,
   step or forward) of an evaluate batch and of a train step over the
   rate shard, from the text (MT parser) and from the `.xfc` cache, and
   for FM evaluate from the Python parser too (the before column, over
   the first 2 batches), CUDA-event times of the forward and of the step (with
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
   shapes; (e) `hostplane` (the host's parse rate per parser thread count
   and plan rate per pool size, up to the usable cores). The mosaic
   suite also reads the launch floor (a one-element `torch.zeros` fill by
   the same profiler), carried as `floor_ms` in #7-#10's entries. Each
   suite's output is echoed as comments;
13. FFM at bench.py's practical shape (`wv [2^22, 73]`: 18 fields, k =
   4; 131,072-row batches, so the shard is one batch and the rate shard
   ten; FTRL), run before phase 12, on a committed step-1 FFM state (wv ~
   N(0, 0.05²), n and z on the lower half) read once. The first batch
   plans flat and aligned from the text and the cache (int32 rows, u8
   fields: 131,072 rows exceed the u16 row bound; the placement
   `ffm_invperm [131072, 18]`); on it #1 bit-exact, #4 bitwise against
   the CPU and across two launches and #3 by `ftrl_errs`, bf16 off and
   on, at K = 73 (`check_gather`, `check_scatters`: their times, plain,
   library and bound under an `ffm` key of each kernel's entry). One
   fused and one two-pass step card vs CPU as in phase 5, each launching
   #1 and #3, or #1 and #4, once and nothing else; the first batch with
   field 0 repeated in column 1 routes row-major (the FFM route counts,
   `models/ffm.ROUTES`), launches nothing and matches the CPU step. Then
   `train --model ffm` (2 epochs, fused: #1 and #3 once a step), a rate
   run over one epoch of the rate shard (`examples_per_sec`), one
   two-pass epoch (#1 and #4), every aligned batch on the aligned route;
   evaluate of the trained checkpoint (finite AUC) and `predict_rows` on
   64 rows against it within 1e-5; and the train step's stage breakdown
   (`train_breakdown`: the plan's routing and placement also timed on
   their own);
14. serving on the card, after the other phases (`run_serve`): two
   committed full-width FM states (steps 1 and 2, other seeds) and
   `python -m xflow_tpu_torch serve --device cuda` over step 1 (port 0,
   2 ms window, max batch 256, ladder 32,64,128,256, poll 0.5 s, a
   serve stream with 0.5 s windows and 1% trace sampling); its ready
   line must name the card. The port's `tools/serve_bench.py` drives it
   closed-loop for 15 s (16 connections, 1-8 rows a request from the
   shard, trace ids echoed) while step 2 commits by one rename about
   5 s in: the answers must flip from step 1 to step 2 with 0 failed
   requests, `/healthz` must report step 2, and the stream must hold
   windows with every `SERVE_WINDOW_KEYS` key, a reload event and its
   span. 256 rows POSTed must equal, within PCTR_ATOL, the evaluate
   path on the step-2 tables (#1 and #2) and an in-process
   `ServeRunner.predict_rows` (which launches no kernel: serving is
   row-major); SIGTERM must exit 0. It prints requests/s, rows/s, the
   client's p50/p90/p99, the mean batch fill, the reload's seconds and
   the windows' p99 around the swap against the others; in process, at
   each rung `assemble_batch` and `predict` (host clock, with
   `to_device` and `.cpu()`), the forward (CUDA events) and the card's
   busy time of a predict (`torch.profiler`), and from these and the
   stream's batches an upper bound on the card's busy share of the
   closed loop; under a predict loop at rung 256, the predict's
   latency while idle, during a reload, during its parts one at a time
   (the npz read, the digest in place and of a `tobytes()` copy, the
   copy to the card) and while 16 threads parse about 1,000 requests/s
   at the default and a 0.5 ms GIL switch interval, with the card's memory before, at
   the peak and after (the old generation must be returned); and phase
   13's FFM checkpoint through one `load()`;
15. the serving fleet on the card (`run_fleet`), over phase 14's two FM
   states: `python -m xflow_tpu_torch serve-fleet --device cuda` with 3
   replicas and phase 14's serve settings, each replica's pid on the
   card (nvidia-smi's compute apps, or where they do not name this
   namespace's pids, each pid's open /dev/nvidia* files and the card's
   memory in use before and after), the fleet process not on it. The
   drill, after the JAX package's `tools/smoke_serve_fleet.sh`: the
   closed loop (16 connections, 1-8 rows, client retries) for 15 s
   while replica 1 kills itself after 25 batches, a step 2 with a
   bitflip only the digest sees commits at 4 s and a good step 3 at 8
   s: 0 failed and 0 deadline-exceeded requests, steps [1, 3],
   reload_failed in the replica streams, replica 1 back at gen 1,
   /healthz 3 healthy on step 3, circuit_open and circuit_close in the
   router stream, 256 rows through the router equal to the evaluate path
   on step 3 within PCTR_ATOL, and SIGTERM exits 0 after the router's
   drain. Then the same closed loop for 10 s, no faults, against fleets
   of 1, 2 and 4 replicas and the bare `serve`: requests/s, rows/s,
   p50/p99, the windows' device and queue-wait p99, and the CPU seconds
   of the router, each replica and the client (/proc/<pid>/stat) over
   the loop's wall time, which say which process sets the pace.

The last three lines of standard output: the card line, the kernels
JSON (each entry with `share_of_bound` = bound_ms / ms; the row sum's
`widths` hold its entry at each of ch 24, 32, 104, 128 and 136; #1, #3
and #4 carry their FFM figures and launches under `ffm`), and
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
# the rate shard: one epoch of RATE_BATCHES steps, so the rates and the
# stage breakdowns pay an epoch's start (the prefetch thread, the MT
# parser's pool, the cache's digest check) once, not every 2 steps
RATE_BATCHES = 20
PYTHON_BATCHES = 2  # the Python parser's before column reads the rate shard's first batches
# FFM at bench.py's practical shape (`bench.py:271-273, 473-474`): k = 4
# over the same 18 fields (K = 73), 131,072-row batches, so the shard is
# one batch and the rate shard ten
FFM_V_DIM, FFM_BATCH = 4, 2 * BATCH
FFM_V_SCALE = 0.05  # the restored FFM state's init scale, as FM's


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


def ftrl_errs(got, want, prev, hp, what: str, leaves: bool = True,
              flips: bool = False) -> dict:
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
      `v`.

    With `flips`, w's leaf error leaves out the entries where the
    lazy-init guard ran on one side only (counted as `lazy_flips`): a
    (slot, channel) sum whose terms cancel to exactly 0 on one side
    keeps w there, while the other side's sum, of terms that differ in a
    last bit, is a few ulps off 0 and moves w by the rule. Two terms of
    unit scale cancel exactly about once in 2^24 sums, so at FFM's 10^8
    sums a step makes a few such entries; `g` holds their gradients to
    agree all the same."""
    import torch

    from xflow_tpu_torch.optim.ftrl import weight_of

    # compared on got's device (the card's elementwise float32 ops round as
    # the CPU's do); each side's implied g on its own device, with its sqrt
    dev = got[2].device
    want_d, prev_d = (tuple(t.to(dev) for t in ts) for ts in (want, prev))
    errs = {name: rel_err(a, b, FTRL_FLOOR) for name, a, b in zip("wnz", got, want_d)}

    def implied_g(out):
        w, n, z = (p.to(out[2].device) for p in prev)
        return (out[2] - z) + (torch.sqrt(out[1]) - torch.sqrt(n)) / hp.alpha * w

    g_want = implied_g(want).to(dev)
    scale = g_want.abs().max().item()
    if not scale > 0:
        fail(f"{what}: the FTRL step moved no z: the gradient is all zero")
    g_got = implied_g(got)
    mag = torch.maximum(want_d[2].abs(), prev_d[2].abs())
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
    w, n, z = prev_d
    # the lazy-init guard ran where the step left n = 0 and z as they were
    # (a gradient whose square underflows leaves n' = 0 but moves z)
    lazy = (n == 0) & (n_new == 0) & (z_new == z)
    rule = weight_of(z_new, n_new, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)
    floor = max(1e-2 * rule[~lazy].abs().max().item(), 1e-30)
    errs["w_rule"] = rel_err(w_new, torch.where(lazy, w, rule), floor)
    if flips:
        w_want, n_want, z_want = want_d
        flip = lazy ^ ((n == 0) & (n_want == 0) & (z_want == z))
        errs["w"] = rel_err(torch.where(flip, w, w_new), torch.where(flip, w, w_want),
                            FTRL_FLOOR)
        errs["lazy_flips"] = int(flip.sum())
    gated = errs if leaves else {k: errs[k] for k in ("g", "w_rule")}
    gated = {k: v for k, v in gated.items() if k != "lazy_flips"}
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
    32 B sectors that hold the distinct rows it touches (a 4K-byte row
    spans at most ceil(4K / 32) + 1 of them), the output written once."""
    import torch

    u = torch.unique(sorted_slots.long())
    first = (u * K * 4) // 32
    last = (u * K * 4 + K * 4 - 1) // 32
    span = range(-(-4 * K // 32) + 1)
    sectors = torch.cat([first + d for d in span])
    keep = torch.cat([first + d <= last for d in span])
    n_sectors = torch.unique(sectors[keep]).numel()
    np_ = sorted_slots.numel()
    return np_ * 4 + n_sectors * 32 + K8 * np_ * 4


def write_state(ck_dir: str, name: str, K: int, scale: float, seed: int, step: int = 1) -> int:
    """A committed training checkpoint (at `step`) of one [2^22, K] table ~
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
    save_state(ck_dir, {name: t}, {name: {"n": n, "z": z}}, step=step)
    return 3 * t.nbytes


def make_inputs(work: str, cfg) -> tuple[str, str]:
    """The full training checkpoint (step 1), the shard `<work>/data-00000`,
    the rate shard `<work>/rate-00000` (RATE_BATCHES batches, the JAX
    bulk writer's data) and their `.xfc` caches in cfg.data.cache_dir,
    packed by the port's `build_cache`. Returns the two shards' paths."""
    from xflow_tpu_torch.data.shardcache import build_cache
    from xflow_tpu_torch.data.synth import generate_shards, generate_shards_bulk

    t0 = time.perf_counter()
    nbytes = write_state(cfg.train.checkpoint_dir, "wv", 1 + V_DIM, 0.05, SEED)
    t_ck = time.perf_counter() - t0
    t0 = time.perf_counter()
    (path,) = generate_shards(
        os.path.join(work, "data"), 1, SHARD_ROWS, num_fields=NUM_FIELDS,
        ids_per_field=IDS_PER_FIELD, seed=SEED,
    )
    t1 = time.perf_counter()
    (rate_path,), _ = generate_shards_bulk(
        os.path.join(work, "rate"), 1, RATE_BATCHES * BATCH, num_fields=NUM_FIELDS,
        ids_per_field=IDS_PER_FIELD, seed=SEED + 2,
    )
    print(f"# inputs: checkpoint {nbytes / 1e6:.1f} MB in {t_ck:.1f} s, "
          f"shard {os.path.getsize(path) / 1e6:.1f} MB in {t1 - t0:.1f} s, rate shard "
          f"{os.path.getsize(rate_path) / 1e6:.1f} MB ({RATE_BATCHES * BATCH} rows) in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    for p, rows in ((path, SHARD_ROWS), (rate_path, RATE_BATCHES * BATCH)):
        t0 = time.perf_counter()
        stats = build_cache(p[: -len("-00000")], cfg.data)
        if (stats["shards"], stats["rows"]) != (1, rows):
            fail(f"build_cache packed {stats}, expected 1 shard of {rows} rows")
        print(f"# .xfc cache: {stats} in {time.perf_counter() - t0:.2f} s", flush=True)
    return path, rate_path


def input_sources(cfg) -> dict:
    """The configurations that read a shard from each source: its text
    through the native MT parser and its `.xfc` cache (built by `main`
    into cfg.data.cache_dir)."""
    from xflow_tpu_torch.config import override

    return {"text": override(cfg, **{"data.cache": "off"}),
            "xfc": override(cfg, **{"data.cache": "on"})}


def python_batches(path, cfg):
    """The first PYTHON_BATCHES batches of `path` by the Python parser
    (`libffm.iter_examples`, batched), the input before the port had a
    native plane; no path of the port reads through it."""
    import itertools

    from xflow_tpu_torch.data.libffm import iter_examples
    from xflow_tpu_torch.data.pipeline import examples_to_batches

    d = cfg.data
    return itertools.islice(examples_to_batches(
        iter_examples(path, d.log2_slots, d.hash_salt), d.batch_size, d.max_nnz),
        PYTHON_BATCHES)


def check_host_calls(calls: dict, what: str, source: str = "text", planned: bool = True) -> None:
    """The host input plane a path read through, from
    `pipeline.host_calls()` set to 0 just before it and read just after:
    batches of the native parser (or, `source` "xfc", of the `.xfc`
    cache), native plans where the path plans (`planned`), and not one
    row of the Python parser."""
    reader, other = (("native_stream", "cache_batches") if source == "text"
                     else ("cache_batches", "native_stream"))
    if calls[reader] < 1 or calls[other] or calls["python_rows"]:
        fail(f"{what} did not read through {reader} alone: host calls {calls}")
    if planned and calls["native_plan"] < 1:
        fail(f"{what} planned no batch with the native planner: host calls {calls}")


def first_arrays(cfg, path, device):
    """The first batch's host arrays, read through the input pipeline and
    planned by `batch_arrays` (the native planner), and their copies on
    `device`. The same batch is read from the shard's `.xfc` cache too:
    the batch and its arrays must be bitwise those of the text. Parse and
    plan of each are timed on the host clock (the first batch: the MT
    parser's start included)."""
    import numpy as np

    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, to_device

    pc = time.perf_counter
    got = {}
    for source, c in input_sources(cfg).items():
        t0 = pc()
        it = batch_iterator(path, c.data)
        batch = next(it)
        t1 = pc()
        host = batch_arrays(batch, c)
        got[source] = (batch, host, (t1 - t0) * 1e3, (pc() - t1) * 1e3)
        it.close()
    (tb, th, _, _), (cb, ch, _, _) = got["text"], got["xfc"]
    same = all(np.asarray(a).tobytes() == np.asarray(b).tobytes() for a, b in zip(tb, cb))
    same = same and th.keys() == ch.keys() and all(
        th[k].dtype == ch[k].dtype and th[k].tobytes() == np.asarray(ch[k]).tobytes() for k in th)
    if not same:
        fail(f"the first {cfg.model.name} batch or its arrays differ between the text and "
             "the .xfc cache")
    print(f"# first {cfg.model.name} batch, host clock: " + "; ".join(
        f"{s} parse {p:.3f} ms, plan {q:.3f} ms" for s, (_, _, p, q) in got.items())
        + " (bitwise equal)", flush=True)
    return th, to_device(th, device)


def check_gather(table, ss, what: str) -> dict:
    """#1 on `table [S, K]` and a plan's slots `ss`: bit-exact against its
    plain version with bf16 off and on; its time, its plain version's,
    `index_select` + transpose's, and its bound (`gather_bytes`)."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    K = table.shape[1]
    for bf16 in (False, True):
        got = st.gather_sorted_cuda(table, ss, bf16)
        want = st.gather_sorted_plain(table, ss, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_sorted{what} (bf16={bf16}) differs from its plain version: "
                 f"max abs err {(got - want).abs().max().item()}")
        print(f"# gather_sorted{what} bf16={bf16}: bit-exact over {tuple(got.shape)}",
              flush=True)
    g_bound, g_by = bound_ms(gather_bytes(ss, K, st._k8(K)), 0.0)
    return {
        "max_abs_err": (st.gather_sorted_cuda(table, ss)
                        - st.gather_sorted_plain(table, ss)).abs().max().item(),
        "ms": cuda_ms(lambda: st.gather_sorted_cuda(table, ss)),
        "plain_ms": cuda_ms(lambda: st.gather_sorted_plain(table, ss)),
        "bound_ms": g_bound, "bound_by": g_by,
        "library_ms": cuda_ms(lambda: torch.index_select(table, 0, ss).T.contiguous()),
    }


def check_kernels(cfg, gen, path) -> list:
    """The inference kernels against their plain versions on the
    evaluate path's inputs."""
    import torch

    from xflow_tpu_torch.models.fm import stack_channels
    from xflow_tpu_torch.ops import sorted_table as st

    _, arrays = first_arrays(cfg, path, DEVICE)
    table = gen.tables["wv"]
    ss = arrays["sorted_slots"]
    K, np_ = table.shape[1], ss.numel()
    if np_ != st.padded_len(BATCH * NUM_FIELDS):
        fail(f"plan length {np_} is not the full-width {st.padded_len(BATCH * NUM_FIELDS)}")

    results = [{
        "name": "gather_sorted", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/gather_sorted.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:775",
        **check_gather(table, ss, ""),
    }]
    occ_t = st.gather_sorted_cuda(table, ss)

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


def restored_state(cfg, device, restored=None):
    """The step-1 training checkpoint as a TrainState on `device`, from
    `restored` (the host arrays `restore_state` read once) where given."""
    import torch

    from xflow_tpu_torch.train.checkpoint import restore_state
    from xflow_tpu_torch.train.state import TrainState
    from xflow_tpu_torch.weights import table_shapes

    tables, opt, step, _ = restored or restore_state(
        cfg.train.checkpoint_dir, table_shapes(cfg), ("n", "z"))
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return TrainState(
        {k: put(v) for k, v in tables.items()},
        {k: {leaf: put(v) for leaf, v in d.items()} for k, d in opt.items()},
        step,
    )


def check_scatters(d_occ, ss, wo, w, n, z, hp, what: str) -> tuple[dict, dict]:
    """#4 and #3 on one path's occurrence cotangent `d_occ`, plan (`ss`,
    `wo`) and FTRL state (w, n, z), bf16 off and on: the scatter bitwise
    equal to its plain version on the CPU (which sums each slot's run in
    plan order, as the kernel does; on the card the plain version's
    atomics reorder sums) and across two launches; the fused scatter +
    FTRL against its plain version by `ftrl_errs`, with w of never-touched
    entries bitwise kept. Returns their entries: the times of each kernel,
    its plain version and a library call (`zeros` + `index_add_`; for #3
    the composition with the torch FTRL expression), `zeros_ms` (the
    dense write any scatter into a fresh output pays), and the bounds."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim.ftrl import update_one

    S, K = w.shape
    np_ = ss.numel()
    d_cpu, ss_cpu = d_occ.cpu(), ss.cpu()
    for bf16 in (False, True):
        got = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        again = st.scatter_sorted_cuda(d_occ, ss, wo, S, K, bf16)
        want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, K, bf16)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"scatter_sorted{what} (bf16={bf16}) gave different bits on two launches")
        got = got.cpu()
        if not torch.equal(got, want):
            fail(f"scatter_sorted{what} (bf16={bf16}) differs from its plain version on the "
                 f"CPU: max abs err {(got - want).abs().max().item()} "
                 f"(largest |want| {want.abs().max().item()})")
        print(f"# scatter_sorted{what} bf16={bf16}: bit-exact against the CPU plain version "
              f"and across two launches, over {tuple(got.shape)} "
              f"(largest |g| {want.abs().max().item():.3g})", flush=True)
        if not bf16:
            s_err = (got - want).abs().max().item()
    ss_l = ss.long()
    s_bound, s_by = bound_ms(S * K * 4 + K * np_ * 4 + np_ * 4 + wo.numel() * 4, K * np_)
    scatter = {
        "max_abs_err": s_err, "ms": cuda_ms(lambda: st.scatter_sorted_cuda(d_occ, ss, wo, S, K)),
        "plain_ms": cuda_ms(lambda: st.scatter_sorted_plain(d_occ, ss, S, K)),
        "bound_ms": s_bound, "bound_by": s_by,
        "library_ms": cuda_ms(
            lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T)),
        "zeros_ms": cuda_ms(lambda: torch.zeros((S, K), device=DEVICE)),  # the write floor
    }
    print(f"# scatter_sorted{what} {scatter['ms']:.4f} ms, zeros + index_add_ "
          f"{scatter['library_ms']:.4f} ms, zeros {scatter['zeros_ms']:.4f} ms, bound "
          f"{s_bound:.4f} ms", flush=True)

    for bf16 in (False, True):
        got = st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp, bf16)
        want = st.scatter_ftrl_plain(d_occ, ss, w, n, z, K, hp, bf16)
        g = st.scatter_sorted_plain(d_occ, ss, S, K, bf16)
        torch.cuda.synchronize()
        errs = ftrl_errs(got, want, (w, n, z), hp,
                         f"scatter_ftrl{what} (bf16={bf16}) against its plain version")
        lazy = (g == 0) & (n == 0)
        n_lazy = int(lazy.sum())
        if n_lazy == 0 or not torch.equal(got[0][lazy], w[lazy]):
            fail(f"scatter_ftrl{what} (bf16={bf16}) did not keep w of the {n_lazy} "
                 "never-touched (slot, channel) entries bitwise")
        print(f"# scatter_ftrl{what} bf16={bf16}: max err {errs} relative (w, n, z over a "
              f"{FTRL_FLOOR} floor; g, w_rule over 1e-2 of their largest magnitude) "
              f"(tolerance {FTRL_RTOL}); w kept bitwise on {n_lazy} lazy-init entries", flush=True)
        if not bf16:
            f_err = max((a - b).abs().max().item() for a, b in zip(got, want))

    def composition():
        g = torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T)
        return update_one(w, n, z, g, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)

    f_bound, f_by = bound_ms(
        6 * S * K * 4 + K * np_ * 4 + np_ * 4 + wo.numel() * 4,
        K * np_ + FTRL_OPS_PER_ELEMENT * S * K,
    )
    ftrl = {
        "max_abs_err": f_err,
        "ms": cuda_ms(lambda: st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp)),
        "plain_ms": cuda_ms(lambda: st.scatter_ftrl_plain(d_occ, ss, w, n, z, K, hp)),
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": cuda_ms(composition),
    }
    print(f"# scatter_ftrl{what} library_ms is a composition (index_add_ + the torch FTRL "
          f"expression): {ftrl['library_ms']:.4f} ms", flush=True)
    return scatter, ftrl


def check_train_kernels(cfg, path) -> list:
    """The training kernels against their plain versions on the training
    path's inputs (`check_scatters`), and one fused step on the card
    against the CPU's."""
    from xflow_tpu_torch.train.step import fused_cotangent

    state = restored_state(cfg, DEVICE)
    host, arrays = first_arrays(cfg, path, DEVICE)
    w, n, z = state.tables["wv"], state.opt_state["wv"]["n"], state.opt_state["wv"]["z"]
    _, d_occ = fused_cotangent(w, arrays, cfg)
    scatter, ftrl = check_scatters(d_occ, arrays["sorted_slots"], arrays["win_off"], w, n, z,
                                   cfg.optim.ftrl, "")
    step_card_vs_cpu(cfg, host, "fused", "the restored step-1 state")
    return [
        {"name": "scatter_sorted", "route": "cuda",
         "source": "xflow_tpu_torch/csrc/scatter_sorted.cu",
         "replaces": "xflow_tpu/ops/sorted_table.py:938", **scatter},
        {"name": "scatter_ftrl", "route": "cuda",
         "source": "xflow_tpu_torch/csrc/scatter_ftrl.cu",
         "replaces": "xflow_tpu/ops/sorted_table.py:1064", **ftrl},
    ]


def step_card_vs_cpu(cfg, host: dict, kind: str, what: str, leaves: bool = True,
                     restored=None, flips: bool = False) -> None:
    """One train step on the host arrays `host` from the checkpoint under
    cfg.train.checkpoint_dir (or `restored`, as in `restored_state`), on
    the card and on the CPU: the loss within LOSS_RTOL, the table's (w, n,
    z) by `ftrl_errs` (`leaves` and `flips` as there)."""
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.step import make_train_step

    model = get_model(cfg.model.name)(cfg)
    (tname,) = model.table_specs(cfg)  # "wv" (fused FM), "v" (MVM) or "w" (LR)
    step = make_train_step(model, get_optimizer("ftrl"), cfg)
    s_gpu, m_gpu = step(restored_state(cfg, DEVICE, restored), to_device(host, DEVICE))
    prev = restored_state(cfg, "cpu", restored)
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
                     cfg.optim.ftrl, f"{kind} step from {what}, card vs CPU", leaves, flips)
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


def run_slice(cfg, gen, path, rate_path) -> dict:
    """The evaluate path on the card, with the launch counts around it."""
    import numpy as np
    import torch

    from xflow_tpu_torch.data import pipeline
    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.serve.runner import ServeRunner

    st.reset_launches()
    pipeline.reset_host_calls()
    t0 = time.perf_counter()
    auc, ll = evaluate(cfg, gen.tables, path, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    calls = pipeline.host_calls()
    check_host_calls(calls, "the FM evaluate path")
    n_batches = -(-SHARD_ROWS // BATCH)
    for name in ("gather_sorted", "row_sums"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the evaluate path ({launches})")
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.0 <= auc <= 1.0 and ll < 0.0):
        fail(f"evaluate gave auc={auc} logloss={ll}")
    # the weights are random, so an AUC near 0.5 is what a right path gives
    print(f"# evaluate on cuda: auc={auc} logloss={ll} over {n_batches} batches, "
          f"{wall / n_batches * 1e3:.1f} ms per batch end to end (host parse + plan + "
          f"forward); launches {launches}; host calls {calls}", flush=True)

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

    stage_breakdown(cfg, gen, rate_path)
    return launches


def stage_breakdown(cfg, gen, path) -> None:
    """Where an evaluate batch's time goes, from each input source (the
    text through the MT parser, the `.xfc` cache, and, the before column,
    the text through the Python parser over its first PYTHON_BATCHES
    batches): host clock per stage over the rate shard `path`, one stage
    after another with no prefetch (each device stage ends in a
    synchronize), and the forward's CUDA-event time on one resident
    batch."""
    import torch

    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.models.predict import make_predict_fn

    step = make_predict_fn(get_model(cfg.model.name)(cfg))
    pc = time.perf_counter
    sources = {s: (c, batch_iterator(path, c.data, enforce_bad_rows=False, quarantine=False))
               for s, c in input_sources(cfg).items()}
    sources["python"] = (cfg, python_batches(path, cfg))
    for source, (c, it) in sources.items():
        acc = dict.fromkeys(("parse", "plan", "to_device", "forward", "to_host"), 0.0)
        n = 0
        while True:
            t = pc()
            batch = next(it, None)
            acc["parse"] += pc() - t
            if batch is None:
                break
            t = pc()
            host = batch_arrays(batch, c)
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
        print(f"# evaluate stages ({source}, {n} batches), ms per batch (host clock): "
              + ", ".join(f"{k} {v / n * 1e3:.3f}" for k, v in acc.items()), flush=True)
    fwd_ms = cuda_ms(lambda: step(gen.tables, arrays), reps=10)
    print(f"# forward on the card (CUDA events): {fwd_ms:.3f} ms per {BATCH}-row batch",
          flush=True)


def train_cli(prefix: str, ckpt_dir: str, epochs: int, *extra: str,
              model: str | None = "fm", source: str = "text") -> tuple[dict, dict]:
    """`python -m xflow_tpu_torch train` in process on the card (`model`
    None: no `--model`, the CLI's default), with the launch counts and
    the host input plane's call counts set to 0 just before and read just
    after: the run must have read through `source` ("text": the native
    parser; "xfc": the shard's cache) and the native planner (LR plans
    nothing), never the Python parser. Returns (summary with its
    `host_calls`, launches); the CLI's own stdout is echoed as comments.
    An empty `ckpt_dir` writes no checkpoint."""
    import torch

    from xflow_tpu_torch.__main__ import main as cli
    from xflow_tpu_torch.data import pipeline
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
    pipeline.reset_host_calls()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    calls = pipeline.host_calls()
    for line in out.getvalue().splitlines():
        print(f"#   {line}")
    if rc != 0:
        fail(f"train {' '.join(extra)} exited {rc}")
    what = f"train --model {model or '(the default)'} {' '.join(extra)}"
    check_host_calls(calls, what, source, planned=model not in (None, "lr"))
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    summary["host_calls"] = calls
    print(f"# {what}: {wall:.1f} s wall, {summary['examples_per_sec']} examples/s, "
          f"launches {launches}, host calls {calls}", flush=True)
    return summary, launches


def run_training(cfg, work: str, path: str, rate_path: str) -> tuple[dict, dict]:
    """The training main path, the rate runs over the rate shard, the
    two-pass epoch, and train -> serve."""
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

    rates = {}
    for source, extra in (("text", ()), ("xfc", ("--set", "data.cache=on", "--set",
                                                 f"data.cache_dir={cfg.data.cache_dir}"))):
        s, rate_launches = train_cli(rate_path[: -len("-00000")], "", 1, *extra,
                                     source=source)
        if s["steps"] != RATE_BATCHES or s["bad_steps"] or any(
                rate_launches[k] < 1 for k in ("gather_sorted", "row_sums", "scatter_ftrl")):
            fail(f"the FM rate run from {source}: summary {s}, launches {rate_launches}")
        rates[source] = s["examples_per_sec"]
    print(f"# train --model fm over one epoch of the rate shard ({RATE_BATCHES} steps): "
          f"{rates['text']} examples/s from the text (MT parser), {rates['xfc']} from the "
          f".xfc cache; the 2-epoch main path {summary['examples_per_sec']}", flush=True)

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
    train_breakdown(tcfg, rate_path, "fused")
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
    """Where a train step's time goes, from the text through the MT parser
    and from the `.xfc` cache: host clock per stage over the rate shard
    `path` (RATE_BATCHES batches) from a
    fresh state, one stage after another with no prefetch (each device
    stage ends in a synchronize), and the step's CUDA-event time on one
    resident batch."""
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, ffm_takes_aligned, to_device
    from xflow_tpu_torch.models.ffm import ffm_invperm
    from xflow_tpu_torch.train.step import make_train_step
    from xflow_tpu_torch.train.trainer import Trainer

    pc = time.perf_counter
    ffm = cfg.model.name == "ffm"
    for source, c in input_sources(cfg).items():
        trainer = Trainer(override(c, **{"train.checkpoint_dir": ""}), device=DEVICE)
        acc = dict.fromkeys(("parse", "plan", "to_device", "step"), 0.0)
        if ffm:  # FFM's routing and placement, timed again on their own
            acc["of the plan, route + ffm_invperm"] = 0.0
        n = 0
        it = batch_iterator(path, c.data)
        while True:
            t = pc()
            batch = next(it, None)
            acc["parse"] += pc() - t
            if batch is None:
                break
            t = pc()
            host = batch_arrays(batch, c)
            acc["plan"] += pc() - t
            if ffm:
                t = pc()
                ffm_takes_aligned(batch, c)
                ffm_invperm(host["sorted_row"], host["sorted_fields"], host["sorted_mask"],
                            len(batch.labels), c.model.num_fields)
                acc["of the plan, route + ffm_invperm"] += pc() - t
            t = pc()
            arrays = to_device(host, DEVICE)
            torch.cuda.synchronize()
            acc["to_device"] += pc() - t
            t = pc()
            trainer.state, _ = trainer.train_step(trainer.state, arrays)
            torch.cuda.synchronize()
            acc["step"] += pc() - t
            n += 1
        print(f"# {cfg.model.name} {kind} train stages ({source}, {n} batches), ms per batch "
              "(host clock): "
              + ", ".join(f"{k} {v / n * 1e3:.3f}" for k, v in acc.items()), flush=True)
    state = trainer.state
    step_ms = cuda_ms(lambda: trainer.train_step(state, arrays), reps=10)
    unguarded = make_train_step(
        trainer.model, trainer.optimizer, override(cfg, **{"train.nonfinite_guard": "off"})
    )
    off_ms = cuda_ms(lambda: unguarded(state, arrays), reps=10)
    print(f"# {cfg.model.name} {kind} train step on the card (CUDA events): {step_ms:.3f} ms per "
          f"{cfg.data.batch_size}-row batch; {off_ms:.3f} ms with the non-finite guard off "
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


def run_mvm_training(mcfg, work: str, path: str, rate_path: str) -> dict:
    """The MVM main paths through the train CLI, then train -> serve on
    the segment run's checkpoint and the segment step's breakdown.
    Returns the segment run's launch counts."""
    import math

    import numpy as np

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data import pipeline
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
    pipeline.reset_host_calls()
    auc, ll = evaluate(scfg, gen.tables, path, device=DEVICE)
    launches = dict(st.LAUNCHES)
    check_host_calls(pipeline.host_calls(), "MVM evaluate")
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
    train_breakdown(scfg, rate_path, "segment")
    print(f"# mvm launches: product {product}, fused {fused}, segment {segment}", flush=True)
    return segment


def ffm_config(cfg, ck_dir: str, **extra):
    """FFM at bench.py's practical shape: 18 one-feature-per-field fields,
    k = 4, the fused `wv [2^22, 73]`, 131,072-row batches, FTRL."""
    from xflow_tpu_torch.config import override

    return override(cfg, **{"model.name": "ffm", "model.v_dim": FFM_V_DIM,
                            "data.batch_size": FFM_BATCH, "train.checkpoint_dir": ck_dir,
                            **extra})


def check_ffm_kernels(fcfg, arrays, restored) -> dict:
    """#1, #4 and #3 at FFM's width (K = 73, K8 = 80) on the FFM path's own
    inputs: the first batch's flat plan and the fused step's occurrence
    cotangent on the restored state, by `check_gather` and
    `check_scatters`. Returns their entries by name."""
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.train.step import fused_cotangent

    state = restored_state(fcfg, DEVICE, restored)
    w, n, z = state.tables["wv"], state.opt_state["wv"]["n"], state.opt_state["wv"]["z"]
    ss, wo = arrays["sorted_slots"], arrays["win_off"]
    K = w.shape[1]
    out = {"gather_sorted": check_gather(w, ss, " at FFM's K = 73")}
    _, d_occ = fused_cotangent(w, arrays, fcfg)
    if d_occ.shape != (st._k8(K), ss.numel()) or d_occ[K:].any() or not d_occ[:K].any():
        fail(f"the FFM occurrence cotangent {tuple(d_occ.shape)} is not [80, Np] with "
             "rows 73..80 zero and a nonzero gradient")
    out["scatter_sorted"], out["scatter_ftrl"] = check_scatters(
        d_occ, ss, wo, w, n, z, fcfg.optim.ftrl, " at FFM's K = 73")
    return out


def run_ffm(cfg, work: str, path: str, rate_path: str) -> dict:
    """Phase 13, FFM: the kernels at K = 73 (`check_ffm_kernels`), one
    fused and one two-pass step on the card against the CPU, the
    repeated-field batch on the row-major route, the train CLI's main
    path, rate run and two-pass epoch, evaluate and `predict_rows` of the
    trained checkpoint, and the train step's stage breakdown. Every path
    has the launch counts, the FFM routes and the host calls set to 0
    just before and read just after. Returns the three kernels' FFM
    entries, each with the launches of its FFM main path."""
    import math

    import numpy as np

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data import pipeline
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, evaluate, to_device
    from xflow_tpu_torch.models import ffm, get_model
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.serve.runner import ServeRunner
    from xflow_tpu_torch.train.checkpoint import restore_state
    from xflow_tpu_torch.train.step import make_train_step
    from xflow_tpu_torch.weights import table_shapes

    fcfg = ffm_config(cfg, os.path.join(work, "ck_ffm"))
    K = 1 + NUM_FIELDS * FFM_V_DIM
    laps = [time.perf_counter()]

    def lap(what: str) -> None:  # the phase's own time, part by part
        laps.append(time.perf_counter())
        print(f"# ffm phase: {what} in {laps[-1] - laps[-2]:.1f} s", flush=True)

    nbytes = write_state(fcfg.train.checkpoint_dir, "wv", K, FFM_V_SCALE, SEED + 3)
    lap(f"the state's {nbytes / 1e6:.1f} MB written")
    restored = restore_state(fcfg.train.checkpoint_dir, table_shapes(fcfg), ("n", "z"))
    lap("the state restored")

    def counts_are(launches: dict, want: dict, what: str) -> None:
        got = {k: v for k, v in launches.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(f"{what} launched {launches}, expected {want} and nothing else")

    # --- the first batch (the whole shard): its wire plan, and the kernels on it
    ffm.reset_routes()
    host, arrays = first_arrays(fcfg, path, DEVICE)
    if ffm.ROUTES != {"aligned": 2, "row_major": 0} or arrays["sorted_slots"].ndim != 1:
        fail(f"the FFM batch did not plan flat and aligned from the text and the cache: "
             f"routes {ffm.ROUTES}, arrays {sorted(host)}")
    rows_wire = np.int32 if FFM_BATCH > 1 << 16 else np.uint16  # the u16 row bound
    if (host["sorted_row"].dtype, host["sorted_fields"].dtype, host["ffm_invperm"].shape) != (
            rows_wire, np.uint8, (FFM_BATCH, NUM_FIELDS)):
        fail(f"FFM wire plan: rows {host['sorted_row'].dtype}, fields "
             f"{host['sorted_fields'].dtype}, placement {host['ffm_invperm'].shape}")
    if arrays["sorted_slots"].numel() != st.padded_len(FFM_BATCH * NUM_FIELDS):
        fail(f"FFM plan length {arrays['sorted_slots'].numel()} is not the full width")
    kern = check_ffm_kernels(fcfg, arrays, restored)
    lap("the first batch and the kernels at K = 73")

    # --- one fused and one two-pass step, card against CPU, and their times
    state, batch_dev, step_ms = restored_state(fcfg, DEVICE, restored), to_device(host, DEVICE), {}
    for kind, extra, scatter in (("fused", {}, "scatter_ftrl"),
                                 ("two-pass", {"optim.fused_scatter": "off"}, "scatter_sorted")):
        c = override(fcfg, **extra)
        st.reset_launches()
        step_card_vs_cpu(c, host, f"ffm {kind}", "the restored FFM step-1 state",
                         restored=restored, flips=True)
        counts_are(st.LAUNCHES, {"gather_sorted": 1, scatter: 1}, f"the ffm {kind} step")
        step = make_train_step(get_model("ffm")(c), get_optimizer("ftrl"), c)
        step_ms[kind] = cuda_ms(lambda step=step: step(state, batch_dev), reps=5, warmup=1)
    del state, batch_dev
    print(f"# ffm train step on the card (CUDA events, guard on): fused {step_ms['fused']:.3f} "
          f"ms, two-pass {step_ms['two-pass']:.3f} ms per {FFM_BATCH}-row batch", flush=True)

    # --- the first batch with field 0 repeated in column 1: row-major, no kernel
    it = batch_iterator(path, fcfg.data)
    batch = next(it)
    it.close()
    fields = batch.fields.copy()
    fields[:, 1] = 0
    ffm.reset_routes()
    dup = batch_arrays(batch._replace(fields=fields), fcfg)
    if "slots" not in dup or "sorted_slots" in dup or ffm.ROUTES != {"aligned": 0,
                                                                     "row_major": 1}:
        fail(f"the repeated-field FFM batch did not route row-major: {sorted(dup)}, "
             f"routes {ffm.ROUTES}")
    st.reset_launches()
    step_card_vs_cpu(fcfg, dup, "ffm row-major (field 0 repeated)",
                     "the restored FFM step-1 state", restored=restored, flips=True)
    counts_are(st.LAUNCHES, {}, "the row-major ffm step")
    del restored
    lap("three steps, card vs CPU, and two timed")

    # --- the train CLI: main path (fused), a rate run, a two-pass epoch
    fargs = ("--set", f"model.v_dim={FFM_V_DIM}", "--set", f"data.batch_size={FFM_BATCH}")

    def train(prefix, ck, epochs, *extra, source="text"):
        ffm.reset_routes()
        summary, launches = train_cli(prefix, ck, epochs, *fargs, *extra, model="ffm",
                                      source=source)
        return summary, launches, dict(ffm.ROUTES)

    n_batches = -(-SHARD_ROWS // FFM_BATCH)
    ck = os.path.join(work, "ck_ffm_train")
    summary, main_path, routes = train(path[: -len("-00000")], ck, 2)
    steps = 2 * n_batches
    if (summary["steps"], summary["bad_steps"]) != (steps, 0) or not math.isfinite(
            summary["last_loss"]) or routes != {"aligned": steps, "row_major": 0}:
        fail(f"ffm train summary {summary}, routes {routes}")
    counts_are(main_path, {"gather_sorted": steps, "scatter_ftrl": steps}, "the FFM main path")
    rate_steps = RATE_BATCHES * BATCH // FFM_BATCH
    rate, rate_launches, routes = train(rate_path[: -len("-00000")], "", 1)
    if rate["steps"] != rate_steps or rate["bad_steps"] or routes["row_major"]:
        fail(f"the FFM rate run: summary {rate}, routes {routes}")
    counts_are(rate_launches, {"gather_sorted": rate_steps, "scatter_ftrl": rate_steps},
               "the FFM rate run")
    _, two_pass, routes = train(path[: -len("-00000")], "", 1, "--set",
                                "optim.fused_scatter=off")
    counts_are(two_pass, {"gather_sorted": n_batches, "scatter_sorted": n_batches},
               "the FFM two-pass epoch")
    print(f"# ffm train: {summary['examples_per_sec']} examples/s over the 2-epoch main path "
          f"({steps} steps), {rate['examples_per_sec']} over one epoch of the rate shard "
          f"({rate_steps} steps of {FFM_BATCH} rows, text); launches: main {main_path}, "
          f"rate {rate_launches}, two-pass {two_pass}", flush=True)
    lap("the train CLI runs")

    # --- evaluate and serve the trained checkpoint
    tcfg = override(fcfg, **{"train.checkpoint_dir": ck})
    runner = ServeRunner(tcfg, device=DEVICE)
    gen = runner.load()
    if gen.step != steps:
        fail(f"the FFM checkpoint serves step {gen.step}, expected {steps}")
    st.reset_launches()
    ffm.reset_routes()
    pipeline.reset_host_calls()
    auc, ll = evaluate(tcfg, gen.tables, path, device=DEVICE)
    launches, calls = dict(st.LAUNCHES), pipeline.host_calls()
    check_host_calls(calls, "FFM evaluate")
    counts_are(launches, {"gather_sorted": n_batches}, "FFM evaluate")
    if ffm.ROUTES != {"aligned": n_batches, "row_major": 0}:
        fail(f"FFM evaluate routes {ffm.ROUTES}")
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.0 <= auc <= 1.0):
        fail(f"the trained FFM model evaluates to auc={auc} logloss={ll}")
    _, p_eval = first_batch(tcfg, gen.tables, path, DEVICE)
    with open(path) as f:
        rows = [next(f).split("\t", 1)[1].strip() for _ in range(64)]
    served, _ = runner.predict_rows(rows)
    ds = float(np.abs(served - p_eval[:64]).max())
    if not ds <= PCTR_ATOL:
        fail(f"FFM predict_rows (row-major) differs from evaluate (aligned) by {ds}")
    print(f"# ffm train -> serve: step {gen.step}, auc={auc} logloss={ll} on the training "
          f"shard; evaluate launches {launches}; predict_rows on 64 rows vs evaluate: max abs "
          f"diff {ds}", flush=True)
    del gen, runner
    lap("evaluate and serve")
    train_breakdown(tcfg, rate_path, "fused")
    lap("the stage breakdown")

    out = {}
    for name, launched in (("gather_sorted", main_path), ("scatter_ftrl", main_path),
                           ("scatter_sorted", two_pass)):
        e = dict(kern[name], launches=launched[name])
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        out[name] = e
    return out


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
    print(f"# lab mosaic + rowsum: {time.perf_counter() - t0:.1f} s, launches {launches}; "
          f"launch floor {mosaic['floor_ms']} ms by {mosaic['floor_by']}", flush=True)
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
    t0 = time.perf_counter()
    cores = len(os.sched_getaffinity(0))
    caps = ",".join(str(c) for c in (1, 2, 4, 8, 16) if c <= max(cores, 1))
    host = echo(lambda: bench_lab.suite_hostplane(["--caps", caps]))
    print(f"# lab hostplane (host only, {cores} usable cores): {time.perf_counter() - t0:.1f} s, "
          + ", ".join(f"{k} {v}" for k, v in host.items()), flush=True)

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
            "floor_ms": mosaic["floor_ms"],
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


SERVE_LADDER = "32,64,128,256"
SERVE_MAX_BATCH = 256
SERVE_SECONDS, SERVE_SWAP_AT, SERVE_CONNECTIONS = 15.0, 5.0, 16


def stage_step(src: str, dst: str, step: int, link: bool = False) -> str:
    """Copy committed step `step` of `src` into `dst` under a staging name
    (hard links with `link`); returns that name. `os.replace` of it onto
    `step_<N>` commits it in one rename, as a checkpoint shipper does."""
    import shutil

    os.makedirs(dst, exist_ok=True)
    tmp = os.path.join(dst, f".staging_step_{step}")
    shutil.copytree(os.path.join(src, f"step_{step}"), tmp,
                    copy_function=os.link if link else shutil.copy2)
    return tmp


def commit_step(tmp: str, step: int) -> None:
    os.replace(tmp, os.path.join(os.path.dirname(tmp), f"step_{step}"))


def serve_windows(recs: list, reload_span: dict) -> tuple[list, list]:
    """The serve stream's window records split into those that overlap the
    reload span (from its start to its end, widened by one window) and
    the others. A window record is stamped at its flush, covering the
    `window_s` before it."""
    t0 = reload_span["t0"]
    t1 = t0 + reload_span["dur_ms"] / 1e3
    around, others = [], []
    for r in recs:
        if r.get("kind") != "serve" or "requests" not in r:
            continue
        lo, hi = r["ts"] - r["window_s"], r["ts"]
        (around if lo <= t1 + r["window_s"] and hi >= t0 else others).append(r)
    return around, others


def request_group(fields: list, slots: list) -> list:
    """Rows as a group of requests of 1, 2, ..., 8, 1, ... rows, as the
    closed loop sends them."""
    from xflow_tpu_torch.serve.coalescer import PendingRequest

    group, lo, n = [], 0, 1
    while lo < len(fields):
        group.append(PendingRequest(fields=fields[lo:lo + n], slots=slots[lo:lo + n]))
        lo, n = lo + n, n % 8 + 1
    return group


def device_busy_ms(fn, reps: int = 20):
    """The card's busy time of one fn() by `torch.profiler`: the sum of
    the kernels' and copies' own device time over `reps` calls, a call;
    None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / reps / 1e3 if busy_us > 0 else None


def run_serve(cfg, work: str, path: str, card: str) -> None:
    """Phase 14, the online server on the card: `python -m xflow_tpu_torch
    serve --device cuda` at FM's full width over a committed step 1,
    driven closed-loop by the port's `serve_bench` (16 connections, 1-8
    rows a request from the shard) while step 2 commits by one rename
    about 5 s in: the answers flip from step 1 to step 2 with no failed
    request, `/healthz` reports step 2, and the serve stream holds
    complete windows and a reload event. 256 served rows equal the
    evaluate path (#1 and #2) and an in-process `predict_rows` (no kernel
    launch) within PCTR_ATOL; SIGTERM exits 0. Then in process: each
    rung's assemble, forward, predict and card busy time, and the card's
    busy share of the closed loop they bound; under a predict loop, a
    reload, its parts, the two digest forms and threads parsing at two
    GIL switch intervals, with the card's memory before, at the peak and
    after; and the FFM checkpoint of phase 13 through one `load()`."""
    import http.client
    import select
    import signal
    import threading
    import zlib

    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.serve.coalescer import PendingRequest, assemble_batch
    from xflow_tpu_torch.serve.metrics import SERVE_WINDOW_KEYS
    from xflow_tpu_torch.serve.runner import ServeRunner, parse_rows
    from xflow_tpu_torch.tools import serve_bench
    from xflow_tpu_torch.train import checkpoint as ckpt
    from xflow_tpu_torch.weights import table_shapes

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    laps = [time.perf_counter()]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        print(f"# serve phase: {what} in {laps[-1] - laps[-2]:.1f} s", flush=True)

    src, serving = os.path.join(work, "ck_serve_src"), os.path.join(work, "ck_serving")
    for step in (1, 2):
        write_state(src, "wv", 1 + V_DIM, 0.05, SEED + 3 + step, step=step)
    commit_step(stage_step(src, serving, 1), 1)
    staged = stage_step(src, serving, 2)
    lap("two full-width FM states written, step 1 committed for serving")

    metrics, errlog = os.path.join(work, "serve.jsonl"), os.path.join(work, "serve.err")
    argv = [sys.executable, "-m", "xflow_tpu_torch", "serve", "--device", DEVICE,
            "--checkpoint-dir", serving, "--model", "fm", "--log2-slots", str(LOG2_SLOTS),
            "--port", "0", "--window-ms", "2", "--max-batch", str(SERVE_MAX_BATCH),
            "--poll-s", "0.5", "--metrics-path", metrics,
            "--set", f"serve.ladder={SERVE_LADDER}", "--set", f"model.v_dim={V_DIM}",
            "--set", f"model.num_fields={NUM_FIELDS}", "--set", f"data.max_nnz={NUM_FIELDS}",
            "--set", "serve.metrics_every_s=0.5", "--set", "serve.trace_sample_rate=0.01"]
    with open(errlog, "w") as err:
        proc = subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        if not select.select([proc.stdout], [], [], 180)[0]:
            fail("the server printed no ready line within 180 s")
        line = proc.stdout.readline()
        if not line:
            fail(f"the server exited {proc.wait(timeout=30)} before its ready line: "
                 f"{open(errlog).read()[-2000:]}")
        ready = json.loads(line)
        if ready["device"] != torch.cuda.get_device_name(0) or ready["step"] != 1:
            fail(f"ready line {ready}: expected step 1 on {torch.cuda.get_device_name(0)}")
        url = f"http://127.0.0.1:{ready['port']}"
        print(f"# serve: ready {ready}", flush=True)
        lap("the server started (CUDA context, load, warmup of 4 rungs)")

        args = serve_bench.build_parser().parse_args([
            "--url", url, "--duration", str(SERVE_SECONDS),
            "--concurrency", str(SERVE_CONNECTIONS), "--data", path,
            "--rows-per-request", "1-8", "--trace"])
        t_start = time.perf_counter()
        swap = threading.Timer(SERVE_SWAP_AT, commit_step, (staged, 2))
        swap.start()
        try:
            rep = serve_bench.run(args)
        finally:
            swap.cancel()
            swap.join(timeout=30)
        print(f"# serve_bench: {json.dumps(rep)}", flush=True)
        if (rep["errors"], rep["trace_echo_miss"], rep["generations"], rep["steps"]) != (
                0, 0, [1, 2], [1, 2]):
            fail(f"closed loop over the reload: errors {rep['errors']} "
                 f"({rep['first_error']}), echo misses {rep['trace_echo_miss']}, "
                 f"generations {rep['generations']}, steps {rep['steps']}")
        flip_s = rep["gen_flip_t"][0]
        lap(f"{SERVE_SECONDS:.0f} s of closed-loop load over the reload")

        conn = http.client.HTTPConnection("127.0.0.1", ready["port"], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        if (health["step"], health["generation"]) != (2, 2):
            fail(f"/healthz after the reload: {health}")
        with open(path) as f:
            rows = [next(f).split("\t", 1)[1].strip() for _ in range(SERVE_MAX_BATCH)]
        conn.request("POST", "/predict", json.dumps({"rows": rows}))
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
        if resp.status != 200 or payload["step"] != 2:
            fail(f"POST of {len(rows)} rows: HTTP {resp.status} {str(payload)[:300]}")
        served_http = np.asarray(payload["pctr"], np.float32)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            rc = "killed after 60 s"
    if rc != 0:
        fail(f"the server exited {rc} on SIGTERM: {open(errlog).read()[-2000:]}")
    lap("/healthz, 256 rows over HTTP, SIGTERM")

    # --- the serve stream
    recs = read_jsonl(metrics)
    windows = [r for r in recs if r.get("kind") == "serve" and "requests" in r]
    events = [r.get("event") for r in recs if r.get("kind") == "serve" and "event" in r]
    spans = [r for r in recs if r.get("kind") == "span" and r.get("name") == "reload"]
    incomplete = [r for r in windows if not set(SERVE_WINDOW_KEYS) <= r.keys()]
    if not windows or incomplete or "reload" not in events or len(spans) != 1:
        fail(f"serve stream: {len(windows)} windows ({len(incomplete)} incomplete), "
             f"events {events}, {len(spans)} reload spans")
    around, others = serve_windows(windows, spans[0])
    if not around or not others:
        fail(f"{len(around)} windows around the reload span, {len(others)} others")
    busy = [w for w in windows if w["rows"]]
    fill = sum(w["rows"] for w in busy) / sum(w["rows"] / w["batch_fill"] for w in busy)

    # --- parity: the card's evaluate path (#1, #2) and predict_rows, in process
    scfg = override(cfg, **{"train.checkpoint_dir": serving,
                            "serve.max_batch": SERVE_MAX_BATCH, "serve.ladder": SERVE_LADDER})
    runner = ServeRunner(scfg, device=DEVICE)
    gen = runner.load()
    st.reset_launches()
    _, p_eval = first_batch(scfg, gen.tables, path, DEVICE)
    eval_launches = {k: v for k, v in st.LAUNCHES.items() if v}
    st.reset_launches()
    served, sgen = runner.predict_rows(rows)
    serve_launches = {k: v for k, v in st.LAUNCHES.items() if v}
    if gen.step != 2 or set(eval_launches) != {"gather_sorted", "row_sums"} or serve_launches:
        fail(f"step {gen.step}; evaluate launched {eval_launches}, predict_rows "
             f"{serve_launches} (the serve path is row-major: none)")
    d_http = float(np.abs(served_http - p_eval[:SERVE_MAX_BATCH]).max())
    d_rows = float(np.abs(served - p_eval[:SERVE_MAX_BATCH]).max())
    if not (d_http <= PCTR_ATOL and d_rows <= PCTR_ATOL):
        fail(f"served pCTRs vs the card's evaluate: HTTP {d_http}, predict_rows {d_rows}")
    lap("parity in process")

    print(f"# serve on {card}: FM wv [2^{LOG2_SLOTS}, {1 + V_DIM}], ladder {SERVE_LADDER}, window 2 ms, "
          f"{SERVE_CONNECTIONS} connections closed loop, 1-8 rows a request, "
          f"{rep['duration_s']} s: {rep['value']} requests/s, {rep['rows_per_s']} rows/s, "
          f"{rep['requests']} requests, 0 failed; latency p50 {rep['p50_ms']} / p90 "
          f"{rep['p90_ms']} / p99 {rep['p99_ms']} ms (client clock); mean batch fill "
          f"{fill:.4f} over {len(busy)} windows; generations {rep['generations']}, flip "
          f"{flip_s:.2f} s in (step 2 committed at {SERVE_SWAP_AT:.1f} s)", flush=True)
    print(f"# serve reload: {spans[0]['dur_ms'] / 1e3:.3f} s restore + copy + swap of "
          f"{spans[0]['bytes'] / 1e6:.1f} MB (server's reload span); window total p99 "
          f"around the swap {[w['total_p99_ms'] for w in around]} ms vs the other "
          f"{len(others)} windows' median {float(np.median([w['total_p99_ms'] for w in others])):.3f}"
          f" and max {max(w['total_p99_ms'] for w in others):.3f} ms; device p99 around "
          f"{[w['device_p99_ms'] for w in around]} ms, others' median "
          f"{float(np.median([w['device_p99_ms'] for w in others])):.3f} ms; queue wait p99 "
          f"median {float(np.median([w['queue_wait_p99_ms'] for w in windows])):.3f} ms",
          flush=True)
    print(f"# serve parity: 256 rows over HTTP vs the card's evaluate (launches "
          f"{eval_launches}): max abs diff {d_http}; in-process predict_rows (0 launches): "
          f"{d_rows}", flush=True)

    # --- in process: each rung's assemble, forward, predict and card time,
    # and the handler's parse; then the card's busy share of the closed loop
    fields, slots = parse_rows(rows, scfg.data)
    t0 = time.perf_counter()
    for i in range(200):
        parse_rows(rows[i % 32:i % 32 + 8], scfg.data)
    parse_ms = (time.perf_counter() - t0) / 200 * 1e3
    per_rung, card = [], {}
    for r in runner.rungs:
        group = request_group(fields[:r], slots[:r])
        asm = []
        for _ in range(50):
            t0 = time.perf_counter()
            arrays, _ = assemble_batch(group, r, NUM_FIELDS)
            asm.append((time.perf_counter() - t0) * 1e3)
        dev = to_device(arrays, DEVICE)
        ev = cuda_ms(lambda dev=dev: runner._predict(gen.tables, dev), reps=50, warmup=5)
        host = []
        for _ in range(50):
            t0 = time.perf_counter()
            runner.predict(arrays)
            host.append((time.perf_counter() - t0) * 1e3)
        card[r] = device_busy_ms(lambda arrays=arrays: runner.predict(arrays))
        busy_s = "not measured" if card[r] is None else f"{card[r]:.4f} ms"
        per_rung.append(f"{r} ({len(group)} requests): assemble_batch {np.median(asm):.4f} ms, "
                        f"forward {ev:.4f} ms CUDA events, predict {np.median(host):.4f} ms "
                        f"host median (p99 {np.percentile(host, 99):.4f}), card busy {busy_s}")
    print(f"# serve per rung (assemble_batch of requests of 1-8 rows and predict by the host "
          f"clock, medians of 50; the forward alone by CUDA events; the card's busy time of "
          f"one predict, to_device to .cpu(), by torch.profiler): {'; '.join(per_rung)}; "
          f"parse_rows of an 8-row request {parse_ms:.4f} ms (handler thread)", flush=True)
    span_s = sum(w["window_s"] for w in windows)
    if None in card.values():
        print("# serve card busy: not measured (the profiler saw no device time)", flush=True)
    else:
        # an upper bound: a batch at rung r keeps the card busy card[r];
        # the stream gives each window's batches and padded rows, not
        # their rungs, so take the larger of the rungs' figures per batch
        # and per padded row, and the smaller of the two bounds a window
        per_batch, per_row = max(card.values()), max(card[r] / r for r in card)
        busy_ms = sum(min(w["batches"] * per_batch, w["rows"] / w["batch_fill"] * per_row)
                      for w in busy)
        print(f"# serve card busy: at most {busy_ms / 1e3 / span_s:.2%} of the stream's "
              f"{len(windows)} windows ({span_s:.3f} s, {sum(w['batches'] for w in busy)} "
              f"batches): each window's batches x {per_batch:.4f} ms, or its padded rows x "
              f"{per_row * 1e3:.4f} us, the smaller (the profiler's busy time above)",
              flush=True)
    del runner, gen
    lap("per-rung timings")

    # --- in process, under a predict loop at rung 256: a reload, its
    # parts one at a time, the two digest forms, and threads parsing
    # requests at two GIL switch intervals; and the card's memory
    rdir = os.path.join(work, "ck_reload")
    commit_step(stage_step(src, rdir, 1, link=True), 1)
    rcfg = override(scfg, **{"train.checkpoint_dir": rdir})
    runner = ServeRunner(rcfg, device=DEVICE)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    runner.load()
    m1 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    arrays, _ = assemble_batch([PendingRequest(fields=fields, slots=slots)], SERVE_MAX_BATCH,
                               NUM_FIELDS)
    lat, stop, probes = [], threading.Event(), {}

    def loop():
        while not stop.is_set():
            t0 = time.perf_counter()
            _, g = runner.predict(arrays)
            lat.append((t0, (time.perf_counter() - t0) * 1e3, g.gen))

    def probe(what: str, fn):
        time.sleep(0.3)
        t0 = time.perf_counter()
        out = fn()
        probes[what] = (t0, time.perf_counter())
        return out

    def parsers(n: int, seconds: float) -> int:
        """n threads, each parsing a request of 1-8 rows every n ms (about
        the closed loop's 1,000 requests/s in all) for `seconds`; returns
        the requests parsed."""
        done, until = [0] * n, time.perf_counter() + seconds

        def work(k):
            while time.perf_counter() < until:
                lo = (k * 7 + done[k]) % 248
                parse_rows(rows[lo:lo + 1 + done[k] % 8], scfg.data)
                done[k] += 1
                time.sleep(n / 1e3)

        ths = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        return sum(done)

    def copy_to_card():
        runner._to_device(host)

    switch = sys.getswitchinterval()
    th = threading.Thread(target=loop)
    th.start()
    try:
        probe("idle", lambda: time.sleep(0.5))
        commit_step(stage_step(src, rdir, 2, link=True), 2)
        new = probe("maybe_reload", runner.maybe_reload)
        peak = torch.cuda.max_memory_allocated()
        host, _, _ = probe("npz read (restore_tiered, verify off)", lambda: ckpt.restore_tiered(
            rdir, table_shapes(rcfg), verify="off"))
        wv = host["wv"]
        probe("crc32 of a tobytes() copy", lambda: zlib.crc32(wv.tobytes()))
        probe("array_digest in place", lambda: ckpt.array_digest(wv))
        probe("copy to the card (_to_device)", copy_to_card)
        parsed = {f"{switch * 1e3:g}": probe(
            f"{SERVE_CONNECTIONS} threads parsing paced, switch {switch * 1e3:g} ms",
            lambda: parsers(SERVE_CONNECTIONS, 1.0))}
        sys.setswitchinterval(0.0005)
        parsed["0.5"] = probe(f"{SERVE_CONNECTIONS} threads parsing paced, switch 0.5 ms",
                              lambda: parsers(SERVE_CONNECTIONS, 1.0))
        time.sleep(0.3)
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        th.join(timeout=60)
    if th.is_alive() or new is None or new.step != 2 or lat[-1][2] != 2:
        fail(f"in-process reload under a predict loop: {new}, last answer {lat[-1:]}")
    del new, host, wv
    torch.cuda.synchronize()
    m2 = torch.cuda.memory_allocated()
    table = (1 << LOG2_SLOTS) * (1 + V_DIM) * 4
    if abs((m2 - m0) - table) > table // 8:
        fail(f"after the reload {m2 - m0} bytes stay allocated, expected one table ({table})")
    parts = []
    for what, (a, b) in probes.items():
        ms = [d for t, d, _ in lat if t < b and t + d / 1e3 > a]
        parts.append(f"{what} {b - a:.3f} s: predict median {np.median(ms):.3f} p99 "
                     f"{np.percentile(ms, 99):.3f} max {max(ms):.3f} ms ({len(ms)})")
    print(f"# serve under a predict loop at rung {SERVE_MAX_BATCH} (host clock; the predicts "
          f"that overlap each part): {'; '.join(parts)}; requests parsed in 1 s by "
          f"{SERVE_CONNECTIONS} paced threads at switch interval (ms) {parsed}; card memory "
          f"allocated: one generation {(m1 - m0) / 1e6:.1f} MB, peak during the swap "
          f"{(peak - m0) / 1e6:.1f} MB over the start, after it {(m2 - m0) / 1e6:.1f} MB",
          flush=True)
    del runner
    lap("in process under a predict loop: the reload, its parts, the GIL")

    # --- FFM's 1.2 GB table through one load()
    fcfg = ffm_config(cfg, os.path.join(work, "ck_ffm"))
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fgen = ServeRunner(fcfg, device=DEVICE).load()
    t_load = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in fgen.tables.values())
    print(f"# serve load of phase 13's FFM checkpoint (wv [2^{LOG2_SLOTS}, "
          f"{1 + NUM_FIELDS * FFM_V_DIM}], "
          f"step {fgen.step}): {t_load:.3f} s for {nbytes / 1e6:.1f} MB of tables "
          f"(restore, digest check, copy to the card); allocated "
          f"{(torch.cuda.memory_allocated() - m0) / 1e6:.1f} MB", flush=True)
    del fgen
    lap("the FFM load")


FLEET_DRILL_SECONDS, FLEET_SECONDS = 15.0, 10.0
FLEET_CORRUPT_AT, FLEET_GOOD_AT = 4.0, 8.0  # seconds into the drill
FLEET_KILL_BATCHES = 25
FLEET_SIZES = (1, 2, 4)


def bitflip_npz_payload(path: str, member: str) -> None:
    """Flip one byte in the middle of `member`'s array payload inside the
    npz at `path` and rewrite the archive with fresh zip CRCs: damage that
    the container's checks pass and only the checkpoint's digest sees.
    Streams member by member (the FM state is 553.6 MB)."""
    import shutil
    import struct
    import zipfile

    tmp = path + ".flip"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(tmp, "w") as zout:
        for info in zin.infolist():
            with zin.open(info) as src, zout.open(info.filename, "w", force_zip64=True) as dst:
                if info.filename != member:
                    shutil.copyfileobj(src, dst, 1 << 24)
                    continue
                head = src.read(12)  # .npy magic, version, header length
                hlen = struct.unpack("<I", head[8:12])[0] + 12 if head[6] >= 2 else \
                    struct.unpack("<H", head[8:10])[0] + 10
                head += src.read(hlen - len(head))
                dst.write(head)
                half = (info.file_size - hlen) // 2
                dst.write(src.read(half))
                b = src.read(1)
                dst.write(bytes([b[0] ^ 0x40]))
                shutil.copyfileobj(src, dst, 1 << 24)
    os.replace(tmp, path)


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of process `pid` (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def nvidia_smi(query: str) -> list:
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [[x.strip() for x in line.split(",")] for line in out.strip().splitlines()]


def card_memory_by_pid() -> dict:
    """{pid: MiB} of the processes holding memory on the card, by
    `nvidia-smi --query-compute-apps=pid,used_memory`. In a container
    nvidia-smi may name the host's view of the pids, not this one's."""
    return {int(pid): float(mib) for pid, mib in nvidia_smi("--query-compute-apps=pid,used_memory")}


def card_used_mib() -> float:
    """The card's memory in use, all processes (`nvidia-smi memory.used`)."""
    return float(nvidia_smi("--query-gpu=memory.used")[0][0])


def opens_the_card(pid: int) -> bool:
    """Whether process `pid` holds a /dev/nvidia* device file open (a CUDA
    context does)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            continue  # closed meanwhile
    return False


def get_json(port: int, path: str, timeout: float = 30.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serve_flags(serving: str) -> list:
    """The phase-14 serve settings, for `serve` and `serve-fleet` alike."""
    return ["--device", DEVICE, "--checkpoint-dir", serving, "--model", "fm",
            "--log2-slots", str(LOG2_SLOTS), "--port", "0", "--window-ms", "2",
            "--max-batch", str(SERVE_MAX_BATCH), "--poll-s", "0.5",
            "--set", f"serve.ladder={SERVE_LADDER}", "--set", f"model.v_dim={V_DIM}",
            "--set", f"model.num_fields={NUM_FIELDS}", "--set", f"data.max_nnz={NUM_FIELDS}",
            "--set", "serve.metrics_every_s=0.5"]


def start_server(argv: list, errlog: str, env: dict = None):
    """Popen `argv` from the checkout and read its ready line (the first
    stdout line, within 300 s). Returns (proc, ready)."""
    import select

    with open(errlog, "w") as err:
        proc = subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True,
                                env={**os.environ, **(env or {})})
    if not select.select([proc.stdout], [], [], 300)[0]:
        proc.kill()
        fail(f"{argv[3]} printed no ready line within 300 s: {open(errlog).read()[-3000:]}")
    line = proc.stdout.readline()
    if not line:
        fail(f"{argv[3]} exited {proc.wait(timeout=60)} before its ready line: "
             f"{open(errlog).read()[-3000:]}")
    return proc, json.loads(line)


def stop_server(proc, errlog: str, what: str) -> None:
    """SIGTERM; fails unless the process exits 0 within 90 s."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=90)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc = "killed after 90 s"
    if rc != 0:
        fail(f"{what} exited {rc} on SIGTERM: {open(errlog).read()[-3000:]}")


def closed_loop(port: int, path: str, seconds: float, pids: dict, *extra: str) -> dict:
    """serve_bench's closed loop (16 connections, 1-8 rows a request) on
    `port` for `seconds`, with the CPU seconds each process of `pids`
    ({name: pid}) and this one (the client) spent meanwhile."""
    from xflow_tpu_torch.tools import serve_bench

    args = serve_bench.build_parser().parse_args([
        "--url", f"http://127.0.0.1:{port}", "--duration", str(seconds),
        "--concurrency", str(SERVE_CONNECTIONS), "--data", path, "--rows-per-request", "1-8",
        *extra])
    cpu0 = {k: proc_cpu_s(p) for k, p in pids.items()}
    own0, t0, ts0 = os.times(), time.perf_counter(), time.time()
    rep = serve_bench.run(args)
    wall = time.perf_counter() - t0
    own1 = os.times()
    rep["cpu_s"] = {k: proc_cpu_s(p) - cpu0[k] for k, p in pids.items()}
    rep["cpu_s"]["client"] = own1.user + own1.system - own0.user - own0.system
    rep["wall_s"], rep["t_wall"] = wall, (ts0, ts0 + wall)
    return rep


def window_p99s(streams: list, t_wall: tuple) -> tuple:
    """The medians of the device and queue-wait p99 of the serve windows
    (over every stream) flushed inside `t_wall`."""
    import numpy as np

    from xflow_tpu_torch.jsonl import read_jsonl

    ws = [r for p in streams for r in read_jsonl(p)
          if r.get("kind") == "serve" and r.get("requests") and t_wall[0] < r["ts"] <= t_wall[1]]
    if not ws:
        fail(f"no serve window inside the closed loop in {streams}")
    return (float(np.median([w["device_p99_ms"] for w in ws])),
            float(np.median([w["queue_wait_p99_ms"] for w in ws])), len(ws))


def pace_line(what: str, rep: dict) -> str:
    """One closed loop's numbers, and each process's CPU seconds over the
    loop's wall time (cores); the busiest process is named."""
    cores = {k: v / rep["wall_s"] for k, v in rep["cpu_s"].items()}
    top = max(cores, key=cores.get)
    return (f"{what}: {rep['value']} requests/s, {rep['rows_per_s']} rows/s, p50 "
            f"{rep['p50_ms']} / p99 {rep['p99_ms']} ms, {rep['requests']} requests, "
            f"{rep['errors']} failed; windows' device p99 median {rep['device_p99']:.3f} ms, queue "
            f"wait p99 median {rep['queue_p99']:.3f} ms ({rep['windows']} windows); CPU s over "
            f"{rep['wall_s']:.2f} s: " + ", ".join(
                f"{k} {v:.2f} ({cores[k]:.2f} cores, {v / rep['requests'] * 1e3:.3f} ms a "
                f"request)" for k, v in rep["cpu_s"].items())
            + f"; busiest: {top}")


def run_fleet(cfg, work: str, path: str, card: str) -> None:
    """Phase 15, the serving fleet on the card: `python -m xflow_tpu_torch
    serve-fleet --device cuda` over phase 14's FM states at full width.

    The drill: 3 replicas (each pid must hold memory on the card), the
    closed loop with client retries for 15 s while replica 1 kills itself
    after 25 batches (the injector, gen 0 only), a step 2 whose tables
    carry a bitflip only the digest sees commits at 4 s, and phase 14's
    good step 2 commits as step 3 at 8 s. Gates: 0 failed and 0
    deadline-exceeded requests, served steps [1, 3], reload_failed in the
    replica streams, replica 1 back at gen 1 and /healthz 3 healthy on
    step 3, circuit_open and circuit_close in the router stream, 256 rows
    through the router equal to the evaluate path on step 3 within
    PCTR_ATOL, and SIGTERM exits 0 after a drain event.

    Then where the time goes: the same closed loop, 10 s, no faults,
    against fleets of 1, 2 and 4 replicas and the bare `serve`, each with
    requests/s, rows/s, p50/p99, the windows' device and queue p99 and
    the CPU seconds of the router, each replica and the client."""
    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.serve.runner import ServeRunner

    laps = [time.perf_counter()]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        print(f"# fleet phase: {what} in {laps[-1] - laps[-2]:.1f} s", flush=True)

    src, serving = os.path.join(work, "ck_serve_src"), os.path.join(work, "ck_fleet")
    commit_step(stage_step(src, serving, 1, link=True), 1)
    corrupt = os.path.join(serving, ".staging_corrupt_2")
    os.rename(stage_step(src, serving, 2, link=True), corrupt)
    bitflip_npz_payload(os.path.join(corrupt, "state.npz"), "tables/wv.npy")
    good = os.path.join(serving, ".staging_step_3")  # phase 14's step 2, committed as step 3
    os.rename(stage_step(src, serving, 2, link=True), good)
    lap("step 1 committed, a digest-only corrupt step 2 and a good step 3 staged")

    run_dir, errlog = os.path.join(work, "fleet_drill"), os.path.join(work, "fleet_drill.err")
    used0 = card_used_mib()
    proc, ready = start_server(
        [sys.executable, "-m", "xflow_tpu_torch", "serve-fleet", *serve_flags(serving),
         "--replicas", "3", "--max-restarts", "1", "--restart-backoff", "0.5",
         "--reload-stagger-s", "0.5", "--eject-failures", "2", "--circuit-open-s", "1",
         "--health-poll-s", "0.2", "--run-dir", run_dir],
        errlog, env={"XFLOW_FAULT_SERVE_KILL_BATCHES": str(FLEET_KILL_BATCHES),
                     "XFLOW_FAULT_SERVE_REPLICA": "1", "XFLOW_FAULT_SERVE_KILL_GEN": "0"})
    try:
        reps = ready["replicas"]
        if [(r["replica"], r["step"], r["device"]) for r in reps] != [
                (k, 1, torch.cuda.get_device_name(0)) for k in range(3)]:
            fail(f"fleet ready line {ready}: expected 3 replicas at step 1 on the card")
        # every replica's pid on the card: by nvidia-smi's compute apps
        # where it names this namespace's pids; else (a container) by each
        # pid's open /dev/nvidia* files and the card's memory in use
        # before and after the fleet started, shared over the replicas
        mem, used = card_memory_by_pid(), card_used_mib() - used0
        pids = [r["pid"] for r in reps]
        table_mib = (1 << LOG2_SLOTS) * (1 + V_DIM) * 4 / 2**20
        if all(p in mem for p in pids):
            held = {r["replica"]: mem[r["pid"]] for r in reps}
        elif all(opens_the_card(p) for p in pids) and used >= len(reps) * table_mib:
            held = {r["replica"]: round(used / len(reps), 1) for r in reps}
            print(f"# fleet: nvidia-smi's compute apps {mem} do not name this namespace's "
                  f"pids: each replica pid {pids} holds /dev/nvidia* open, and the card's "
                  f"memory in use grew {used:.0f} MiB as the fleet started (a share each below)",
                  flush=True)
        else:
            fail(f"replica pids {pids} not on the card: compute apps {mem}, /dev/nvidia* open "
                 f"{[opens_the_card(p) for p in pids]}, {used:.0f} MiB more in use")
        if opens_the_card(ready["pid"]):
            fail(f"the fleet process {ready['pid']} holds the card: it should only route")
        print(f"# fleet: ready {json.dumps(ready)}; card memory a replica (MiB): {held}; the "
              f"fleet process does not hold the card", flush=True)
        lap("3 replicas started (each: CUDA context, load, warmup) and the router")

        import threading

        timers = [threading.Timer(FLEET_CORRUPT_AT, commit_step, (corrupt, 2)),
                  threading.Timer(FLEET_GOOD_AT, commit_step, (good, 3))]
        for t in timers:
            t.start()
        try:
            drill = closed_loop(ready["router_port"], path, FLEET_DRILL_SECONDS,
                                {"router": ready["pid"]}, "--retries", "3",
                                "--deadline-ms", "20000")
        finally:
            for t in timers:
                t.cancel()
                t.join(timeout=60)
        print("# fleet drill serve_bench: " + json.dumps(
            {k: v for k, v in drill.items() if k not in ("generations", "gen_flip_t")}),
            flush=True)
        if (drill["errors"], drill["deadline_exceeded"], drill["steps"]) != (0, 0, [1, 3]):
            fail(f"the drill: errors {drill['errors']} ({drill['first_error']}), deadline "
                 f"exceeded {drill['deadline_exceeded']}, steps {drill['steps']} (want [1, 3])")
        lap(f"{FLEET_DRILL_SECONDS:.0f} s closed loop through a kill, a corrupt and a good commit")

        def replica_step(port: int):
            try:
                return get_json(port, "/healthz", timeout=5)[1].get("step")
            except OSError:
                return None  # not listening (yet)

        deadline, health, steps = time.monotonic() + 120, {}, []
        while time.monotonic() < deadline:
            health = get_json(ready["router_port"], "/healthz")[1]
            steps = [replica_step(r["port"]) for r in reps]
            if health["healthy"] == 3 and steps == [3, 3, 3]:
                break
            time.sleep(0.5)
        if health.get("healthy") != 3 or steps != [3, 3, 3]:
            fail(f"after the drill: router /healthz {health}, replica steps {steps}")
        with open(path) as f:
            rows = [next(f).split("\t", 1)[1].strip() for _ in range(SERVE_MAX_BATCH)]
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", ready["router_port"], timeout=60)
        conn.request("POST", "/predict", json.dumps({"rows": rows}))
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
        if resp.status != 200 or payload["step"] != 3:
            fail(f"POST of {len(rows)} rows through the router: HTTP {resp.status} "
                 f"{str(payload)[:300]}")
        lap("the rejoin, 3 replicas on step 3, 256 rows through the router")
    finally:
        stop_server(proc, errlog, "the fleet")
    lap("SIGTERM: the router drained, then the replicas")

    router = read_jsonl(os.path.join(run_dir, "serve_router.jsonl"))
    events = [r.get("event") for r in router]
    streams = [os.path.join(run_dir, f"serve_replica{k}.jsonl") for k in range(3)]
    replica_events = [r.get("event") for p in streams for r in read_jsonl(p)]
    gens1 = sorted({r["gen"] for r in read_jsonl(streams[1])})
    err = open(errlog).read()
    missing = [e for e in ("circuit_open", "circuit_close", "drain") if e not in events]
    if missing or "reload_failed" not in replica_events or gens1 != [0, 1] or \
            err.find("draining router") > err.find("stopping replicas"):
        fail(f"fleet streams: router events missing {missing}; replica events "
             f"{sorted(set(replica_events) - {None})}; replica 1 gens {gens1}; log {err[-2000:]}")
    scfg = override(cfg, **{"train.checkpoint_dir": serving, "serve.max_batch": SERVE_MAX_BATCH,
                            "serve.ladder": SERVE_LADDER})
    gen = ServeRunner(scfg, device=DEVICE).load()
    _, p_eval = first_batch(scfg, gen.tables, path, DEVICE)
    d = float(np.abs(np.asarray(payload["pctr"], np.float32) - p_eval[:SERVE_MAX_BATCH]).max())
    if gen.step != 3 or not d <= PCTR_ATOL:
        fail(f"pCTRs through the router vs the card's evaluate on step {gen.step}: {d}")
    del gen
    drill["device_p99"], drill["queue_p99"], drill["windows"] = window_p99s(streams,
                                                                            drill["t_wall"])
    ts = {e: [r["ts"] for r in router if r.get("event") == e and r.get("backend") == 1]
          for e in ("circuit_open", "circuit_close")}
    rejoin_s = ts["circuit_close"][-1] - ts["circuit_open"][0] if all(ts.values()) else None
    print(f"# fleet drill on {card}: 3 replicas, replica 1 killed after {FLEET_KILL_BATCHES} "
          f"batches and back at gen 1 (its circuit open to closed {rejoin_s} s), reload_failed x {replica_events.count('reload_failed')} "
          f"on the corrupt step 2, router events {[e for e in events if e != 'hedge']}; "
          + pace_line("closed loop with client retries", drill)
          + f"; client retried {drill['retried']} ({drill['retry_attempts']} resends); "
          f"256 rows through the router vs the card's evaluate on step 3: max abs diff {d}",
          flush=True)
    lap("streams and parity")

    # --- where the fleet's time goes: fleets of 1, 2, 4 and the bare server
    for n in FLEET_SIZES:
        run_dir, errlog = os.path.join(work, f"fleet{n}"), os.path.join(work, f"fleet{n}.err")
        proc, ready = start_server(
            [sys.executable, "-m", "xflow_tpu_torch", "serve-fleet", *serve_flags(serving),
             "--replicas", str(n), "--run-dir", run_dir], errlog)
        try:
            pids = {"router": ready["pid"],
                    **{f"replica{r['replica']}": r["pid"] for r in ready["replicas"]}}
            rep = closed_loop(ready["router_port"], path, FLEET_SECONDS, pids)
        finally:
            stop_server(proc, errlog, f"the fleet of {n}")
        rep["device_p99"], rep["queue_p99"], rep["windows"] = window_p99s(
            [os.path.join(run_dir, f"serve_replica{k}.jsonl") for k in range(n)], rep["t_wall"])
        if rep["errors"]:
            fail(f"fleet of {n}: {rep['errors']} failed ({rep['first_error']})")
        print(f"# fleet pace on {card}: " + pace_line(f"fleet of {n}", rep), flush=True)
        lap(f"fleet of {n}: start, {FLEET_SECONDS:.0f} s closed loop, SIGTERM")
    metrics, errlog = os.path.join(work, "bare.jsonl"), os.path.join(work, "bare.err")
    proc, ready = start_server([sys.executable, "-m", "xflow_tpu_torch", "serve",
                                *serve_flags(serving), "--metrics-path", metrics], errlog)
    try:
        rep = closed_loop(ready["port"], path, FLEET_SECONDS, {"server": ready["pid"]})
    finally:
        stop_server(proc, errlog, "the bare server")
    rep["device_p99"], rep["queue_p99"], rep["windows"] = window_p99s([metrics], rep["t_wall"])
    if rep["errors"]:
        fail(f"bare server: {rep['errors']} failed ({rep['first_error']})")
    print(f"# fleet pace on {card}: " + pace_line("bare serve (phase 14's server)", rep),
          flush=True)
    lap(f"bare serve: start, {FLEET_SECONDS:.0f} s closed loop, SIGTERM")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "xflow_tpu_torch")):
        fail(f"{HERE} holds no xflow_tpu_torch package: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a CUDA card only")
    card = card_line()
    print(f"# card: {card}; host: {len(os.sched_getaffinity(0))} usable cores", flush=True)

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
            # the paths read the text; input_sources reads this cache directory
            "data.cache": "off", "data.cache_dir": os.path.join(work, "xfc"),
        })
        path, rate_path = make_inputs(work, cfg)
        mcfg = mvm_config(cfg, os.path.join(work, "ck_mvm"))
        write_state(mcfg.train.checkpoint_dir, "v", V_DIM, MVM_V_SCALE, SEED + 1)
        from xflow_tpu_torch.data.pipeline import batch_iterator
        from xflow_tpu_torch.serve.runner import ServeRunner

        gen = ServeRunner(cfg, device=DEVICE).load()
        kern = check_kernels(cfg, gen, path)
        kern += check_train_kernels(cfg, path)
        it = batch_iterator(path, mcfg.data)
        mvm_batch = next(it)  # parsed once for the MVM checks
        it.close()
        seg_cfg = mvm_config(cfg, mcfg.train.checkpoint_dir, **{"model.mvm_exclusive": "off"})
        kern += check_multi_kernels(seg_cfg, mvm_batch)
        mvm_product = check_mvm_product_kernels(mcfg, mvm_batch)
        hot = check_hot_scatters()
        mvm_steps_card_vs_cpu(mcfg, mvm_batch)
        eval_launches = run_slice(cfg, gen, path, rate_path)
        train_launches, two_pass = run_training(cfg, work, path, rate_path)
        lr_launches = run_lr(cfg, work, path, mvm_batch)
        segment = run_mvm_training(mcfg, work, path, rate_path)
        ffm_kern = run_ffm(cfg, work, path, rate_path)
        wide = check_wide_row_sums(cfg, path)
        lab_kern = run_lab(work)
        run_serve(cfg, work, path, card)
        run_fleet(cfg, work, path, card)
    print(f"# launches: evaluate path {eval_launches}, training main path {train_launches}, "
          f"two-pass epoch {two_pass}, LR (the default model) {lr_launches}, "
          f"MVM segment path {segment}")
    for k in kern:
        src = {"scatter_sorted": two_pass, "gather_sorted_multi": segment,
               "scatter_sorted_multi": segment}.get(k["name"], train_launches)
        k["launches"] = src[k["name"]]
        if k["name"] in mvm_product:
            k["mvm_product"] = mvm_product[k["name"]]
        if k["name"] in ffm_kern:
            k["ffm"] = ffm_kern[k["name"]]
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
