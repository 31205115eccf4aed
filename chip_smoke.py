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
   and on, the row sum bitwise equal to its plain version on CPU copies
   (both add a row's terms in plan order from +0) and across two
   launches, with its time, its plain version's, `zeros` +
   `index_add_`'s and its bound (`check_row_sums`, as at every width
   and plan below), and again with 4,096 of the plan's nonzero terms
   moved to one row (`skewed_rows`);
5. training kernels on the training path's own inputs (the first batch's
   plan and the occurrence cotangent the fused step's backward produces
   on the restored state), bf16 off and on: the scatter bitwise equal to
   its plain version on the CPU and across two launches; the fused
   scatter+FTRL within 1e-3 over 1e-4 for w, n and z, within 1e-3 over a
   floor of 1e-2 of its largest magnitude for the gradient z' implies,
   and the new w within 1e-3 of the FTRL rule on (z', n') (the gradient
   is far under the fixed floor; see `ftrl_errs`), and w of
   never-touched slots bitwise kept; #3's non-finite count on a copy of the
   cotangent with NaN and +-Inf placed equal to torch's count of its
   outputs and of its plain version's, and 0 on the clean one
   (`check_nonfinite_count`). Then one fused train step from that
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
   (4 steps), every kernel's launch count 0 (LR runs none), one step
   from its checkpoint on the card against the CPU, and that two-pass
   step twice on the card from one state, printing whether w, n and z
   agree bitwise (`run_lr`; a finding, not a gate);
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
   multi-buffer one), bitwise against the CPU plain version (which adds
   the run's pieces in the kernels' order) and across two launches,
   within the float32 reorder bound of plan order (that share and the
   error reported), with their times (`hot_ms`, zeros + `index_add_`'s,
   the bound), and #3 on the
   flat one at K = 11 from a seeded state, bitwise across two launches and
   by `ftrl_errs` against its plain version on the CPU (g and w_rule
   gated, w, n, z reported: a float32 sum of the 65,536 unit terms is
   itself off by up to 5e-3 in some orders), bf16 off and on,
   with `hot_ms`, `hot_library_ms` (the composition) and `hot_bound_ms`;
   #3's bound and composition time on the product plan too. Then one product
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
   the same profiler), carried as `floor_ms` in #7-#10's entries beside
   `floor_share` (floor_ms / ms: the share of the least time a launch
   takes, which lies over each probe's bytes bound), and the pieces #8-#10
   cut each slice into (`pieces`); each probe's pieces, time, floor and
   share are printed. Each suite's output is echoed as comments;
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
   two-pass step card vs CPU as in phase 5 and one fused step on the
   card against it (the same tolerances), launching #1 and #4, or #1 and
   #3, once and nothing else; the first batch with field 0 repeated in
   column 1 routes row-major (the FFM route counts, `models/ffm.ROUTES`),
   launches nothing, moves the table and matches the CPU forward's loss
   (its full step against the CPU's runs at the card tests' width). Then
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
   drain. Then the same closed loop for 6 s, no faults, against fleets
   of 1, 2 and 4 replicas and the bare `serve`: requests/s, rows/s,
   p50/p99, the windows' device and queue-wait p99, and the CPU seconds
   of the router, each replica and the client (/proc/<pid>/stat) over
   the loop's wall time, which say which process sets the pace;
16. the online loop at the FM headline's width (`run_online`): (a) a
   writer thread appends the rate shard's first 6 x 65,536 rows to a
   fresh shard in 6 pieces 1.5 s apart, every second piece ending
   mid-row, while `Trainer.fit` follows it in process (`data.stream=tail`,
   a 0.25 s poll, 4 s idle end, `.xfc` on arrival) with a publication
   every 2 steps, async saves mirrored into a replica, 2 steps kept in
   the primary and 3 in the replica. It fails unless #1, #2 and #3
   launched once a step and nothing else, the spooled segments are the
   file's bytes and rows, the steps are the segments' batches, each
   segment read from its cache and planned natively, every publication
   committed with published >= consumed >= ingest, no two saves in
   flight (the ckpt records), and each replica step digest-verified,
   byte-equal to its primary and bitwise the state the fit loop held at
   that step (a snapshot taken while later steps ran); (b) `serve
   --device cuda` over the primary dir meanwhile, `serve_bench` with 4
   connections: 0 failed requests, the served step advancing to the last
   publication, windows with `data_freshness_s`, and each publication's
   ingest -> consumed -> published -> live -> first served times; (c)
   the segments replayed one `fit` each from the same initial state:
   every loss within 1e-5, the final w, n, z by `ftrl_errs`, the last
   commit bitwise the live state; (d) the fit loop's stall per save at
   FM width (synchronous, then async with and without the pinned
   allocation, and the writer's `write_ms`), two snapshots of FM's and of
   phase 13's FFM state (host time, pinned allocation, the copy's wait
   and rate, the card's memory before, at the peak and after), and
   FFM's synchronous save; (e) `train --device cuda` in tail mode as a
   subprocess, SIGTERM after its second publication: exit 0, one
   `interrupted` record, its newest committed step the step it reached,
   and a resumed `train` restoring it;
17. the trainer's observability on Zipf data at FM width (`run_observe`):
   the port's `gen-data --bulk --zipf-alpha 1.05` writes a 20-batch train
   shard and a 2-batch test shard sharing the planted truth (rate and the
   first batch's longest slot run printed); `train --device cuda` (the
   CLI's main in a subprocess, in a work dir) runs 2 epochs with
   `log_every=1`, health norms, the pipeline profiler, a heartbeat, a 30
   s hang watchdog, the trace window over steps 5-7, `eval_every=1` and
   the test shard. It fails unless every record has the JAX trainer's
   keys for these flags (less its roofline gauges), the window steps run
   1..40 with the last loss the summary's, both `eval_auc` exceed 0.5,
   `pred_0_0.txt` holds the test shard's rows, the heartbeat has start,
   2 evals, a beat a step and final, the watchdog never dumped, the trace
   holds #1-#3 by kernel name, and the launches are exact (#1 and #2 40 +
   6 eval batches, #3 40, #4-#6 0). It prints the window split, the
   pipeline stages and verdict, and #1-#3's mean trace time on Zipf
   batches beside their uniform times; #4 (K = 11, flat) and #6 (K = 10,
   4 stacked buffers) on the first Zipf batch's plans and the uniform
   rate shard's first batch's, bitwise against their plain versions,
   timed beside `zeros` + `index_add_` (`check_zipf_scatters`); then 1
   epoch with the guard off and 1 with the guard and every record off,
   their examples/s and split;
18. the multi-device engines (`run_mesh`) as a world of one NCCL rank
   over a TCPStore on localhost (the machine holds one card, and NCCL
   puts no two ranks of a communicator on one device: a world of 2 here
   must raise naming that rule), on a 1 x 1 mesh: two steps each of the
   fully-sharded and the replicated engine at FM width on phase 3's
   shard, from a seeded state, against the port's single-device
   two-pass step on the same batches (losses within 2e-5 relative, w, n
   and z within 2e-4 relative over 1e-6), their launch counts set to 0
   just before and read just after (#2, #5, #6 and #1, #2, #4 a step);
   one fully-sharded step of MVM's segment side (full width) and of FFM
   (K = 73, 131,072 rows) as checked; #5 bit-exact and #6 bitwise
   against their plain versions on the fully-sharded buffer with `cap`'s
   pads (its compact wire dtypes crossing NCCL as bytes), with their
   times, and for #6 `zeros` + `index_add_`'s and its bound; #2 on that
   buffer's FM channels by `check_row_sums`; the
   overflow fallback: a batch with 9 hot fields overflows a 1 x 8
   split's buffers at slack 2.0 (a 1 x 1 block holds every occurrence
   and cannot), and `Trainer`'s per-batch agreement runs it
   on the row-major sharded step (counted), as checked; and one epoch of
   `Trainer(cfg, mesh=mesh).fit()` over the rate shard (#2, #5, #6 once
   a step) beside the single-device two-pass epoch, examples/s each;
   then the signal leg (`run_mesh_signal`): the same fit with
   `train.signal_sync_every=2` and a SIGTERM to this process once step 3
   is counted must stop at step 4 (the all_reduce(MAX) of the pending
   signal, a CUDA tensor on NCCL), commit step 4 and report the signal,
   #2, #5, #6 4 times each;
19. the launch layer (`run_launch`), FM at full width over phase 3's
   rate shard cut into two slice shards of 6 batches: (1) `python -m
   xflow_tpu_torch launch-multislice --slices 2` (bounded sync, K = 1, a
   round every 4 steps, a snapshot every 2 rounds; 2 epochs, 12 steps a
   slice), each slice a process on this one card (its /dev/nvidia* open)
   with a trace window naming #1-#3, kind="sync" records and
   `slice_sync` spans in each stream (each round's split printed: copy
   off the card, npz write, wait, read and apply, copy back, snapshot;
   its bytes), and each slice's last checkpoint the initial state plus
   every delta it folded in, summed on the host in float64 (normwise
   within 1e-5: float32 sums in another order); beside it one slice
   alone with sync off, examples/s each; (2) the same launch with slice
   1 killed entering round 2 (`XFLOW_FAULT_SLICE_KILL_ROUND`) and
   `--max-restarts 1`: slice 0 finishes, slice 1 leaves the sync group,
   rejoins at gen 1 on the card and adopts a snapshot, the job exits 0;
   (3) `launch-local --num-processes 1 --device cuda --max-restarts 1`
   with `XFLOW_FAULT_KILL_STEP=5`: both generations' heartbeats, the
   resumed run at the uninterrupted run's (the solo run of (1)) steps
   and examples, its w, n and z bitwise equal to that run's, with no
   lazy-init flip (`trajectory_errs(bitwise=True)`); (4) a checkpoint a
   2-rank `launch-local --device cpu` world wrote at step 3 (2^18 slots,
   4,096-row batches, two shards of 8 batches) resumed on the card in a
   world of one (the restore timed; #1-#3 once a step, counted in this
   process) trains the rest of both shards, within `ftrl_errs` of the
   CPU's resume of the same checkpoint. The card-vs-CPU multi-step
   comparisons hold each leaf's L2 error within 1e-3 and the lazy-init
   flips they leave out of w to at most 32 (`trajectory_errs`), and
   report the flips;
20. the port's last modules (`run_phase20`), each leg timed against its
   budget: (a) `serve` as a world of one NCCL rank (`serve_main` with a
   1 x 1 mesh, in process) over phase 14's FM states: 256 rows within
   1e-5 of the solo `ServeRunner` on steps 1 and 2, serve_bench's closed
   loop (6 s, a subprocess) with step 2 committed 2 s in, 0 failed, the
   world on generation 2, no kernel launched; its requests/s and p50 /
   p99 beside phase 15's bare server; (b) the C API: gcc builds the
   port's shim and a C client against this Python, which trains FM at
   full width on the card for 2 steps, reads the AUC, loads the
   checkpoint and predicts 3 rows within 1e-5 of `ServeRunner`, its
   trace window over step 2 naming #1-#3 in its own process; (c) the
   syncer on a mesh: two slices, each a `Trainer` on a world of one
   NCCL rank, 4 steps and one round at K = 1, their deltas holding the
   members, dtypes and shapes of phase 19's single-device slices' files,
   #2, #5, #6 once a step, and slice 1's z the two deltas' sum.

Before them, the whole smoke's time beside its prediction. The last
three lines of standard output: the card line, the kernels JSON (each entry with `share_of_bound` = bound_ms / ms; the row sum's
`widths` hold its entry at each of ch 24, 32, 104, 128 and 136, its
`skewed_4096` the one-row case, `mesh.fully_sharded` the buffer's; #1, #3
and #4 carry their FFM figures and launches under `ffm`, #1-#3 their
phase-17 trace time on Zipf batches and launches under `zipf`, #4 and
#6 their times on a phase-17 Zipf batch's plans and a uniform one's
under `zipf`, #1, #2, #4, #5 and #6 their phase-18 launches under
`mesh` (#2, #5, #6 the signal leg's under `mesh.signal`), with #5's and
#6's times on the fully-sharded buffer (#6's library time and bound
beside), #1-#3 their phase-19 launches under `launch`: the
elastic resume's counts and each slice's traced kernel events, #1-#3
the C client's traced events under `c_api_traced`, #2, #5, #6 the mesh
slices' launches under `mesh.sync`; the object's `launch` key holds
what phase 19 proved, `phase20` what phase 20 measured), and
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
              flips: bool = False, gate: bool = True) -> dict:
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
    agree all the same.

    `gate` False reports the errors and fails on none (a comparison of
    whole trajectories, which the one-step floors do not bound)."""
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
    if gate and not errs["g"] <= FTRL_RTOL:
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
    if gate and not all(e <= FTRL_RTOL for e in gated.values()):
        fail(f"{what}: {errs} beyond {FTRL_RTOL} relative")
    return errs


def trajectory_errs(got, want, prev, hp, what: str, bitwise: bool = False) -> dict:
    """Two runs of several steps from one state (one resumed, or on the
    CPU) against each other. With `bitwise` (two runs on the card) w, n
    and z must be equal bit for bit, with no lazy-init flip: every step of
    the FM fused path adds in a fixed order, the row sum (#2) included.
    Otherwise (the card against the CPU, whose losses and norms reduce in
    torch's own orders) each leaf's L2 error, ||got - want|| over
    ||want||, must be within TRAJ_RTOL; w's leaves out the lazy-init
    flips, entries where one side's n is 0 and the other's is not (a
    (slot, channel) gradient that cancelled to exactly 0 on one side
    only: that side keeps the init there, the other moves it by the
    rule), counted in `lazy_flips` and held to TRAJ_MAX_FLIPS, so that a
    run that lost updates cannot hide in w. The max normwise errors and
    `ftrl_errs` are reported beside, not gated: a flip's moved w feeds
    the next steps' gradients, so the runs drift apart by more than one
    step's rounding (PERF.md §6)."""
    import torch

    dev = want[0].device
    got = tuple(t.to(dev) for t in got)
    flip = (got[1] == 0) ^ (want[1] == 0)
    errs = {"lazy_flips": int(flip.sum())}
    if bitwise:
        errs["bitwise"] = {k: bool(torch.equal(a, b)) for k, a, b in zip("wnz", got, want)}
    for k, a, b in zip("wnz", got, want):
        if k == "w":
            a, b = a[~flip], b[~flip]
        errs[f"l2_{k}"] = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        errs[f"max_{k}"] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
    if bitwise and not (all(errs["bitwise"].values()) and errs["lazy_flips"] == 0):
        fail(f"{what}: {errs}: not bitwise equal")
    if not all(errs[f"l2_{k}"] <= TRAJ_RTOL for k in "wnz"):
        fail(f"{what}: {errs}: an L2 error beyond {TRAJ_RTOL}")
    if errs["lazy_flips"] > TRAJ_MAX_FLIPS:
        fail(f"{what}: {errs['lazy_flips']} lazy-init flips, beyond {TRAJ_MAX_FLIPS}")
    errs["ftrl_errs"] = ftrl_errs(got, want, prev, hp, what, flips=True, gate=False)
    return errs


def check_row_sums(vals, rows, what: str) -> dict:
    """#2 on one path's channels `vals [ch, Np]` and rows: bitwise its
    plain version on CPU copies (both add a row's terms in plan order
    from +0) and bitwise a second launch, with the times of the kernel,
    its plain version and `zeros` + `index_add_` on the same inputs, and
    its bound: vals and rows read once, the [B, ch] sums written once."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    ch = vals.shape[0]
    got = st.row_sums_cuda(vals, rows, BATCH)
    again = st.row_sums_cuda(vals, rows, BATCH)
    torch.cuda.synchronize()
    want = st.row_sums_plain(vals.cpu(), rows.cpu(), BATCH)
    got_c = got.cpu()
    err = (got_c - want).abs().max().item()
    n_diff = int((got_c.view(torch.int32) != want.view(torch.int32)).sum())
    if n_diff or not torch.equal(got, again):
        fail(f"row_sums {what} at ch = {ch}: {n_diff} sums differ in their bits from the plain "
             f"version on the CPU (max abs err {err}), or two launches differ")
    rows_l = rows.long()
    out = {
        "ch": ch, "positions": int(vals.shape[1]), "bitwise": True, "max_abs_err": err,
        "ms": cuda_ms(lambda: st.row_sums_cuda(vals, rows, BATCH)),
        "plain_ms": cuda_ms(lambda: st.row_sums_plain(vals, rows, BATCH)),
        "library_ms": cuda_ms(
            lambda: torch.zeros((BATCH, ch), device=DEVICE).index_add_(0, rows_l, vals.T)),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(
        vals.numel() * 4 + rows.numel() * rows.element_size() + BATCH * ch * 4, vals.numel())
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["under_library"] = out["ms"] <= out["library_ms"]
    print(f"# row_sums {what} at ch = {ch} ({out['positions']} positions): bitwise the plain "
          f"version on the CPU and across two launches; {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f}, zeros + index_add_ {out['library_ms']:.4f} ("
          f"{'under' if out['under_library'] else 'OVER'} it), bound {out['bound_ms']:.4f} "
          f"({out['share_of_bound']:.0%}) on {card_line()}", flush=True)
    return out


def skewed_rows(rows, vals, n_terms: int = 4096, hot: int = 7):
    """`rows` with row `hot`'s own terms moved to row `hot + 1` and then
    `n_terms` positions whose values are not all zero, spread over the
    plan by a seeded draw, moved to row `hot`: one row of `n_terms`
    nonzero terms beside the plan's own."""
    import torch

    nz = torch.nonzero((vals != 0).any(dim=0)).flatten().cpu()
    g = torch.Generator().manual_seed(SEED + 19)
    pick = nz[torch.randperm(nz.numel(), generator=g)[:n_terms]]
    out = rows.clone()
    out[out == hot] = hot + 1
    out[pick.to(out.device)] = hot
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
    skew = check_row_sums(vals, skewed_rows(rows, vals),
                          "on the FM evaluate path's channels with one row of 4,096 terms")
    results.append({
        "name": "row_sums", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/row_sums.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:1162",
        **{key: rs[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "widths": {rs["ch"]: rs}, "skewed_4096": skew,
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

    count = check_nonfinite_count(d_occ, ss, wo, w, n, z, hp, what)
    f_bound, f_by = bound_ms(
        6 * S * K * 4 + K * np_ * 4 + np_ * 4 + wo.numel() * 4,
        K * np_ + FTRL_OPS_PER_ELEMENT * S * K,
    )
    ftrl = {
        "max_abs_err": f_err,
        "ms": cuda_ms(lambda: st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp)),
        "plain_ms": cuda_ms(lambda: st.scatter_ftrl_plain(d_occ, ss, w, n, z, K, hp)),
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": cuda_ms(composition),
        "nonfinite_check": count,
    }
    print(f"# scatter_ftrl{what} library_ms is a composition (index_add_ + the torch FTRL "
          f"expression): {ftrl['library_ms']:.4f} ms", flush=True)
    return scatter, ftrl


def check_nonfinite_count(d_occ, ss, wo, w, n, z, hp, what: str) -> dict:
    """#3's non-finite count on a copy of the cotangent with NaN, +Inf and
    -Inf placed in three plan positions of real slots (and a NaN at a pad):
    the kernel's count must equal torch's count of the outputs it wrote
    and of its plain version's on the same inputs (the pattern too), and
    0 on the clean cotangent. Returns both counts."""
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    S, K = w.shape
    bad_d = d_occ.clone()
    real = torch.nonzero(ss < S - 1).flatten()
    at = real[torch.tensor([0, real.numel() // 2, real.numel() - 1], device=real.device)]
    bad_d[0, at[0]] = float("nan")
    bad_d[K - 1, at[1]] = float("inf")
    bad_d[K // 2, at[2]] = -float("inf")
    bad_d[0, ss.numel() - 1] = float("nan")  # a pad: slot S - 1, mask 0 on the path
    clean = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    st.scatter_ftrl_cuda(d_occ, ss, wo, w, n, z, K, hp, False, clean)
    got_count = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    got = st.scatter_ftrl_cuda(bad_d, ss, wo, w, n, z, K, hp, False, got_count)
    want_count = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    want = st.scatter_ftrl_plain(bad_d, ss, w, n, z, K, hp, False, want_count)
    torch.cuda.synchronize()
    torch_count = sum(int((~torch.isfinite(o)).sum()) for o in got)
    same = all(torch.equal(torch.isfinite(a), torch.isfinite(b)) for a, b in zip(got, want))
    if not (int(clean) == 0 and int(got_count) == torch_count == int(want_count) > 0 and same):
        fail(f"scatter_ftrl{what}: non-finite count {int(got_count)} (clean {int(clean)}), "
             f"torch's count of its outputs {torch_count}, the plain version's "
             f"{int(want_count)}, the same entries {same}")
    print(f"# scatter_ftrl{what} non-finite count: {int(got_count)} on the cotangent with NaN "
          f"and +-Inf placed (torch's count of the outputs {torch_count}, the plain "
          f"version's {int(want_count)}), 0 on the clean one", flush=True)
    return {"count": int(got_count), "torch": torch_count}


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
    z) by `ftrl_errs` (`leaves` and `flips` as there). Returns the card's
    (state, metrics)."""
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
    return s_gpu, m_gpu


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
    count must stay 0 (LR's gather is advanced indexing, `table[slots]`,
    and its gradient that indexing's backward, `index_put_` with
    accumulate, as both are XLA ops in the JAX package). Then one step
    from the trained checkpoint on the card and on the CPU on `batch` (the
    shard's first batch, parsed once for the MVM phases): the loss within
    LOSS_RTOL, w, n and z by `ftrl_errs`. Then the same two-pass step
    twice on the card from that one state: whether w, n and z agree
    bitwise is printed (a finding of the run, not a gate). Returns the
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
    print(f"# lr two-pass step twice on the card from one state: w, n, z bitwise "
          f"{lr_repeats_bitwise(lcfg, host)} (a finding, not a gate)", flush=True)
    return launches


def lr_repeats_bitwise(cfg, host: dict) -> dict:
    """LR's two-pass step run twice on the card on `host` from one restored
    state: {leaf: whether the two results agree bitwise} for w, n, z."""
    import torch

    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.step import make_train_step

    step = make_train_step(get_model("lr")(cfg), get_optimizer("ftrl"), cfg)
    state, arrays = restored_state(cfg, DEVICE), to_device(host, DEVICE)
    a, b = step(state, arrays)[0], step(state, arrays)[0]
    leaves = lambda s: (s.tables["w"], s.opt_state["w"]["n"], s.opt_state["w"]["z"])  # noqa: E731
    return {k: bool(torch.equal(x, y)) for k, x, y in zip("wnz", leaves(a), leaves(b))}


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
    from xflow_tpu_torch.optim.ftrl import update_one
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
              f"row_sums bitwise over {tuple(vals.shape)} channels; scatter "
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
    out["scatter_ftrl"]["bound_ms"], _ = bound_ms(
        6 * S * K * 4 + K * ss.numel() * 4 + ss.numel() * 4 + wo.numel() * 4,
        K * ss.numel() + FTRL_OPS_PER_ELEMENT * S * K)

    def composition():
        g = torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d_occ[:K].T)
        return update_one(v, n, z, g, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)

    out["scatter_ftrl"]["library_ms"] = cuda_ms(composition)
    print(f"# scatter_ftrl on the MVM product plan: {out['scatter_ftrl']['ms']:.4f} ms, bound "
          f"{out['scatter_ftrl']['bound_ms']:.4f} ms, the composition "
          f"{out['scatter_ftrl']['library_ms']:.4f} ms", flush=True)

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
    """#4, #6 and #3 on a skewed plan at the main paths' S and Np: B x F
    slots drawn uniformly from the table (seeded), except that one slot
    takes every row's first field, a run of B = 65,536 occurrences (16,384
    in each of #6's 4 stacked buffers). #4 at FM's K = 11 on the flat plan,
    #6 at MVM's K = 10 on the stacked one, d ~ N(0, 1) masked as the plan's
    pads are: bitwise against the CPU plain version and across two
    launches, bf16 off and on (the plain version adds the hot run's pieces
    in the kernels' order, `csrc/scatter_staged.cuh`); their error against
    plan order (`zeros` + `index_add_` on the CPU), which must be
    reordering alone (`reorder_err` under 1, reported as a share of the
    float32 reorder bound). #3 at K = 11 on the flat plan from a seeded
    FTRL state (`seeded_state`): bitwise across two launches and by
    `ftrl_errs` against its plain version on the CPU (g and w_rule gated),
    bf16 off and on.
    Returns {name: {hot_ms, hot_library_ms, hot_bound_ms, ...}}: the
    times on this plan (#3, #4 and #6 all split the hot run), zeros +
    index_add_ on it (for #3 the composition with the torch FTRL
    expression), and the bytes bound."""
    import numpy as np
    import torch

    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.tools.bench_lab import reorder_err

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
            if not bf16:
                plan_order = torch.zeros((S, K)).index_add_(0, ss_cpu.long(), d_cpu[:K].T)
                got = got.cpu()
                reorder = reorder_err(got, plan_order, d_cpu[:K], ss_cpu, S)
                if not reorder < 1:
                    fail(f"{name} on the hot-slot plan is {reorder} reorder bounds from plan "
                         "order: more than reordering")
                order_err = (got - plan_order).abs().max().item()
        ss_l = ss.long()
        out[name] = {
            "hot_ms": cuda_ms(lambda: run(d, ss, off, K, False), reps=5, warmup=1),
            "hot_library_ms": cuda_ms(
                lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d[:K].T),
                reps=5, warmup=1),
            "hot_bound_ms": bound_ms(S * K * 4 + (K + 1) * ss_np.size * 4, 0.0)[0],
            "hot_plan_order_max_abs_err": order_err, "hot_plan_order_reorder_share": reorder,
        }
        print(f"# {name} on the hot-slot plan ({ss_np.size} positions, a run of {BATCH} at "
              f"slot {HOT_SLOT}): bitwise, bf16 off and on; against plan order max abs err "
              f"{order_err:.3g}, {reorder:.3g} of the float32 reorder bound; "
              f"{out[name]['hot_ms']:.4f} ms, zeros + index_add_ "
              f"{out[name]['hot_library_ms']:.4f} ms, bound {out[name]['hot_bound_ms']:.4f} ms",
              flush=True)
    out["scatter_ftrl"] = check_hot_ftrl(flat, rng, S)
    return out


def check_hot_ftrl(flat, rng, S: int) -> dict:
    """#3 on the hot-slot plan (see `check_hot_scatters`) at FM's K = 11."""
    import numpy as np
    import torch

    from xflow_tpu_torch.config import FTRLConfig
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim.ftrl import update_one

    K, hp = 1 + V_DIM, FTRLConfig()
    ss_np = flat.sorted_slots
    d_np = rng.standard_normal((st._k8(K), ss_np.size), dtype=np.float32)
    d_np[:K] *= flat.sorted_mask[None, :]
    d_cpu, ss_cpu = torch.from_numpy(d_np), torch.from_numpy(np.ascontiguousarray(ss_np))
    d, ss = d_cpu.to(DEVICE), ss_cpu.to(DEVICE)
    off = torch.from_numpy(np.ascontiguousarray(flat.win_off)).to(DEVICE)
    tables, opt = seeded_state("wv", K, 0.01, SEED + 6)
    w, n, z = tables["wv"], opt["wv"]["n"], opt["wv"]["z"]
    prev_cpu = (w.cpu(), n.cpu(), z.cpu())
    for bf16 in (False, True):
        got = st.scatter_ftrl_cuda(d, ss, off, w, n, z, K, hp, bf16)
        again = st.scatter_ftrl_cuda(d, ss, off, w, n, z, K, hp, bf16)
        want = st.scatter_ftrl_plain(d_cpu, ss_cpu, *prev_cpu, K, hp, bf16)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"scatter_ftrl on the hot-slot plan (bf16={bf16}) gave different bits on two "
                 "launches")
        what = f"scatter_ftrl on the hot-slot plan (bf16={bf16}) against its plain version"
        # g and w_rule gated, w, n, z reported (see `ftrl_errs`): #3 and the
        # plain version sum the hot run's 65,536 unit terms in two float32
        # orders, each off from the exact sum by up to 5e-3 at worst, and
        # one channel's sum here is only -5.1, where that moves w' by 1e-3
        errs = ftrl_errs(got, want, prev_cpu, hp, what, leaves=False)
        print(f"# {what}: max err {errs} (tolerance {FTRL_RTOL}); bitwise across two launches",
              flush=True)
    ss_l = ss.long()

    def composition():
        g = torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d[:K].T)
        return update_one(w, n, z, g, hp.alpha, hp.beta, hp.lambda1, hp.lambda2)

    np_ = ss.numel()
    bound, _ = bound_ms(6 * S * K * 4 + K * np_ * 4 + np_ * 4 + off.numel() * 4,
                        K * np_ + FTRL_OPS_PER_ELEMENT * S * K)
    hot = {"hot_ms": cuda_ms(lambda: st.scatter_ftrl_cuda(d, ss, off, w, n, z, K, hp), reps=10),
           "hot_library_ms": cuda_ms(composition, reps=5, warmup=1), "hot_bound_ms": bound}
    print(f"# scatter_ftrl on the hot-slot plan ({np_} positions, a run of {BATCH} at slot "
          f"{HOT_SLOT}): {hot['hot_ms']:.4f} ms, bound {bound:.4f} ms, the composition "
          f"{hot['hot_library_ms']:.4f} ms", flush=True)
    return hot


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
    import torch

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
    two-pass step on the card against the CPU and a fused one against it,
    the repeated-field batch on the row-major route, the train CLI's main
    path, rate run and two-pass epoch, evaluate and `predict_rows` of the
    trained checkpoint, and the train step's stage breakdown. Every path
    has the launch counts, the FFM routes and the host calls set to 0
    just before and read just after. Returns the three kernels' FFM
    entries, each with the launches of its FFM main path."""
    import math

    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data import pipeline
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, evaluate, to_device
    from xflow_tpu_torch.models import ffm, get_model
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.serve.runner import ServeRunner
    from xflow_tpu_torch.train.checkpoint import restore_state
    from xflow_tpu_torch.train.step import loss_fn, make_train_step
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

    # --- the two-pass step, card against CPU; the fused step on the card
    # against it (the same state and batch: the FTRL tolerance, as the
    # CPU's); their times. One CPU step, not two: the smoke's time limit.
    state, batch_dev, step_ms, card = (restored_state(fcfg, DEVICE, restored),
                                       to_device(host, DEVICE), {}, {})
    for kind, extra, scatter in (("two-pass", {"optim.fused_scatter": "off"}, "scatter_sorted"),
                                 ("fused", {}, "scatter_ftrl")):
        c = override(fcfg, **extra)
        step = make_train_step(get_model("ffm")(c), get_optimizer("ftrl"), c)
        st.reset_launches()
        if kind == "two-pass":
            card[kind] = step_card_vs_cpu(c, host, f"ffm {kind}", "the restored FFM step-1 state",
                                          restored=restored, flips=True)
        else:
            card[kind] = step(restored_state(c, DEVICE, restored), batch_dev)
        counts_are(st.LAUNCHES, {"gather_sorted": 1, scatter: 1}, f"the ffm {kind} step")
        step_ms[kind] = cuda_ms(lambda step=step: step(state, batch_dev), reps=5, warmup=1)
    (s_f, m_f), (s_p, m_p) = card["fused"], card["two-pass"]
    lf, lp = m_f["loss"].item(), m_p["loss"].item()
    if not (abs(lf - lp) <= LOSS_RTOL * abs(lp) and bool(m_f["update_ok"])):
        fail(f"the ffm fused step on the card: loss {lf} against the two-pass step's {lp}, "
             f"update_ok {m_f['update_ok']}")

    def wnz(s):
        return s.tables["wv"], s.opt_state["wv"]["n"], s.opt_state["wv"]["z"]

    errs = ftrl_errs(wnz(s_f), wnz(s_p), wnz(state), fcfg.optim.ftrl,
                     "ffm fused step against the two-pass step, both on the card", flips=True)
    print(f"# ffm fused step from the restored FFM step-1 state, against the two-pass step on "
          f"the card: loss {lf} vs {lp}; max err {errs}", flush=True)
    del card, s_f, s_p
    print(f"# ffm train step on the card (CUDA events, guard on): fused {step_ms['fused']:.3f} "
          f"ms, two-pass {step_ms['two-pass']:.3f} ms per {FFM_BATCH}-row batch", flush=True)

    # --- the first batch with field 0 repeated in column 1: row-major, no
    # kernel; on the card, its loss against the CPU's forward
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
    model = get_model("ffm")(fcfg)
    st.reset_launches()
    s_r, m_r = make_train_step(model, get_optimizer("ftrl"), fcfg)(state, to_device(dup, DEVICE))
    torch.cuda.synchronize()
    counts_are(st.LAUNCHES, {}, "the row-major ffm step")
    with torch.no_grad():
        lc = loss_fn(restored_state(fcfg, "cpu", restored).tables, to_device(dup, "cpu"), model,
                     fcfg).item()
    lg = m_r["loss"].item()
    moved = int((s_r.tables["wv"] != state.tables["wv"]).sum())
    if not (abs(lg - lc) <= LOSS_RTOL * abs(lc) and bool(m_r["update_ok"]) and moved > 0):
        fail(f"ffm row-major step on the card: loss {lg} against the CPU forward's {lc}, "
             f"update_ok {m_r['update_ok']}, {moved} table entries moved")
    print(f"# ffm row-major (field 0 repeated) step on the card: loss {lg} vs the CPU "
          f"forward's {lc}; {moved} table entries moved, no kernel launched", flush=True)
    del restored, state, batch_dev, s_r
    lap("two steps (the two-pass one card vs CPU), the row-major step, two timed")

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
    floor = mosaic["floor_ms"]
    for name, key, replaces in LAB_PROBES:
        k = mosaic["kernels"][key]
        b_ms, b_by = bound_ms(k["bytes"], 0.0)
        kern.append({
            "name": name, "route": "cuda", "source": "xflow_tpu_torch/csrc/lab_mosaic.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": k["library_ms"], "ms_by": k["ms_by"], "host_ms": k["host_ms"],
            "floor_ms": floor, "floor_share": floor / k["ms"],
            **({"pieces": k["pieces"]} if "pieces" in k else {}),
            **({"tma_encode": tma} if key == "d" else {}),
        })
        pieces = f"{k['pieces']} pieces a slice, " if "pieces" in k else ""
        print(f"# lab {name}: {pieces}{k['ms']:.5f} ms by {k['ms_by']}, launch floor "
              f"{floor:.5f} ms, floor_share {floor / k['ms']:.3f}, bytes bound {b_ms:.7f} ms",
              flush=True)
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


FLEET_DRILL_SECONDS, FLEET_SECONDS = 15.0, 6.0  # the drill; each pace loop
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


def run_fleet(cfg, work: str, path: str, card: str) -> dict:
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
    return rep


ONLINE_PIECES, ONLINE_GAP_S, ONLINE_CARRY = 6, 1.5, 40  # phase 16's appends
ONLINE_PUBLISH_EVERY, ONLINE_KEEP, ONLINE_KEEP_REPLICA = 2, 2, 3
ONLINE_CONNECTIONS = 4


def online_pieces(rate_path: str, n: int) -> list:
    """The first `n` x BATCH rows of the rate shard as `n` byte pieces;
    every second piece ends ONLINE_CARRY bytes short of its last newline
    and the next piece starts with them (a writer mid-row)."""
    with open(rate_path, "rb") as f:
        pieces = [b"".join(f.readline() for _ in range(BATCH)) for _ in range(n)]
    for i in range(0, n - 1, 2):
        pieces[i], pieces[i + 1] = (pieces[i][:-ONLINE_CARRY],
                                    pieces[i][-ONLINE_CARRY:] + pieces[i + 1])
    return pieces


def append_pieces(path: str, pieces: list, gap_s: float, stop=None) -> None:
    """Append each piece to `path`, `gap_s` apart (a writer thread)."""
    for i, piece in enumerate(pieces):
        if i:
            time.sleep(gap_s)
        if stop is not None and stop.is_set():
            return
        with open(path, "ab") as f:
            f.write(piece)


def save_intervals_disjoint(recs: list) -> bool:
    """No two saves in flight: each submitted save's records (one queue
    instant) end before the next save is queued."""
    jobs: dict = {}
    for r in recs:
        if r["event"] != "skipped":
            jobs.setdefault(r["queued_ts"], []).append(r["committed_ts"])
    spans = sorted((q, max(ends)) for q, ends in jobs.items())
    return all(nxt[0] >= cur[1] for cur, nxt in zip(spans, spans[1:]))


def online_config(cfg, root: str, **extra):
    """The online loop at the FM headline's width: a tail fit over
    `<root>/stream-00000`, async tiered checkpoints, publications."""
    from xflow_tpu_torch.config import override

    return override(cfg, **{
        "data.train_path": os.path.join(root, "stream"), "data.stream": "tail",
        "data.stream_poll_s": 0.25, "data.stream_idle_s": 4, "data.cache": "on",
        "data.cache_dir": "", "data.stream_dir": os.path.join(root, "spool"),
        "train.publish_every": ONLINE_PUBLISH_EVERY, "train.ckpt_async": True,
        "train.checkpoint_dir": os.path.join(root, "ck"),
        "train.ckpt_replica_dir": os.path.join(root, "replica"),
        "train.keep_checkpoints": ONLINE_KEEP,
        "train.keep_replica_checkpoints": ONLINE_KEEP_REPLICA,
        "train.metrics_path": os.path.join(root, "train.jsonl"), "train.log_every": 0,
        **extra})


def check_tiers(ocfg, clones: dict) -> None:
    """The tiers after the tail run: at most ONLINE_KEEP committed steps in
    the primary and ONLINE_KEEP_REPLICA in the replica, each replica step
    digest-verified and its state.npz byte-equal to the primary's where
    both hold it, and every replica step bitwise the state the fit loop
    held at that step (`clones`, device copies taken right after it):
    the snapshots were taken while later steps ran."""
    import numpy as np

    from xflow_tpu_torch.train.checkpoint import committed_steps, restore_step_arrays

    tc = ocfg.train
    prim, rep = committed_steps(tc.checkpoint_dir), committed_steps(tc.ckpt_replica_dir)
    if not prim or len(prim) > ONLINE_KEEP or not rep or len(rep) > ONLINE_KEEP_REPLICA:
        fail(f"retention: primary steps {prim} (keep {ONLINE_KEEP}), replica {rep} "
             f"(keep {ONLINE_KEEP_REPLICA})")
    S, K = 1 << LOG2_SLOTS, 1 + V_DIM
    labels = {f"{g}": (S, K) for g in ("tables/wv", "opt/wv/n", "opt/wv/z")}
    for step in rep:
        got = restore_step_arrays(tc.ckpt_replica_dir, step, labels)  # digest-verified
        if step in prim:
            a = open(os.path.join(tc.ckpt_replica_dir, f"step_{step}", "state.npz"), "rb").read()
            b = open(os.path.join(tc.checkpoint_dir, f"step_{step}", "state.npz"), "rb").read()
            if a != b:
                fail(f"replica step {step}'s state.npz differs from the primary's")
        if step in clones:
            for label, arr in got.items():
                if not np.array_equal(arr, clones[step][label]):
                    fail(f"replica step {step} {label} is not the state the fit loop held "
                         "at that step: the async snapshot was overwritten")
    print(f"# online: primary steps {prim}, replica steps {rep} (digest-verified, "
          f"byte-equal where both hold a step, bitwise the fit loop's state at "
          f"{sorted(set(rep) & set(clones))})", flush=True)


def run_online(cfg, work: str, path: str, rate_path: str, card: str) -> None:
    """Phase 16, the online loop on the card: (a) a tail fit over a shard
    a writer thread grows, async tiered checkpoints and publications; (b)
    `serve --device cuda` over its primary dir meanwhile; (c) the
    segments replayed one `fit` each; (d) the fit loop's stall per save,
    synchronous against async, at FM and FFM width; (e) the SIGTERM
    drill of a tail `train` subprocess."""
    import threading

    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data import pipeline
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.tools import serve_bench
    from xflow_tpu_torch.train import checkpoint as ckpt
    from xflow_tpu_torch.train.trainer import Trainer

    root = os.path.join(work, "online")
    os.makedirs(root)
    ocfg = online_config(cfg, root)
    tc = ocfg.train
    laps = [time.perf_counter()]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        print(f"# online phase: {what} in {laps[-1] - laps[-2]:.1f} s", flush=True)

    pieces = online_pieces(rate_path, ONLINE_PIECES)
    stream = os.path.join(root, "stream-00000")
    open(stream, "wb").close()
    ta = Trainer(ocfg, device=DEVICE)
    initial = ckpt.flatten_state(ta.state.tables, ta.state.opt_state, 0)
    snapshot_report(ta.state, "FM", card)  # the process's first pinned buffers of FM's size
    if not ta.save_checkpoint(wait=True):  # step 0: what the server starts on
        fail("the initial commit was skipped")
    lap("the trainer built and step 0 committed")

    # --- (b) the server over the primary dir, and its closed loop
    serve_jsonl, serve_err = os.path.join(root, "serve.jsonl"), os.path.join(root, "serve.err")
    proc, ready = start_server(
        [sys.executable, "-m", "xflow_tpu_torch", "serve", *serve_flags(tc.checkpoint_dir),
         "--metrics-path", serve_jsonl, "--set", "serve.trace_sample_rate=0.01"], serve_err)
    try:
        if ready["device"] != torch.cuda.get_device_name(0) or ready["step"] != 0:
            fail(f"ready line {ready}: expected step 0 on the card")
        lap("the server started on step 0")
        args = serve_bench.build_parser().parse_args([
            "--url", f"http://127.0.0.1:{ready['port']}", "--duration", "300",
            "--concurrency", str(ONLINE_CONNECTIONS), "--data", path,
            "--rows-per-request", "1-8"])
        bench_stop, bench = threading.Event(), {}
        bench_thread = threading.Thread(
            target=lambda: bench.update(serve_bench.run(args, stop=bench_stop)), daemon=True)
        bench_thread.start()

        # --- (a) the tail run
        losses, clones, pubs = [], {}, []
        step_fn = ta.train_step

        def recording(state, batch):
            new, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            if new.step % ONLINE_PUBLISH_EVERY == 0:  # the cadence step's state, on the card
                clones[new.step] = {"tables/wv": new.tables["wv"].clone(),
                                    "opt/wv/n": new.opt_state["wv"]["n"].clone(),
                                    "opt/wv/z": new.opt_state["wv"]["z"].clone()}
            return new, m

        save = ta.save_checkpoint

        def recording_save(publication=None, wait=False):
            ok = save(publication=publication, wait=wait)
            if ok and publication is not None:
                pubs.append(publication)
            return ok

        ta.train_step, ta.save_checkpoint = recording, recording_save
        writer = threading.Thread(target=append_pieces, args=(stream, pieces, ONLINE_GAP_S))
        st.reset_launches()
        pipeline.reset_host_calls()
        t0 = time.perf_counter()
        writer.start()
        res = ta.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = dict(st.LAUNCHES), pipeline.host_calls()
        writer.join(timeout=60)
        ta.train_step, ta.save_checkpoint = step_fn, save
        lap(f"the tail run: {res.steps} steps, {len(pubs)} publications")

        # the server follows to the last publication, then the loop stops
        last = pubs[-1]["step"] if pubs else -1
        deadline, health = time.monotonic() + 60, {}
        while time.monotonic() < deadline:
            health = get_json(ready["port"], "/healthz")[1]
            if health.get("step") == last:
                break
            time.sleep(0.25)
        time.sleep(1.0)  # a window or two on the last step
        bench_stop.set()
        bench_thread.join(timeout=60)
        lap("the server reached the last publication")
    finally:
        stop_server(proc, serve_err, "the server over the online loop")

    # --- (a)'s checks
    recs = read_jsonl(tc.metrics_path)
    ingests = [r for r in recs if r.get("kind") == "ingest"]
    ck_recs = [r for r in recs if r.get("kind") == "ckpt"]
    publish_recs = [r for r in recs if r.get("kind") == "publish"]
    spool = b"".join(open(os.path.join(ocfg.data.stream_dir, "segment-%06d" % r["seq"]),
                          "rb").read() for r in sorted(ingests, key=lambda r: r["seq"]))
    want_steps = sum(-(-r["rows"] // BATCH) for r in ingests)
    want_launch = {"gather_sorted": res.steps, "row_sums": res.steps,
                   "scatter_ftrl": res.steps}
    if {k: v for k, v in launches.items() if v} != want_launch:
        fail(f"the tail run of {res.steps} steps launched {launches}: expected #1, #2 and #3 "
             "once a step and nothing else")
    if spool != open(stream, "rb").read() or sum(r["rows"] for r in ingests) != (
            ONLINE_PIECES * BATCH):
        fail(f"the spooled segments ({len(spool)} bytes, "
             f"{sum(r['rows'] for r in ingests)} rows) are not the file's "
             f"({os.path.getsize(stream)} bytes, {ONLINE_PIECES * BATCH} rows)")
    if res.steps != want_steps or res.interrupted or res.bad_steps:
        fail(f"tail run {res}: expected {want_steps} steps (each segment's batches)")
    if calls["cache_batches"] != res.steps or calls["native_plan"] != res.steps or (
            calls["python_rows"]):
        fail(f"the tail run did not read every segment from its .xfc cache and plan it "
             f"natively: host calls {calls}")
    committed = {r["step"] for r in ck_recs if r["tier"] == "primary"
                 and r["event"] == "committed"}
    if not pubs or [p["seq"] for p in pubs] != list(range(1, len(pubs) + 1)) or any(
            p["step"] not in committed for p in pubs) or len(publish_recs) != len(pubs):
        fail(f"publications {[(p['step'], p['seq']) for p in pubs]}: each must be "
             f"committed (committed primary steps {sorted(committed)})")
    if any(not p["published_ts"] >= p["consumed_ts"] >= p["ingest_ts"] for p in pubs):
        fail(f"publication times out of order: {pubs}")
    if not save_intervals_disjoint(ck_recs) or any(r["event"] == "failed" for r in ck_recs):
        fail(f"checkpoint records show a failure or two saves in flight: {ck_recs}")
    check_tiers(ocfg, {s: {k: v.cpu().numpy() for k, v in c.items()}
                       for s, c in clones.items()})
    skips = [r["step"] for r in ck_recs if r["event"] == "skipped"]
    for tier in ("primary", "replica"):
        ms = [r["write_ms"] for r in ck_recs if r["tier"] == tier and r["event"] == "committed"]
        print(f"# online: {tier} write_ms of {len(ms)} async saves of {ck_recs[0]['bytes']} "
              f"bytes on {card}: {ms}", flush=True)
    print(f"# online: the tail run on {card}: {res.steps} steps in {wall:.2f} s wall "
          f"({res.examples} rows over {len(ingests)} segments of rows "
          f"{[r['rows'] for r in ingests]}), launches {launches}, host calls {calls}, "
          f"skipped saves at steps {skips}", flush=True)

    # --- (b)'s checks
    srecs = read_jsonl(serve_jsonl)
    windows = [r for r in srecs if r.get("kind") == "serve" and "requests" in r]
    fresh = [r["data_freshness_s"] for r in windows if "data_freshness_s" in r]
    served = {r["step"]: r["t0"] for r in srecs
              if r.get("kind") == "span" and r.get("name") == "serve_first"}
    live = {r["step"]: r["ts"] for r in srecs
            if r.get("kind") == "serve" and r.get("event") == "reload"}
    print(f"# online serve_bench: {json.dumps(bench)}", flush=True)
    if bench.get("errors") != 0 or health.get("step") != last or not bench["steps"] or (
            bench["steps"][-1] != last) or len(bench["steps"]) < 2 or not fresh:
        fail(f"serving over the loop: errors {bench.get('errors')} "
             f"({bench.get('first_error')}), steps served {bench.get('steps')}, /healthz "
             f"{health}, last publication {last}, {len(fresh)} windows with freshness")
    for p in pubs:
        since = lambda t: f"{t - p['ingest_ts']:.3f} s" if t else "-"  # noqa: E731
        print(f"# online publication seq {p['seq']} step {p['step']}, seconds after its "
              f"ingest: consumed {since(p['consumed_ts'])}, published "
              f"{since(p['published_ts'])}, live in the server {since(live.get(p['step']))}, "
              f"first served {since(served.get(p['step']))}", flush=True)
    print(f"# online: data_freshness_s of {len(fresh)} serve windows on {card}: min "
          f"{min(fresh):.3f}, max {max(fresh):.3f}", flush=True)
    lap("(a) and (b) checked")

    # --- (c) parity: the segments replayed one fit each from the initial state
    rcfg = override(ocfg, **{"data.stream": "off", "train.epochs": 1,
                             "train.checkpoint_dir": "", "train.ckpt_replica_dir": "",
                             "train.metrics_path": "", "train.ckpt_async": False,
                             "train.publish_every": 0})
    tr = Trainer(rcfg, device=DEVICE)
    replay_losses = []
    step_fn = tr.train_step

    def replay_recording(state, batch):
        new, m = step_fn(state, batch)
        replay_losses.append(float(m["loss"]))
        return new, m

    tr.train_step = replay_recording
    for r in sorted(ingests, key=lambda r: r["seq"]):
        tr.fit(os.path.join(ocfg.data.stream_dir, "segment-%06d" % r["seq"]))
    if len(replay_losses) != len(losses) or not np.allclose(
            replay_losses, losses, rtol=LOSS_RTOL, atol=0):
        fail(f"replayed losses {replay_losses} vs the tail run's {losses}")
    prev = tuple(torch.from_numpy(initial[k]).to(DEVICE)
                 for k in ("tables/wv", "opt/wv/n", "opt/wv/z"))
    leaves = lambda s: (s.tables["wv"], s.opt_state["wv"]["n"], s.opt_state["wv"]["z"])  # noqa: E731
    # several steps from the initial state: the row sum's atomic adds
    # reorder each step's logits in their last bits, so the leaves drift
    # apart by more than one step's floor (z by about 1e-3 of it) while
    # the implied gradient and the FTRL rule still hold (`leaves` False)
    errs = ftrl_errs(leaves(ta.state), leaves(tr.state), prev, ocfg.optim.ftrl,
                     "the tail run against its replay", leaves=False, flips=True)
    got = ckpt.restore_step_arrays(tc.checkpoint_dir, last, {
        k: (1 << LOG2_SLOTS, 1 + V_DIM) for k in ("tables/wv", "opt/wv/n", "opt/wv/z")})
    live = {k: v.cpu().numpy() for k, v in zip(("tables/wv", "opt/wv/n", "opt/wv/z"),
                                                leaves(ta.state))}
    if any(not np.array_equal(got[k], live[k]) for k in live):
        fail(f"the last commit (step {last}) is not the live state bitwise")
    print(f"# online replay: {len(losses)} losses within {LOSS_RTOL} relative; final "
          f"w, n, z errs {errs}; the last commit (step {last}) equals the live state "
          "bitwise", flush=True)
    lap("(c) the replay")

    # --- (d) the fit loop's stall per save
    def stall(trainer, extra: dict) -> float:
        trainer.cfg = override(ocfg, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not trainer.save_checkpoint():
            fail(f"a save with {extra} was skipped")
        return (time.perf_counter() - t0) * 1e3

    sync_ms = stall(ta, {"train.ckpt_async": False, "train.ckpt_replica_dir": "",
                         "train.checkpoint_dir": os.path.join(root, "stall_sync")})
    async_ms = []
    for i in range(2):  # a new writer's first save stages into new pinned buffers
        async_ms.append(stall(ta, {"train.ckpt_replica_dir": "",
                                   "train.checkpoint_dir": os.path.join(root, f"stall_{i}")}))
        ta._ckpt_writer.drain()
    ta._ckpt_writer.close()
    ta._ckpt_writer = None
    # the two async saves' records (primary only: no replica dir)
    write_ms = [r["write_ms"] for r in read_jsonl(tc.metrics_path)
                if r.get("kind") == "ckpt"][-2:]
    nbytes = ta._state_nbytes()
    print(f"# online stall per save at FM width ({nbytes / 1e6:.1f} MB) on {card}: "
          f"synchronous {sync_ms:.1f} ms; async (snapshot + submit) {async_ms[0]:.2f} ms "
          f"a new writer's first save, {async_ms[1]:.2f} ms its second; the writer's write_ms "
          f"{write_ms}", flush=True)
    del ta, tr, clones
    torch.cuda.empty_cache()
    lap("(d) the stall at FM width")

    from xflow_tpu_torch.train.checkpoint import restore_state
    from xflow_tpu_torch.train.state import TrainState
    from xflow_tpu_torch.weights import table_shapes

    fcfg = ffm_config(cfg, os.path.join(work, "ck_ffm"))
    restored = restore_state(fcfg.train.checkpoint_dir, table_shapes(fcfg), ("n", "z"))
    fstate = restored_state(fcfg, DEVICE, restored)
    del restored
    tf = Trainer(override(fcfg, **{"train.checkpoint_dir": os.path.join(root, "ffm_sync")}),
                 device=DEVICE)
    tf.state = TrainState(fstate.tables, fstate.opt_state, fstate.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.save_checkpoint()
    ffm_sync_s = time.perf_counter() - t0
    print(f"# online: FFM's synchronous save ({tf._state_nbytes() / 1e6:.1f} MB) on {card}: "
          f"{ffm_sync_s:.2f} s of the fit loop's time", flush=True)
    snapshot_report(tf.state, "FFM", card)
    del tf, fstate
    torch.cuda.empty_cache()
    lap("(d) the stall at FFM width")

    # --- (e) the SIGTERM drill
    drill(cfg, root, rate_path)
    lap("(e) the SIGTERM drill")


def snapshot_report(state, what: str, card: str) -> None:
    """Two async snapshots of `state` through one pinned staging: the
    first allocates the pinned buffers, the second reuses them. Prints
    each's host time, the allocation's, the copy's wait to its event and
    rate, and the card's memory before, at the peak and after the event."""
    import torch

    from xflow_tpu_torch.train.checkpoint import PinnedStaging, SaveSnapshot

    staging = PinnedStaging()
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        snap = SaveSnapshot(state.tables, state.opt_state, state.step, staging)
        t1 = time.perf_counter()
        snap.materialize()
        t2 = time.perf_counter()
        peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        out.append((t1 - t0, snap.alloc_ms, t2 - t1, before, peak, after))
        if peak > before:
            fail(f"the {what} snapshot allocated {peak - before} bytes on the card")
    for i, (launch_s, alloc_ms, wait_s, before, peak, after) in enumerate(out):
        print(f"# online: {what} snapshot {i + 1} of {snap.nbytes / 1e6:.1f} MB on {card}: "
              f"{launch_s * 1e3:.2f} ms on the fit loop ({alloc_ms:.2f} ms of it the pinned "
              f"allocation), then {wait_s * 1e3:.1f} ms to its event "
              f"({snap.nbytes / max(wait_s, 1e-9) / 1e9:.1f} GB/s over the link); card memory "
              f"{before / 2**20:.1f} MiB before, {peak / 2**20:.1f} MiB at the peak, "
              f"{after / 2**20:.1f} MiB after the event", flush=True)


def drill(cfg, root: str, rate_path: str) -> None:
    """(e): `python -m xflow_tpu_torch train --device cuda` in tail mode
    with async saves on a fresh stream that a writer thread grows;
    SIGTERM after its second publication. It must exit 0 with an
    `interrupted` record, its newest committed step the step it reached,
    and a resumed `train` must restore from that step."""
    import signal
    import threading

    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.train.checkpoint import committed_steps

    d = os.path.join(root, "drill")
    os.makedirs(d)
    stream, ck, metrics = (os.path.join(d, "stream-00000"), os.path.join(d, "ck"),
                           os.path.join(d, "train.jsonl"))
    open(stream, "wb").close()
    argv = [sys.executable, "-m", "xflow_tpu_torch", "train", "--train", stream[:-6],
            "--model", "fm", "--batch-size", str(BATCH), "--log2-slots", str(LOG2_SLOTS),
            "--checkpoint-dir", ck, "--device", DEVICE,
            "--set", f"model.v_dim={V_DIM}", "--set", f"model.num_fields={NUM_FIELDS}",
            "--set", f"data.max_nnz={NUM_FIELDS}", "--set", "data.stream=tail",
            "--set", "data.stream_poll_s=0.25", "--set", "data.cache=on",
            "--set", "train.ckpt_async=true", "--set", "train.publish_every=1"]
    err = os.path.join(d, "train.err")
    stop = threading.Event()
    # the first piece is there at the start; the rest follow once the run
    # follows, a save's time apart, so the second publication is not skipped
    first, *rest = online_pieces(rate_path, 3)
    append_pieces(stream, [first], 0.0)
    writer = threading.Thread(target=append_pieces, args=(stream, rest, 3.0, stop))

    def wait_for(kind: str, count: int) -> None:
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                fail(f"the drill's train exited {proc.returncode} before the signal: "
                     f"{open(err).read()[-3000:]}")
            if os.path.exists(metrics) and sum(
                    r.get("kind") == kind for r in read_jsonl(metrics)) >= count:
                return
            time.sleep(0.1)
        fail(f"the drill saw no {kind} record {count} in 180 s: {open(err).read()[-3000:]}")

    with open(err, "w") as ef:
        proc = subprocess.Popen(argv + ["--set", "data.stream_idle_s=600",
                                        "--set", f"train.metrics_path={metrics}"],
                                cwd=HERE, stdout=subprocess.PIPE, stderr=ef, text=True)
    try:
        wait_for("ingest", 1)
        writer.start()
        wait_for("publish", 2)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        t_exit = time.perf_counter() - t_sig
    finally:
        stop.set()
        writer.join(timeout=30)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    recs = read_jsonl(metrics)
    marks = [r for r in recs if "interrupted" in r]
    summary = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    newest = committed_steps(ck)[:1]
    if proc.returncode != 0 or len(marks) != 1 or summary.get("interrupted") != signal.SIGTERM \
            or newest != [marks[0]["step"]] or summary.get("steps") != marks[0]["step"]:
        fail(f"SIGTERM drill: exit {proc.returncode}, interrupted records {marks}, summary "
             f"{summary}, newest committed {newest}: {open(err).read()[-3000:]}")
    r = subprocess.run(argv + ["--set", "data.stream_idle_s=2"], cwd=HERE, capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0 or f"resumed from step {newest[0]}" not in r.stderr:
        fail(f"the drill's resumed train exited {r.returncode} without resuming from step "
             f"{newest[0]}: {r.stderr[-3000:]}")
    print(f"# online drill: SIGTERM after the second publication, at step "
          f"{marks[0]['step']}: exit 0 {t_exit:.2f} s after the signal, newest committed "
          f"step {newest[0]}; the resumed train restored it", flush=True)


OBS_ALPHA = 1.05  # bench.py's Zipf draw (bench.py:205-216)
OBS_TRAIN_ROWS, OBS_TEST_ROWS = RATE_BATCHES * BATCH, 2 * BATCH
OBS_TRACE_START, OBS_TRACE_STEPS = 5, 3
OBS_STAMP = {"ts", "rank", "run_id", "gen", "world"}
OBS_HBM = {"hbm_bytes_in_use", "hbm_peak_bytes", "hbm_bytes_limit"}
OBS_HEALTH = {"grad_norm", "grad_norm_max", "update_norm", "param_norm", "loss_ema",
              "slots_touched", "table_occupancy", "est_collision_rate"}
OBS_WINDOW = {"steps_per_s", "rows_per_s", "step_time_p50_ms", "step_time_p99_ms",
              "data_wait_ms", "dispatch_ms", "device_ms"}
# the key sets of the JAX trainer's records under phase 17's flags, less
# its roofline gauges (tests/test_torch_observe.py holds the port's key
# sets equal to the JAX trainer's on the CPU, where neither has the HBM
# gauges; a TPU's allocator reports them, as the card's does)
OBS_KEYS = {
    "window": OBS_STAMP | {"step", "epoch", "loss", "examples", "elapsed_s", "counters"}
    | OBS_WINDOW | OBS_HBM | OBS_HEALTH,
    "eval": OBS_STAMP | {"step", "epoch", "eval_auc", "eval_logloss"},
    "final": OBS_STAMP | {"final", "steps", "examples", "elapsed_s", "occupancy", "counters"}
    | OBS_HBM | OBS_HEALTH,
}
# each launch key's kernel names in a trace, in launch order: a call of
# #2 is the five kernels of `csrc/row_sums.cu`
OBS_KERNEL_NAMES = {"gather_sorted": ("gather_flat",),
                    "row_sums": ("row_sums_count_kernel", "row_sums_reserve_kernel",
                                 "row_sums_place_kernel", "row_sums_reduce_kernel",
                                 "row_sums_long_kernel"),
                    "scatter_ftrl": ("scatter_ftrl_kernel",)}
OBS_GEN_TIMEOUT_S = 90  # both gen-data writers (20.2 s on the H100 host)

_CLI_WITH_LAUNCHES = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv.pop(1))\n"
    "from xflow_tpu_torch.__main__ import main\n"
    "from xflow_tpu_torch.ops import sorted_table as st\n"
    "rc = main(sys.argv[1:])\n"
    "print('# launches ' + json.dumps(st.LAUNCHES), file=sys.stderr)\n"
    "sys.exit(rc)\n"
)


def port_cli(cwd: str, *argv: str, timeout: float = 300.0):
    """`python -m xflow_tpu_torch`'s main in a subprocess run in `cwd`,
    printing the kernels' launch counts on its stderr at the end.
    Returns (stdout, stderr, launches); fails on a non-zero exit."""
    r = subprocess.run([sys.executable, "-c", _CLI_WITH_LAUNCHES, HERE, *argv], cwd=cwd,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        fail(f"{' '.join(argv[:3])} exited {r.returncode}: {r.stderr[-3000:]}")
    tail = [ln for ln in r.stderr.splitlines() if ln.startswith("# launches ")]
    return r.stdout, r.stderr, json.loads(tail[-1][len("# launches "):])


def obs_train_argv(epochs: int, *extra: str, prefix: str = "train") -> list:
    return ["train", "--train", prefix, "--model", "fm", "--epochs", str(epochs),
            "--batch-size", str(BATCH), "--log2-slots", str(LOG2_SLOTS), "--device", DEVICE,
            "--set", f"model.v_dim={V_DIM}", "--set", f"model.num_fields={NUM_FIELDS}",
            "--set", f"data.max_nnz={NUM_FIELDS}", *extra]


def obs_flags(run: str) -> list:
    """Every observability flag on, the records under `run/`."""
    out = []
    for k, v in (("log_every", 1), ("health_metrics", "norms"), ("pipeline_metrics", "true"),
                 ("metrics_path", f"{run}/metrics_rank0.jsonl"),
                 ("heartbeat_path", f"{run}/heartbeat_rank0.jsonl"), ("heartbeat_every", 1),
                 ("hang_timeout_s", 30)):
        out += ["--set", f"train.{k}={v}"]
    return out


SPLIT_KEYS = ("data_wait_ms", "dispatch_ms", "device_ms", "rows_per_s")


def window_split(recs: list) -> str:
    """The window records' split and rate: median / mean over the steps
    (the mean carries the first step, the trace window's start and stop
    and the epoch's eval), then each step's data wait, dispatch and
    device ms."""
    import numpy as np

    wins = [r for r in recs if "device_ms" in r and "loss" in r]
    out = ", ".join(f"{k} {np.median([r[k] for r in wins]):.3f} / "
                    f"{np.mean([r[k] for r in wins]):.3f}" for k in SPLIT_KEYS)
    for k in SPLIT_KEYS[:3]:
        out += f"; {k} a step {[round(r[k], 2) for r in wins]}"
    return out


def trace_kernels(prof_dir: str) -> dict:
    """{launch key: [device us of each call]} of #1-#3 in the trace
    window's Chrome trace, by kernel name (OBS_KERNEL_NAMES): a call
    starts at its first kernel, and its time is the sum of its kernels'.
    Fails unless each of a key's kernels is traced once a call."""
    (name,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    out = {k: [] for k in OBS_KERNEL_NAMES}
    seen = {k: [0] * len(names) for k, names in OBS_KERNEL_NAMES.items()}
    for e in kernels:
        for k, names in OBS_KERNEL_NAMES.items():
            hit = [i for i, kname in enumerate(names) if kname in e.get("name", "")]
            if not hit:
                continue
            seen[k][hit[0]] += 1
            if hit[0] == 0:
                out[k].append(0.0)
            if out[k]:
                out[k][-1] += float(e["dur"])
    for k, counts in seen.items():
        if len(set(counts)) > 1:
            fail(f"the trace in {prof_dir} holds {k}'s kernels "
                 f"{dict(zip(OBS_KERNEL_NAMES[k], counts))} times: not each once a call")
    return out


def check_zipf_scatters(zipf_batch, uniform_batch) -> dict:
    """#4 (K = 11, the flat plan) and #6 (K = 10, the plan stacked in 4
    buffers) on phase 17's first Zipf batch and on the uniform rate
    shard's first batch, d ~ N(0, 1) masked as the plans' pads are:
    bitwise against the plain version on the CPU and across two launches,
    then CUDA-event times of the kernel and of `zeros` + `index_add_`.
    Returns {name: {zipf_ms, zipf_library_ms, zipf_bound_ms, uniform_ms,
    uniform_library_ms, zipf_longest_run}}."""
    import numpy as np
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    S = 1 << LOG2_SLOTS
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for name, K in (("scatter_sorted", 1 + V_DIM), ("scatter_sorted_multi", V_DIM)):
        entry = {}
        for what, b in (("zipf", zipf_batch), ("uniform", uniform_batch)):
            if name == "scatter_sorted":
                plan = st.plan_sorted_batch(b.slots, b.mask, S)
                ss_np, off_np, m_np = plan.sorted_slots, plan.win_off, plan.sorted_mask
            else:
                plan = st.plan_sorted_stacked(b.slots, b.mask, S, num_sub=4)
                ss_np, off_np = plan.sorted_slots.reshape(-1), plan.win_off
                m_np = plan.sorted_mask.reshape(-1)
            d_np = rng.standard_normal((st._k8(K), ss_np.size), dtype=np.float32)
            d_np[:K] *= m_np[None, :]
            d_cpu, ss_cpu, off_cpu = (torch.from_numpy(np.ascontiguousarray(a))
                                      for a in (d_np, ss_np, off_np))
            d, ss, off = d_cpu.to(DEVICE), ss_cpu.to(DEVICE), off_cpu.to(DEVICE)
            if name == "scatter_sorted":
                def run(d=d, ss=ss, off=off, K=K):
                    return st.scatter_sorted_cuda(d, ss, off, S, K)
                want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, K)
            else:
                def run(d=d, ss=ss, off=off, K=K):
                    return st.scatter_sorted_multi_cuda(d, ss, off, S, K)
                want = st.scatter_sorted_multi_plain(d_cpu, ss_cpu, off_cpu, S, K)
            got, again = run(), run()
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(got.cpu(), want)):
                fail(f"{name} on the {what} batch's plan is not bitwise equal across two "
                     f"launches and to its CPU plain version")
            ss_l = ss.long()
            entry[f"{what}_ms"] = cuda_ms(run)
            entry[f"{what}_library_ms"] = cuda_ms(
                lambda ss_l=ss_l, d=d, K=K: torch.zeros((S, K), device=DEVICE).index_add_(
                    0, ss_l, d[:K].T))
            if what == "zipf":
                entry["zipf_bound_ms"] = bound_ms(S * K * 4 + (K + 1) * ss_np.size * 4, 0.0)[0]
                entry["zipf_longest_run"] = int(np.unique(ss_np[m_np > 0],
                                                          return_counts=True)[1].max())
        out[name] = entry
        print(f"# {name} (K = {K}) on phase 17's first Zipf batch (longest run "
              f"{entry['zipf_longest_run']}): bitwise; {entry['zipf_ms']:.4f} ms, zeros + "
              f"index_add_ {entry['zipf_library_ms']:.4f} ms, bound {entry['zipf_bound_ms']:.4f} "
              f"ms; on the uniform rate shard's first batch {entry['uniform_ms']:.4f} ms, zeros + "
              f"index_add_ {entry['uniform_library_ms']:.4f} ms", flush=True)
    return out


def run_observe(work: str, rate_path: str, card: str) -> dict:
    """Phase 17, the trainer's observability on Zipf data at FM width:
    the port's `gen-data` writes the shards, `train --device cuda` runs 2
    epochs with every observability flag on, 1 epoch of the uniform rate
    shard under the same trace window, then 1 epoch with the guard off
    and 1 with the guard and observability off. Returns {launch key:
    {"trace_ms", "uniform_trace_ms", "launches"}} for #1-#3, and #4's and
    #6's times on the first Zipf batch's plans (`check_zipf_scatters`)."""
    import numpy as np

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.telemetry import HealthMonitor, Registry, pipeline_verdict

    root = os.path.join(work, "observe")
    os.makedirs(root)
    t_phase = time.perf_counter()
    # (1) the data, through the CLI: train and test share the planted truth
    gens = {}
    for name, rows, seed in (("train", OBS_TRAIN_ROWS, SEED + 7), ("test", OBS_TEST_ROWS,
                                                                   SEED + 8)):
        argv = ["gen-data", name, "--bulk", "--zipf-alpha", str(OBS_ALPHA), "--ids-per-field",
                str(IDS_PER_FIELD), "--fields", str(NUM_FIELDS), "--shards", "1", "--rows",
                str(rows), "--seed", str(seed), "--truth-seed", str(SEED + 7)]
        # each writer's output goes to files, so a full pipe cannot block it
        with open(os.path.join(root, f"gen-{name}.out"), "w") as fo, \
                open(os.path.join(root, f"gen-{name}.err"), "w") as fe:
            gens[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-c", _CLI_WITH_LAUNCHES, HERE, *argv], cwd=root,
                stdout=fo, stderr=fe))
    done = {}
    deadline = time.perf_counter() + OBS_GEN_TIMEOUT_S
    while len(done) < len(gens):  # each writer's own end (both run at once)
        for name, (t0, proc) in gens.items():
            if name not in done and proc.poll() is not None:
                done[name] = time.perf_counter() - t0
        if len(done) < len(gens) and time.perf_counter() > deadline:
            for _, proc in gens.values():
                proc.kill()
                proc.wait()
            fail(f"gen-data: {sorted(set(gens) - set(done))} still writing after "
                 f"{OBS_GEN_TIMEOUT_S} s")
        time.sleep(0.05)
    for name, (t0, proc) in gens.items():
        out = open(os.path.join(root, f"gen-{name}.out")).read()
        if proc.returncode != 0 or out.split() != [f"{name}-00000"]:
            err = open(os.path.join(root, f"gen-{name}.err")).read()
            fail(f"gen-data {name} exited {proc.returncode}: {out} {err[-2000:]}")
        path = os.path.join(root, f"{name}-00000")
        dt = done[name]
        mb = os.path.getsize(path) / 1e6
        print(f"# observe: gen-data {name} (Zipf {OBS_ALPHA}, bulk): "
              f"{sum(1 for _ in open(path))} rows, {mb:.1f} MB in {dt:.1f} s "
              f"({mb / dt:.1f} MB/s, written beside the other)", flush=True)
    dcfg = override(Config(), **{"data.batch_size": BATCH, "data.max_nnz": NUM_FIELDS,
                                 "data.log2_slots": LOG2_SLOTS}).data
    it = batch_iterator(os.path.join(root, "train-00000"), dcfg)
    first = next(it)
    it.close()
    occ = first.slots[first.mask > 0]
    _, counts = np.unique(occ, return_counts=True)
    top = [int(np.bincount(first.slots[:, f]).max()) for f in range(NUM_FIELDS)]
    mon = HealthMonitor(mode="norms", registry=Registry(), num_slots=1 << LOG2_SLOTS)
    t0 = time.perf_counter()
    for _ in range(3):
        mon.observe_batch(first.slots, first.mask)
    observe_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"# observe: the first batch's plan: {occ.size} occurrences over {counts.size} slots, "
          f"the longest slot run {int(counts.max())} occurrences; each field's top id in "
          f"{min(top)}-{max(top)} of {BATCH} rows; HealthMonitor.observe_batch on it "
          f"{observe_ms:.2f} ms (host, the prefetch thread's)", flush=True)
    it = batch_iterator(rate_path, dcfg)
    scatters = check_zipf_scatters(first, next(it))
    it.close()

    # (2) 2 epochs with every flag on
    t0 = time.perf_counter()
    out, err, launches = port_cli(root, *obs_train_argv(
        2, "--test", "test", *obs_flags("run"), "--set", "train.profile_dir=prof",
        "--set", f"train.trace_start_step={OBS_TRACE_START}",
        "--set", f"train.trace_num_steps={OBS_TRACE_STEPS}", "--set", "train.eval_every=1"))
    wall = time.perf_counter() - t0
    summary = json.loads(out.strip().splitlines()[-1])
    steps = 2 * RATE_BATCHES
    if (summary["steps"], summary["epochs"], summary["bad_steps"]) != (steps, 2, 0):
        fail(f"observe: train summary {summary}")
    recs = read_jsonl(os.path.join(root, "run", "metrics_rank0.jsonl"))
    kinds = {"window": [r for r in recs if "loss" in r], "eval": [r for r in recs if
                                                                   "eval_auc" in r],
             "final": [r for r in recs if r.get("final")],
             "pipeline": [r for r in recs if r.get("kind") == "pipeline"]}
    if len(recs) != sum(len(v) for v in kinds.values()):
        fail(f"observe: {len(recs)} records, of which "
             f"{ {k: len(v) for k, v in kinds.items()} } of the expected kinds")
    for kind, want in OBS_KEYS.items():
        for r in kinds[kind]:
            if set(r) != want:
                fail(f"observe: a {kind} record's keys {sorted(set(r) ^ want)} differ from "
                     "the JAX trainer's")
    pkeys = OBS_STAMP | {"kind", "step", "wall_s", "batches", "rows", "queue_depth",
                         "queue_cap"} | {f"{s}_s" for s in (
        "read", "parse", "hash", "batch", "pad", "cache_read", "plan", "producer_wait",
        "queue_wait", "transfer", "dispatch", "device")}
    if not kinds["pipeline"] or any(set(r) != pkeys for r in kinds["pipeline"]):
        fail(f"observe: pipeline records {kinds['pipeline'][:1]}")
    wsteps = [r["step"] for r in kinds["window"]]
    if wsteps != list(range(1, steps + 1)) or len(kinds["final"]) != 1:
        fail(f"observe: window steps {wsteps}, {len(kinds['final'])} final records")
    if kinds["window"][-1]["loss"] != summary["last_loss"]:
        fail(f"observe: the last record's loss {kinds['window'][-1]['loss']} is not the "
             f"summary's {summary['last_loss']}")
    aucs = [r["eval_auc"] for r in kinds["eval"]]
    if len(aucs) != 2 or not all(a is not None and a > 0.5 for a in aucs):
        fail(f"observe: eval_auc records {aucs}: expected two above 0.5")
    with open(os.path.join(root, "pred_0_0.txt")) as f:
        n_pred = sum(1 for _ in f)
    if n_pred != OBS_TEST_ROWS:
        fail(f"observe: pred_0_0.txt holds {n_pred} rows, expected {OBS_TEST_ROWS}")
    beats = read_jsonl(os.path.join(root, "run", "heartbeat_rank0.jsonl"))
    events = [b.get("event") for b in beats]
    if (events[0] != "start" or events[-1] != "final" or events.count("eval") != 2
            or events.count(None) < steps):
        fail(f"observe: heartbeat events {events}")
    if "hang watchdog" in err:
        fail("observe: the hang watchdog dumped the stacks")
    want = {"gather_sorted": steps + 2 * 2 + 2, "row_sums": steps + 2 * 2 + 2,
            "scatter_ftrl": steps, "scatter_sorted": 0, "gather_sorted_multi": 0,
            "scatter_sorted_multi": 0}
    if launches != want:
        fail(f"observe: launches {launches}, expected {want}")
    traced = trace_kernels(os.path.join(root, "prof"))
    if not all(traced.values()):
        fail(f"observe: the trace window holds no {[k for k, v in traced.items() if not v]}")
    print(f"# observe: train 2 epochs x {RATE_BATCHES} steps, every flag on, on {card}: "
          f"{wall:.1f} s wall, {summary['examples_per_sec']} examples/s; auc {aucs} then "
          f"{summary['auc']}; window split (median / mean) {window_split(recs)}", flush=True)
    prs = kinds["pipeline"]
    pwall = sum(r["wall_s"] for r in prs)
    stages = {k[:-2]: sum(r[k] for r in prs) for k in prs[0]
              if k.endswith("_s") and k != "wall_s"}
    # a window's shares, then their median: robust to the few windows
    # that hold the first step, the trace's start and stop or an eval
    shares = {k: float(np.median([r[f"{k}_s"] / r["wall_s"] for r in prs])) for k in stages}
    print(f"# observe: pipeline stages over all {len(prs)} windows ({pwall:.2f} s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items() if v) + f"; verdict: "
        f"{pipeline_verdict(stages, pwall)}; median shares of a window's wall: " + ", ".join(
        f"{k} {v:.1%}" for k, v in shares.items() if v) + f"; verdict on them: "
        f"{pipeline_verdict(shares, 1.0)}", flush=True)
    # the same trace window over the uniform rate shard, for #1-#3's
    # uniform times by the same clock
    os.symlink(rate_path, os.path.join(root, "uniform-00000"))
    port_cli(root, *obs_train_argv(
        1, "--set", "train.log_every=0", "--set", "train.profile_dir=uprof",
        "--set", f"train.trace_start_step={OBS_TRACE_START}",
        "--set", f"train.trace_num_steps={OBS_TRACE_STEPS}", prefix="uniform"))
    uniform = trace_kernels(os.path.join(root, "uprof"))
    zipf = {}
    for k, durs in traced.items():
        ms, ums = float(np.mean(durs)) / 1e3, float(np.mean(uniform[k])) / 1e3
        zipf[k] = {"trace_ms": round(ms, 4), "uniform_trace_ms": round(ums, 4),
                   "launches": launches[k]}
        print(f"# observe: {k} on Zipf batches (trace, {len(durs)} launches in steps "
              f"{OBS_TRACE_START}-{OBS_TRACE_START + OBS_TRACE_STEPS - 1}): {ms:.4f} ms; on "
              f"the uniform rate shard by the same trace {ums:.4f} ms ({len(uniform[k])} "
              f"launches)", flush=True)

    # (3) 1 epoch, guard off; then guard and observability off
    for what, run in (("guard off, observability on", "run_noguard"),
                      ("guard off, observability off", "")):
        extra = obs_flags(run) if run else ["--set", "train.log_every=0"]
        out, _, rl = port_cli(root, *obs_train_argv(1, "--set", "train.nonfinite_guard=off",
                                                    *extra))
        s = json.loads(out.strip().splitlines()[-1])
        if s["steps"] != RATE_BATCHES or rl["scatter_ftrl"] != RATE_BATCHES:
            fail(f"observe: {what}: summary {s}, launches {rl}")
        split = (window_split(read_jsonl(os.path.join(root, run, "metrics_rank0.jsonl")))
                 if run else "no records")
        print(f"# observe: train 1 epoch, {what}: {s['examples_per_sec']} examples/s; "
              f"window split (median / mean) {split}", flush=True)
    print(f"# observe phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {**zipf, **scatters}


# ------------------------------------------------------------ phase 18

MESH_STEPS = 2  # steps of each mesh engine held against the single-device step
MESH_LOSS_RTOL, MESH_RTOL, MESH_ATOL = 2e-5, 2e-4, 1e-6  # tests/test_sorted_fullshard.py
MESH_KERNELS = ("gather_sorted", "row_sums", "scatter_sorted", "gather_sorted_multi",
                "scatter_sorted_multi")


def seeded_state(name: str, K: int, scale: float, seed: int) -> tuple:
    """({name: table}, {name: {n, z}}) on the card from a seeded CUDA
    generator: the table ~ N(0, scale²), FTRL n and z on the lower half
    of the slots (the upper half never touched), as `write_state`."""
    import torch

    S = 1 << LOG2_SLOTS
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.randn((S, K), generator=g, device=DEVICE) * scale
    n = torch.randn((S, K), generator=g, device=DEVICE).abs() * 0.1
    z = torch.randn((S, K), generator=g, device=DEVICE) * 1e-4
    n[S // 2:] = 0.0
    z[S // 2:] = 0.0
    return {name: t}, {name: {"n": n, "z": z}}


def mesh_state_close(got, want, what: str) -> float:
    """Every table and FTRL leaf of `got` within MESH_RTOL x |want| +
    MESH_ATOL of `want`; returns the largest absolute difference."""
    err = 0.0
    for name in want.tables:
        pairs = [("table", got.tables[name], want.tables[name])] + [
            (leaf, got.opt_state[name][leaf], want.opt_state[name][leaf])
            for leaf in want.opt_state[name]]
        for leaf, a, b in pairs:
            d = (a - b).abs()
            if not bool((d <= MESH_ATOL + MESH_RTOL * b.abs()).all()):
                fail(f"{what}: {name} {leaf} differs from the single-device step: max abs "
                     f"{d.max().item()}")
            err = max(err, d.max().item())
    return err


def single_steps(cfg, tables, opt, batches, arrays_of) -> tuple:
    """The port's single-device two-pass step over `batches` on the card
    from (tables, opt): (losses, final state)."""
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.state import TrainState
    from xflow_tpu_torch.train.step import make_train_step

    step = make_train_step(get_model(cfg.model.name)(cfg), get_optimizer("ftrl"), cfg)
    state = TrainState(tables, opt, 0)
    losses = []
    for b in batches:
        state, m = step(state, to_device(arrays_of(b), DEVICE))
        losses.append(float(m["loss"]))
    return losses, state


def mesh_steps(step, tables, opt, batches, arrays_of, what: str, want_losses, want) -> dict:
    """`step` over `batches` from (tables, opt), the launch counts set to 0
    just before and read just after; each loss within MESH_LOSS_RTOL and
    the state within MESH_RTOL / MESH_ATOL of the single-device run.
    Returns {launches, max_abs_err, ms} (ms: the mean step, CUDA events)."""
    import torch

    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.train.state import TrainState

    hosts = [arrays_of(b) for b in batches]
    state = TrainState(tables, opt, 0)
    losses = []
    torch.cuda.synchronize()
    st.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for h in hosts:
        state, m = step(state, to_device(h, DEVICE))
        losses.append(float(m["loss"]))
    end.record()
    torch.cuda.synchronize()
    launches = dict(st.LAUNCHES)
    for got, ref in zip(losses, want_losses):
        if not abs(got - ref) <= MESH_LOSS_RTOL * abs(ref):
            fail(f"{what}: losses {losses} against the single-device step's {want_losses}")
    err = mesh_state_close(state, want, what)
    ms = start.elapsed_time(end) / len(hosts)
    print(f"# {what}: {len(hosts)} step(s), losses {losses} (single device {want_losses}), "
          f"state max abs err {err:.3e}, {ms:.2f} ms a step with the transfer; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return {"launches": launches, "max_abs_err": err, "ms": ms}


def clone_state(tables, opt) -> tuple:
    return ({n: t.clone() for n, t in tables.items()},
            {n: {k: v.clone() for k, v in s.items()} for n, s in opt.items()})


def check_fs_layout(cfg, mesh, batch, tables) -> dict:
    """#5 and #6 against their plain versions at the fully-sharded buffer
    layout with `cap`'s pads (the one 1 x 1 buffer of a 65,536-row FM
    batch: its real occurrences, then pads at slot S-1 with mask 0), bit
    exact / bitwise, and their times on it; for #6 also `zeros` +
    `index_add_` on the same inputs and its bytes bound."""
    import numpy as np
    import torch

    from xflow_tpu_torch.models.fm import stack_channels
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.parallel.sorted_fullshard import fullshard_arrays

    host = fullshard_arrays(batch, cfg, mesh, False)
    if host["fs_row"].dtype != np.uint16 or host["fs_mask"].dtype != np.uint8:
        fail(f"the fully-sharded wire form is {host['fs_row'].dtype} rows, "
             f"{host['fs_mask'].dtype} mask: expected uint16 and uint8 across the collective")
    ss_cpu = torch.from_numpy(np.ascontiguousarray(host["fs_slots"].reshape(-1)))
    off_cpu = torch.from_numpy(np.ascontiguousarray(host["fs_off"]))
    m_np = host["fs_mask"].reshape(-1).astype(np.float32)
    ss, off = ss_cpu.to(DEVICE), off_cpu.to(DEVICE)
    table = tables["wv"]
    S, K = table.shape
    got = st.gather_sorted_multi_cuda(table, ss, off)
    want = st.gather_sorted_multi_plain(table.cpu(), ss_cpu, off_cpu)
    if not torch.equal(got.cpu(), want):
        fail("gather_sorted_multi at the fully-sharded layout differs from its plain version")
    rng = np.random.default_rng(SEED + 13)
    d_np = rng.standard_normal((st._k8(K), ss_cpu.numel()), dtype=np.float32)
    d_np[:K] *= m_np[None, :]
    d_cpu = torch.from_numpy(d_np)
    d = d_cpu.to(DEVICE)
    got = st.scatter_sorted_multi_cuda(d, ss, off, S, K)
    again = st.scatter_sorted_multi_cuda(d, ss, off, S, K)
    want = st.scatter_sorted_multi_plain(d_cpu, ss_cpu, off_cpu, S, K)
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    if not (torch.equal(got, again) and torch.equal(got.cpu(), want)):
        fail(f"scatter_sorted_multi at the fully-sharded layout is not bitwise its plain "
             f"version and itself: max abs err {err}")
    real = int(m_np.sum())
    np_, ss_l = int(ss_cpu.numel()), ss.long()
    out = {
        "fs_positions": np_, "fs_real": real, "fs_pads": np_ - real,
        "fs_gather_ms": cuda_ms(lambda: st.gather_sorted_multi_cuda(table, ss, off),
                                reps=5, warmup=1),
        "fs_scatter_ms": cuda_ms(lambda: st.scatter_sorted_multi_cuda(d, ss, off, S, K),
                                 reps=5, warmup=1),
        "fs_library_ms": cuda_ms(
            lambda: torch.zeros((S, K), device=DEVICE).index_add_(0, ss_l, d[:K].T),
            reps=5, warmup=1),
        "fs_bound_ms": bound_ms(S * K * 4 + K * np_ * 4 + np_ * 4 + off.numel() * 4,
                                K * np_)[0],
        "fs_max_abs_err": err,
    }
    # #2 on the buffer's FM channels (its real occurrences' rows, then the
    # pads at row 0 with mask 0), as the fully-sharded forward runs it
    occ = st.gather_sorted_multi_cuda(table, ss, off)
    fs_rows = st.wire_rows(torch.from_numpy(np.ascontiguousarray(host["fs_row"].reshape(-1))))
    m = torch.from_numpy(m_np).to(DEVICE)
    vals = stack_channels(occ[:K] * m[None, :], K).contiguous()
    out["fs_row_sums"] = check_row_sums(vals, fs_rows.to(DEVICE),
                                        "on the fully-sharded buffer's FM channels")
    del occ, vals
    print(f"# #5/#6 at the fully-sharded layout ({out['fs_positions']} positions: "
          f"{real} real, {out['fs_pads']} pads at slot {S - 1}): bit-exact / bitwise; "
          f"gather {out['fs_gather_ms']:.4f} ms, scatter {out['fs_scatter_ms']:.4f} ms "
          f"(zeros + index_add_ {out['fs_library_ms']:.4f} ms, bound "
          f"{out['fs_bound_ms']:.4f} ms)", flush=True)
    return out


def skewed(batch):
    """`batch` with every row's first 9 fields on slots HOT_SLOT..HOT_SLOT+8."""
    import numpy as np

    from xflow_tpu_torch.data.schema import SparseBatch

    slots = np.array(batch.slots)
    slots[:, :9] = HOT_SLOT + np.arange(9, dtype=np.int32)
    return SparseBatch(slots, batch.fields, batch.mask, batch.labels, batch.row_mask)


def run_mesh(cfg, work: str, path: str, rate_path: str, card: str) -> dict:
    """Phase 18: the multi-device engines as a world of one NCCL rank on a
    1 x 1 mesh (the card's machine holds one card, and NCCL puts no two
    ranks of a communicator on one device). Returns {name: {fullshard,
    replicated, fit launches}} and the #5/#6 layout figures."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.parallel import train_step as ts
    from xflow_tpu_torch.parallel.distributed import init_world, local_device, shutdown
    from xflow_tpu_torch.parallel.mesh import Mesh, make_mesh
    from xflow_tpu_torch.parallel.sorted_fullshard import (
        FullshardOverflowError,
        fullshard_arrays,
        make_fullshard_train_step,
        plan_fullshard_batch,
    )
    from xflow_tpu_torch.parallel.sorted_sharded import (
        make_sorted_sharded_train_step,
        sorted_arrays,
    )
    from xflow_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    try:
        local_device("cuda", 0, 2)
        fail("a world of 2 on one card did not raise")
    except RuntimeError as e:
        if "NCCL" not in str(e):
            fail(f"a world of 2 on one card raised without NCCL's reason: {e}")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dev = init_world(0, 1, "cuda", coordinator=f"127.0.0.1:{port}")
    if dist.get_backend() != "nccl":
        fail(f"the mesh on the card runs {dist.get_backend()}, not NCCL")
    try:
        mcfg = override(cfg, **{"mesh.data": 1, "mesh.table": 1,
                                "optim.fused_scatter": "off", "train.checkpoint_dir": ""})
        mesh = make_mesh(mcfg, device=dev)
        ftrl = get_optimizer("ftrl")
        it = batch_iterator(path, mcfg.data)
        batches = [next(it) for _ in range(MESH_STEPS)]
        it.close()
        out = {"launches": {}}
        # FM at full width: both engines against the single-device two-pass step
        tables, opt = seeded_state("wv", 1 + V_DIM, 0.05, SEED + 11)
        want_losses, want = single_steps(mcfg, *clone_state(tables, opt), batches,
                                         lambda b: batch_arrays(b, mcfg))
        fs = mesh_steps(make_fullshard_train_step(ftrl, mcfg, mesh), *clone_state(tables, opt),
                        batches, lambda b: fullshard_arrays(b, mcfg, mesh, False),
                        "FM fully-sharded engine, 1 x 1 NCCL mesh", want_losses, want)
        rcfg = override(mcfg, **{"data.sorted_mesh": "replicated"})
        rep = mesh_steps(make_sorted_sharded_train_step(ftrl, rcfg, mesh),
                         *clone_state(tables, opt), batches, lambda b: sorted_arrays(b, rcfg),
                         "FM replicated engine, 1 x 1 NCCL mesh", want_losses, want)
        for k in ("row_sums", "gather_sorted_multi", "scatter_sorted_multi"):
            if fs["launches"][k] < MESH_STEPS:
                fail(f"the fully-sharded steps launched {k} {fs['launches'][k]} times")
        for k in ("gather_sorted", "row_sums", "scatter_sorted"):
            if rep["launches"][k] < MESH_STEPS:
                fail(f"the replicated steps launched {k} {rep['launches'][k]} times")
        out.update(check_fs_layout(mcfg, mesh, batches[0], tables))
        # the overflow fallback: the planner refuses a hot batch at slack 2.0
        # (shown at a 1 x 8 split: one 1 x 1 block holds every occurrence
        # and can never overflow), and the row-major sharded step runs it
        hot = skewed(batches[0])
        try:
            plan_fullshard_batch(hot.slots, hot.mask, mcfg, Mesh(data=1, table=8))
            fail("the hot batch did not overflow the 1 x 8 buffers at slack 2.0")
        except FullshardOverflowError as e:
            print(f"# overflow at slack {mcfg.data.fullshard_slack}: {e}", flush=True)
        trainer = Trainer(mcfg, device=dev, mesh=mesh)
        if trainer._mesh_engine != "fullshard":
            fail(f"Trainer on the 1 x 1 mesh chose {trainer._mesh_engine!r}, not fullshard")
        hot_want_losses, hot_want = single_steps(mcfg, *clone_state(tables, opt), [hot],
                                                 lambda b: batch_arrays(b, mcfg))
        runs0 = ts.RUNS["row_major"]

        def fallback(b):
            host = ts.row_share({"slots": b.slots, "fields": b.fields, "mask": b.mask,
                                 "labels": b.labels, "row_mask": b.row_mask}, mesh)
            host["_fs_overflow"] = True
            return trainer._prepare(b, host)

        mesh_steps(trainer.train_step, *clone_state(tables, opt), [hot], fallback,
                   "FM overflow fallback (row-major sharded step)", hot_want_losses, hot_want)
        if ts.RUNS["row_major"] - runs0 != 1:
            fail(f"the fallback ran the row-major step {ts.RUNS['row_major'] - runs0} times")
        del trainer, tables, opt, want
        # MVM's segment side at full width, FFM at its smoke shape: one step each
        scfg = mvm_config(mcfg, "", **{"model.mvm_exclusive": "off"})
        tables, opt = seeded_state("v", V_DIM, MVM_V_SCALE, SEED + 12)
        wl, want = single_steps(scfg, *clone_state(tables, opt), batches[:1],
                                lambda b: batch_arrays(b, scfg))
        seg = mesh_steps(make_fullshard_train_step(ftrl, scfg, mesh), tables, opt,
                         batches[:1], lambda b: fullshard_arrays(b, scfg, mesh, True),
                         "MVM segment side, fully-sharded", wl, want)
        del tables, opt, want
        fcfg = ffm_config(mcfg, "")
        it = batch_iterator(path, fcfg.data)
        fbatch = next(it)
        it.close()
        tables, opt = seeded_state("wv", 1 + NUM_FIELDS * FFM_V_DIM, FFM_V_SCALE, SEED + 14)
        wl, want = single_steps(fcfg, *clone_state(tables, opt), [fbatch],
                                lambda b: batch_arrays(b, fcfg))
        ffm = mesh_steps(make_fullshard_train_step(ftrl, fcfg, mesh), tables, opt, [fbatch],
                         lambda b: fullshard_arrays(b, fcfg, mesh, True),
                         "FFM segment side, fully-sharded", wl, want)
        del tables, opt, want
        torch.cuda.empty_cache()
        # one epoch of the trainer on the mesh, beside the single-device two-pass epoch
        ecfg = override(mcfg, **{"data.train_path": rate_path[: -len("-00000")],
                                 "train.epochs": 1, "data.cache": "off"})
        eps = {}
        for what, mesh_arg in (("single device", None), ("1 x 1 mesh", mesh)):
            trainer = Trainer(ecfg, device=dev if mesh_arg is not None else DEVICE,
                              mesh=mesh_arg)
            torch.cuda.synchronize()
            st.reset_launches()
            res = trainer.fit()
            torch.cuda.synchronize()
            eps[what] = (res.examples_per_sec, res.seconds / max(res.steps, 1) * 1e3,
                         dict(st.LAUNCHES), res.steps)
            if res.steps != RATE_BATCHES or not np.isfinite(res.last_loss):
                fail(f"the {what} epoch ran {res.steps} steps, last loss {res.last_loss}")
            del trainer
        fit_launches = eps["1 x 1 mesh"][2]
        for k in ("row_sums", "gather_sorted_multi", "scatter_sorted_multi"):
            if fit_launches[k] != RATE_BATCHES:
                fail(f"the mesh epoch launched {k} {fit_launches[k]} times, not {RATE_BATCHES}")
        for what, (rate, step_ms, launches, steps) in eps.items():
            print(f"# FM epoch over the rate shard ({steps} x {BATCH} rows), {what}, two-pass: "
                  f"{rate:.1f} examples/s, {step_ms:.2f} ms a step (host clock), launches "
                  f"{ {k: v for k, v in launches.items() if v} } [{card}]", flush=True)
        out["signal"] = run_mesh_signal(ecfg, work, dev, mesh, card)
        out["epoch_examples_per_sec"] = eps["1 x 1 mesh"][0]
        out["epoch_step_ms"] = eps["1 x 1 mesh"][1]
        out["single_examples_per_sec"] = eps["single device"][0]
        out["single_step_ms"] = eps["single device"][1]
        for k in MESH_KERNELS:
            out["launches"][k] = {"fullshard": fs["launches"][k], "replicated":
                                  rep["launches"][k], "mvm_segment": seg["launches"][k],
                                  "ffm": ffm["launches"][k], "fit": fit_launches[k]}
        out["step_ms"] = {"fullshard": fs["ms"], "replicated": rep["ms"],
                          "mvm_segment": seg["ms"], "ffm": ffm["ms"]}
    finally:
        shutdown()
    print(f"# phase 18 (mesh) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ------------------------------------------------------------ phase 19
LAUNCH_SLICE_BATCHES = 6  # a slice's shard: 6 batches of the rate shard's rows
LAUNCH_EPOCHS = 2  # 12 steps a slice
LAUNCH_TRACE_START, LAUNCH_TRACE_STEPS = 5, 2
LAUNCH_TIMEOUT_S = 300  # a launch command's whole run
SYNC_SUM_RTOL = 1e-5  # normwise: float32 sums of the deltas in another order
# L2, a leaf: two card runs of 8-12 steps apart (on the H100 the max normwise
# error of z reached 6e-4, of w 0.11 at a lazy-init flip; PERF.md §6)
TRAJ_RTOL = 1e-3
# lazy-init flips a trajectory comparison may leave out of w (0-20 expected,
# 0 read on the card; PERF.md §6); more means a run lost updates
TRAJ_MAX_FLIPS = 32
ELASTIC_LOG2_SLOTS, ELASTIC_BATCH, ELASTIC_BATCHES = 18, 4096, 8  # a shard: 8 batches


def launch_env(extra: dict = None) -> dict:
    """The environment of a launch command: the checkout importable, no
    launcher or fault variables but `extra`."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def fm_args(prefix: str, ck: str, *extra: str, log2: int = 0, batch: int = 0,
            device: str = "", epochs: int = LAUNCH_EPOCHS) -> list:
    """`train` arguments of FM, at full width unless `log2` and `batch`
    say otherwise (fused FTRL on one device)."""
    log2, batch, device = log2 or LOG2_SLOTS, batch or BATCH, device or DEVICE
    return ["--train", prefix, "--model", "fm", "--epochs", str(epochs), "--batch-size",
            str(batch), "--log2-slots", str(log2), "--device", device, "--checkpoint-dir", ck,
            "--set", f"model.v_dim={V_DIM}", "--set", f"model.num_fields={NUM_FIELDS}",
            "--set", f"data.max_nnz={NUM_FIELDS}", "--set", "train.pred_dump=false",
            "--set", "data.cache=off", "--set", "train.log_every=1", *extra]


def split_rows(src: str, parts: list) -> list:
    """Write [(path, first row, rows)] from `src`'s lines; returns the paths."""
    with open(src) as f:
        lines = f.readlines()
    for path, lo, n in parts:
        with open(path, "w") as f:
            f.writelines(lines[lo:lo + n])
    return [p for p, _, _ in parts]


def proc_children(ppid: int) -> dict:
    """{pid: environ} of the live children of `ppid` (/proc)."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) != ppid:
                    continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
            out[int(pid)] = {k.decode(): v.decode() for k, v in env.items()}
        except (OSError, ValueError, IndexError):
            continue
    return out


def run_launcher(argv: list, cwd: str, log: str, env: dict, key: str = "XFLOW_SLICE") -> dict:
    """`python -m xflow_tpu_torch <argv>` with its output in `log`.out /
    .err, polled until it exits (a bounded wait: past LAUNCH_TIMEOUT_S it
    is killed and the phase fails). Its children are watched meanwhile:
    {"rc", "wall_s", "opened": {child's `key` value: [(gen, pid) that held
    /dev/nvidia* open]}, "seen": {...: [(gen, pid)]}}."""
    t0 = time.perf_counter()
    with open(log + ".out", "w") as fo, open(log + ".err", "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m", "xflow_tpu_torch", *argv], cwd=cwd,
                                env=env, stdout=fo, stderr=fe)
    seen, opened = {}, {}
    try:
        while proc.poll() is None:
            if time.perf_counter() - t0 > LAUNCH_TIMEOUT_S:
                fail(f"{argv[0]} ran past {LAUNCH_TIMEOUT_S} s: "
                     f"{open(log + '.err').read()[-3000:]}")
            for pid, cenv in proc_children(proc.pid).items():
                if key not in cenv:
                    continue
                tag = (int(cenv.get("XFLOW_RESTART_GEN", 0)), pid)
                j = int(cenv[key])
                if tag not in seen.setdefault(j, []):
                    seen[j].append(tag)
                if tag not in opened.get(j, []):
                    try:
                        if opens_the_card(pid):
                            opened.setdefault(j, []).append(tag)
                    except OSError:
                        pass  # exited meanwhile
            time.sleep(0.2)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    return {"rc": proc.returncode, "wall_s": time.perf_counter() - t0, "opened": opened,
            "seen": seen}


def sync_rounds(recs: list) -> list:
    """[(round, kind=sync record, its slice_sync span)] of one stream."""
    spans = {r["round"]: r for r in recs
             if r.get("kind") == "span" and r.get("name") == "slice_sync"}
    return [(r["round"], r, spans.get(r["round"])) for r in recs if r.get("kind") == "sync"]


def state_leaves(ck: str, step: int = None) -> tuple:
    """(wv, n, z) float32 CPU tensors and the step of a committed
    checkpoint (the newest when `step` is None)."""
    import numpy as np
    import torch

    from xflow_tpu_torch.train import checkpoint as ckpt

    step = ckpt.latest_step(ck) if step is None else step
    with np.load(os.path.join(ck, f"step_{step}", "state.npz")) as z:
        return tuple(torch.from_numpy(z[k]) for k in ("tables/wv", "opt/wv/n",
                                                       "opt/wv/z")), step


def check_delta_sum(cfg, run: str, j: int, recs: list, sums: dict) -> float:
    """Slice j's last checkpoint against the initial state plus every
    delta it folded in (its own rounds, and each peer's up to its last
    round less the lag its last record reports), summed on the host in
    float64 (`sums` keeps each set's sum: slices that folded the same
    rounds share it). Returns the largest normwise error (max |got -
    want| over max |want|, a leaf), which must be within SYNC_SUM_RTOL."""
    import numpy as np

    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.state import init_state

    rounds = sync_rounds(recs)
    last_round, last, _ = rounds[-1]
    upto = {j: last_round}
    upto.update({int(p): last_round - lag for p, lag in last["lags"].items()})
    key = tuple(sorted(upto.items()))
    if key not in sums:
        init = init_state(get_model("fm")(cfg), get_optimizer("ftrl"), cfg, "cpu")
        acc = {"tables/wv": init.tables["wv"].numpy().astype(np.float64),
               "opt/wv/n": init.opt_state["wv"]["n"].numpy().astype(np.float64),
               "opt/wv/z": init.opt_state["wv"]["z"].numpy().astype(np.float64)}
        del init
        sync_dir = os.path.join(run, "sync")
        n = 0
        for s, top in upto.items():
            for r in range(1, top + 1):
                if not os.path.exists(os.path.join(sync_dir, f"delta_s{s}_r{r}.ok")):
                    continue
                with np.load(os.path.join(sync_dir, f"delta_s{s}_r{r}.npz")) as z:
                    for k in acc:
                        acc[k] += z[k]
                n += 1
        sums.clear()  # one set held at a time: 3 x 369 MB of float64
        sums[key] = (acc, n)
    want, folded = sums[key]
    got, _ = state_leaves(os.path.join(run, f"ck{j}"))
    errs = {}
    for k, g in zip(want, got):
        w = want[k]
        errs[k] = float(np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30))
    if not max(errs.values()) <= SYNC_SUM_RTOL:
        fail(f"multislice: slice {j}'s last checkpoint is not the initial state plus the "
             f"{folded} deltas it folded in: normwise errors {errs}")
    print(f"# multislice: slice {j}'s last checkpoint = initial state + {folded} deltas "
          f"(rounds {upto}), normwise errors {errs}", flush=True)
    return max(errs.values())


def run_launch(cfg, work: str, rate_path: str, card: str) -> dict:
    """Phase 19, the launch layer on the card: (1) `launch-multislice
    --slices 2` of FM at full width, both slices on the card, bounded
    sync (K = 1, a round every 4 steps, a snapshot every 2 rounds) with a
    trace window in each, beside one slice alone with sync off; (2) the
    same launch with slice 1 killed entering round 2 and relaunched;
    (3) `launch-local --num-processes 1` killed after step 5 and
    restarted, against the uninterrupted run of (1); (4) a checkpoint a
    2-rank CPU world wrote, resumed on the card in a world of one,
    against the CPU's resume. Returns what the JSON line's `launch` key
    holds."""
    import shutil

    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.launch.watchdog import classify, read_heartbeats
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.train import checkpoint as ckpt
    from xflow_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    root = os.path.join(work, "launch")
    os.makedirs(root)
    out = {}
    free = shutil.disk_usage(root).free / 1e9
    shards = split_rows(rate_path, [
        (os.path.join(root, f"slice{j}-00000"), j * LAUNCH_SLICE_BATCHES * BATCH,
         LAUNCH_SLICE_BATCHES * BATCH) for j in range(2)])
    steps = LAUNCH_SLICE_BATCHES * LAUNCH_EPOCHS
    print(f"# launch phase: {len(shards)} slice shards of {LAUNCH_SLICE_BATCHES} x {BATCH} "
          f"rows; {free:.0f} GB free on the work dir's disk", flush=True)
    sync_flags = ["--set", "sync.mode=bounded", "--set", "sync.staleness_k=1",
                  "--set", "sync.every_steps=4", "--set", "sync.snapshot_every=2",
                  "--set", "sync.timeout_s=60", "--set", "sync.retries=0"]
    trace_flags = ["--set", f"train.trace_start_step={LAUNCH_TRACE_START}",
                   "--set", f"train.trace_num_steps={LAUNCH_TRACE_STEPS}"]

    # (1) two slices on the card, then one alone (no trace window in either:
    # its start would weigh on the rates; (2) traces the slices)
    ms = os.path.join(root, "ms")
    r = run_launcher(["launch-multislice", "--slices", "2", "--run-dir", ms, "--",
                      *fm_args(os.path.join(root, "slice{slice}"), os.path.join(ms, "ck{slice}"),
                               *sync_flags)],
                     root, os.path.join(root, "ms"), launch_env())
    if r["rc"] != 0:
        fail(f"launch-multislice exited {r['rc']}: {open(os.path.join(root, 'ms.err')).read()[-3000:]}")
    if sorted(r["opened"]) != [0, 1]:
        fail(f"multislice: slices that opened the card {r['opened']} (seen {r['seen']})")
    t_checks = time.perf_counter()
    rates, splits, sums = {}, [], {}
    for j in range(2):
        recs = read_jsonl(os.path.join(ms, f"metrics_rank{j}.jsonl"))
        rounds = sync_rounds(recs)
        if [x[0] for x in rounds] != [1, 2, 3, 4] or not all(x[2] for x in rounds):
            fail(f"multislice: slice {j}'s sync records and spans {[x[0] for x in rounds]}")
        (final,) = [x for x in recs if x.get("final")]
        if (final["steps"], final["examples"]) != (steps, steps * BATCH):
            fail(f"multislice: slice {j}'s final record {final}")
        rates[j] = final["examples"] / final["elapsed_s"]
        for rnd, rec, span in rounds:
            splits.append({"slice": j, "round": rnd, "dur_ms": span["dur_ms"],
                           "bytes_out": rec["bytes_out"], "bytes_in": rec["bytes_in"],
                           "applied": rec["applied"], "lag_max": rec["lag_max"],
                           "timeouts": rec["timeouts"], **span["split_ms"]})
            print(f"# multislice round: slice {j} round {rnd}: {span['dur_ms']:.1f} ms "
                  f"({span['split_ms']}), {rec['bytes_out'] / 1e6:.1f} MB out, "
                  f"{rec['bytes_in'] / 1e6:.1f} MB in, applied {rec['applied']}, lag "
                  f"{rec['lag_max']}, timeouts {rec['timeouts']} [{card}]", flush=True)
        check_delta_sum(cfg, ms, j, recs, sums)
    del sums
    print(f"# multislice: the streams and the delta sums checked in "
          f"{time.perf_counter() - t_checks:.1f} s", flush=True)
    solo_ck = os.path.join(root, "solo_ck")
    t0 = time.perf_counter()
    sout, _, solo_launches = port_cli(root, "train", *fm_args(
        shards[0][: -len("-00000")], solo_ck,
        "--set", f"train.metrics_path={os.path.join(root, 'solo.jsonl')}"))
    solo_wall = time.perf_counter() - t0
    (solo_final,) = [x for x in read_jsonl(os.path.join(root, "solo.jsonl")) if x.get("final")]
    solo_rate = solo_final["examples"] / solo_final["elapsed_s"]
    out["multislice"] = {
        "slices_opened_card": {str(j): v for j, v in r["opened"].items()},
        "examples_per_sec": {str(j): v for j, v in rates.items()},
        "solo_examples_per_sec": solo_rate, "wall_s": r["wall_s"], "solo_wall_s": solo_wall,
        "solo_launches": solo_launches,
        "rounds": splits,
    }
    print(f"# multislice on {card}: 2 slices x {steps} steps of {BATCH} rows, bounded K=1, a "
          f"round every 4 steps: {rates[0]:.1f} and {rates[1]:.1f} examples/s (final records: "
          f"the fit's time, 3 in-loop rounds in it), {r['wall_s']:.1f} s wall; one slice alone, "
          f"sync off: {solo_rate:.1f} examples/s, {solo_wall:.1f} s wall; its launches "
          f"{solo_launches}", flush=True)
    if any(solo_launches[k] != steps for k in ("gather_sorted", "row_sums", "scatter_ftrl")):
        fail(f"multislice: the solo slice launched {solo_launches}, not {steps} of #1-#3")
    # the single-device slices' delta members, for phase 20's mesh slices
    out["multislice"]["delta_layout"] = npz_layout(os.path.join(ms, "sync", "delta_s0_r1.npz"))
    shutil.rmtree(ms)

    # (2) slice 1 killed entering round 2, relaunched at gen 1; a trace
    # window over steps 5-6 of each slice's generation 0
    kill = os.path.join(root, "kill")
    r = run_launcher(["launch-multislice", "--slices", "2", "--run-dir", kill,
                      "--max-restarts", "1", "--restart-backoff", "0.5", "--",
                      *fm_args(os.path.join(root, "slice{slice}"),
                               os.path.join(kill, "ck{slice}"), *sync_flags, *trace_flags,
                               "--set", f"train.profile_dir={os.path.join(kill, 'prof{slice}')}",
                               "--set", "train.checkpoint_every=4")],
                     root, os.path.join(root, "kill"),
                     launch_env({"XFLOW_FAULT_SLICE_KILL_ROUND": "2", "XFLOW_FAULT_SLICE": "1"}))
    err = open(os.path.join(root, "kill.err")).read()
    if r["rc"] != 0:
        fail(f"multislice kill drill exited {r['rc']}: {err[-3000:]}")
    need = ("slice 1 left the sync group (exit rc=", "slice 1 rejoined the sync group "
            "(relaunch gen 1)", "multislice: slice 1 caught up from snapshot round ")
    missing = [n for n in need if n not in err]
    if missing:
        fail(f"multislice kill drill: stderr lacks {missing}: {err[-3000:]}")
    gens1 = sorted(g for g, _ in r["seen"].get(1, []))
    if gens1 != [0, 1] or sorted(g for g, _ in r["opened"].get(1, [])) != [0, 1]:
        fail(f"multislice kill drill: slice 1's processes {r['seen']}, on the card {r['opened']}")
    recs0 = read_jsonl(os.path.join(kill, "metrics_rank0.jsonl"))
    (final0,) = [x for x in recs0 if x.get("final")]
    if final0["steps"] != steps:
        fail(f"multislice kill drill: slice 0's final record {final0}")
    # the launcher's membership writes, in order (slice 0's rounds, seconds
    # apart, may fall on either side of the short gap)
    trail = [ln.split("launch-multislice: ", 1)[1] for ln in err.splitlines()
             if ln.startswith("launch-multislice: slice ")]
    traced = {}
    for j in range(2):
        tk = trace_kernels(os.path.join(kill, f"prof{j}"))
        if not all(tk.values()):
            fail(f"multislice: slice {j}'s trace names no {[k for k, v in tk.items() if not v]}")
        traced[str(j)] = {k: len(v) for k, v in tk.items()}
    recs1 = read_jsonl(os.path.join(kill, "metrics_rank1.jsonl"))
    (final1,) = [x for x in recs1 if x.get("final")]
    if final1.get("gen") != 1 or ckpt.latest_step(os.path.join(kill, "ck1")) != steps:
        fail(f"multislice kill drill: slice 1's final record {final1}")
    adopt = [ln for ln in err.splitlines() if "caught up from snapshot" in ln]
    out["kill_drill"] = {"rc": r["rc"], "wall_s": r["wall_s"], "slice1_gens": gens1,
                         "membership": trail, "adopted": adopt}
    out["multislice"]["trace_launches"] = traced
    slice0_waits = [round(sp["split_ms"]["wait"], 1) for _, _, sp in sync_rounds(recs0)]
    print(f"# multislice kill drill on {card}: slice 1 killed entering round 2 and relaunched "
          f"(gen 1): {adopt}; membership {trail}; slice 0 finished {final0['steps']} steps, "
          f"its rounds' waits {slice0_waits} ms; both slices' traces (steps "
          f"{LAUNCH_TRACE_START}-{LAUNCH_TRACE_START + LAUNCH_TRACE_STEPS - 1}) name #1-#3: "
          f"{traced}; {r['wall_s']:.1f} s wall", flush=True)
    shutil.rmtree(kill)

    # (3) supervised launch-local, killed after step 5, against (1)'s solo run
    ll = os.path.join(root, "ll")
    r = run_launcher(["launch-local", "--num-processes", "1", "--max-restarts", "1",
                      "--restart-backoff", "0.5", "--run-dir", ll, "--",
                      *fm_args(shards[0][: -len("-00000")], os.path.join(ll, "ck"),
                               "--set", "train.checkpoint_every=4",
                               "--set", "train.heartbeat_every=1")],
                     root, os.path.join(root, "ll"), launch_env({"XFLOW_FAULT_KILL_STEP": "5"}),
                     key="XFLOW_PROCESS_ID")
    err = open(os.path.join(root, "ll.err")).read()
    if r["rc"] != 0 or "hard-killing rank 0 at step 5" not in err \
            or "resumed from step 4" not in err:
        fail(f"launch-local drill exited {r['rc']}: {err[-3000:]}")
    if sorted(g for g, _ in r["opened"].get(0, [])) != [0, 1]:
        fail(f"launch-local drill: ranks on the card {r['opened']} (seen {r['seen']})")
    beats = {g: read_heartbeats(ll, gen=g) for g in (0, 1)}
    rows = {g: classify(b, max(x["ts"] for x in b.values())) for g, b in beats.items()}
    if beats[0][0]["step"] != 5 or beats[0][0]["event"] is not None \
            or beats[1][0]["event"] != "final" or beats[1][0]["step"] != steps - 4:
        fail(f"launch-local drill: heartbeats {beats}")
    wd_events = (read_jsonl(os.path.join(ll, "watchdog.jsonl"))
                 if os.path.exists(os.path.join(ll, "watchdog.jsonl")) else [])
    hb = read_jsonl(os.path.join(ll, "heartbeat_rank0.jsonl"))
    t_kill = max(x["ts"] for x in hb if x["gen"] == 0)
    t_back = min(x["ts"] for x in hb if x["gen"] == 1)
    ds = ckpt.read_data_state(os.path.join(ll, "ck"), steps)
    if ds is None or ds["examples"] != steps * BATCH or not ds["completed"]:
        fail(f"launch-local drill: data_state {ds}")
    (got, gstep), (want, _) = state_leaves(os.path.join(ll, "ck")), state_leaves(solo_ck)
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.train.state import init_state

    st0 = init_state(get_model("fm")(cfg), get_optimizer("ftrl"), cfg, "cpu")
    prev = (st0.tables["wv"], st0.opt_state["wv"]["n"], st0.opt_state["wv"]["z"])
    errs = trajectory_errs(got, want, prev, cfg.optim.ftrl,
                           "launch-local resumed vs uninterrupted", bitwise=True)
    del st0, prev, got, want
    out["supervised"] = {"wall_s": r["wall_s"], "solo_wall_s": solo_wall,
                         "kill_to_restart_s": t_back - t_kill, "ftrl_errs": errs,
                         "watchdog_events": len(wd_events),
                         "gen_rows": {str(g): v for g, v in rows.items()}}
    print(f"# launch-local drill on {card}: killed after step 5 (last gen-0 beat), gen 1's "
          f"first beat {t_back - t_kill:.1f} s later, resumed from step 4; {r['wall_s']:.1f} s "
          f"wall against the uninterrupted run's {solo_wall:.1f} s (lost "
          f"{r['wall_s'] - solo_wall:.1f} s); step {gstep}, examples {ds['examples']}; "
          f"state vs the uninterrupted run {errs}; watchdog events {wd_events}; per "
          f"generation {rows}", flush=True)
    shutil.rmtree(ll)

    # (4) a 2-rank CPU world's checkpoint, resumed on the card in a world of one
    el = os.path.join(root, "elastic")
    os.makedirs(el)
    rows_per = ELASTIC_BATCHES * ELASTIC_BATCH
    eshards = split_rows(rate_path, [(os.path.join(el, f"e-0000{j}"), j * rows_per, rows_per)
                                     for j in range(2)])
    eprefix = eshards[0][: -len("-00000")]
    eck = os.path.join(el, "ck")
    r = run_launcher(["launch-local", "--num-processes", "2", "--",
                      *fm_args(eprefix, eck, "--set", "train.checkpoint_every=3",
                               log2=ELASTIC_LOG2_SLOTS, batch=ELASTIC_BATCH, device="cpu",
                               epochs=1)],
                     el, os.path.join(el, "cpu"), launch_env({"XFLOW_FAULT_KILL_STEP": "3"}),
                     key="XFLOW_PROCESS_ID")
    if r["rc"] == 0 or ckpt.committed_steps(eck) != [3]:
        fail(f"elastic: the CPU world exited {r['rc']} with steps {ckpt.committed_steps(eck)}: "
             f"{open(os.path.join(el, 'cpu.err')).read()[-3000:]}")
    ds = ckpt.read_data_state(eck, 3)
    if (ds["num_shards"], ds["world_size"], ds["shard_batches"]) != (2, 2, {"0": 3, "1": 3}):
        fail(f"elastic: the CPU world's data_state {ds}")
    shutil.copytree(eck, eck + "_cpu")
    ecfg = override(cfg, **{"data.log2_slots": ELASTIC_LOG2_SLOTS,
                            "data.batch_size": ELASTIC_BATCH, "data.train_path": eprefix,
                            "train.epochs": 1, "train.checkpoint_dir": eck,
                            "train.log_every": 0, "train.pred_dump": False})
    prev, _ = state_leaves(eck, 3)
    res = {}
    for dev, ck in ((DEVICE, eck), ("cpu", eck + "_cpu")):
        trainer = Trainer(override(ecfg, **{"train.checkpoint_dir": ck}), device=dev)
        t0 = time.perf_counter()
        if not trainer.maybe_restore() or trainer.state.step != 3:
            fail(f"elastic: the {dev} resume restored step {trainer.state.step}")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        st.reset_launches()
        t0 = time.perf_counter()
        fit = trainer.fit()
        torch.cuda.synchronize()
        res[ck] = (fit, t_restore, time.perf_counter() - t0, dict(st.LAUNCHES))
        del trainer
    fit, t_restore, t_fit, elaunches = res[eck]
    want_ex = 2 * rows_per - 3 * 2 * ELASTIC_BATCH
    if (fit.steps, fit.examples) != (2 * (ELASTIC_BATCHES - 3), want_ex):
        fail(f"elastic: the card's resume ran {fit.steps} steps, {fit.examples} examples; "
             f"expected {2 * (ELASTIC_BATCHES - 3)}, {want_ex}")
    if res[eck + "_cpu"][0].examples != want_ex:
        fail(f"elastic: the CPU resume trained {res[eck + '_cpu'][0].examples} examples")
    for k in ("gather_sorted", "row_sums", "scatter_ftrl"):
        if elaunches[k] != fit.steps:
            fail(f"elastic: the card's resume launched {k} {elaunches[k]} times, not {fit.steps}")
    (got, _), (want, _) = state_leaves(eck), state_leaves(eck + "_cpu")
    eerrs = trajectory_errs(tuple(t.to(DEVICE) for t in got), want, prev, cfg.optim.ftrl,
                            "elastic resume, card vs CPU")
    out["elastic"] = {"restore_s": t_restore, "fit_s": t_fit, "steps": fit.steps,
                      "examples": fit.examples, "launches": elaunches, "ftrl_errs": eerrs,
                      "cpu_world_wall_s": r["wall_s"]}
    print(f"# elastic on {card}: a 2-rank CPU world's step-3 checkpoint (wv [2^"
          f"{ELASTIC_LOG2_SLOTS}, {1 + V_DIM}], 2 shards) resumed in a world of one: restore "
          f"{t_restore:.3f} s, {fit.steps} steps / {fit.examples} examples in {t_fit:.2f} s, "
          f"launches {elaunches}; vs the CPU resume {eerrs}", flush=True)
    shutil.rmtree(el)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"# phase 19 (launch) took {out['phase_s']:.1f} s", flush=True)
    return out



def run_mesh_signal(ecfg, work: str, dev, mesh, card: str) -> dict:
    """Phase 18's signal leg: the fully-sharded `Trainer.fit` on the
    one-rank NCCL mesh with `train.signal_sync_every=2`, a SIGTERM to
    this process once step 3 is counted (its heartbeat): the
    all_reduce(MAX) of the pending signal at step 4 (a CUDA tensor on
    NCCL) stops the run there, and the collective save commits step 4.
    Returns the leg's launches of #2, #5 and #6."""
    import signal

    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.train import checkpoint as ckpt
    from xflow_tpu_torch.train.trainer import Trainer

    ck = os.path.join(work, "mesh_signal_ck")
    scfg = override(ecfg, **{"train.checkpoint_dir": ck, "train.ckpt_on_signal": True,
                             "train.signal_sync_every": 2, "train.heartbeat_every": 1,
                             "train.heartbeat_path": os.path.join(work, "mesh_signal_hb.jsonl")})
    trainer = Trainer(scfg, device=dev, mesh=mesh)
    beat = trainer.heartbeat.append

    def append(rec):
        beat(rec)
        if rec.get("step") == 3 and "event" not in rec:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.heartbeat.append = append
    torch.cuda.synchronize()
    st.reset_launches()
    t0 = time.perf_counter()
    res = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: st.LAUNCHES[k] for k in ("row_sums", "gather_sorted_multi",
                                            "scatter_sorted_multi")}
    if (res.steps, res.interrupted) != (4, int(signal.SIGTERM)):
        fail(f"the mesh signal leg stopped at step {res.steps}, interrupted {res.interrupted}: "
             "expected step 4 and SIGTERM")
    if ckpt.committed_steps(ck) != [4]:
        fail(f"the mesh signal leg committed steps {ckpt.committed_steps(ck)}, not [4]")
    if any(v != 4 for v in launches.values()):
        fail(f"the mesh signal leg launched {launches}, not 4 of each")
    print(f"# mesh signal leg on {card}: SIGTERM after step 3, stopped at step {res.steps} "
          f"(signal_sync_every=2, the all_reduce on {mesh.device}), step 4 committed, "
          f"{wall:.1f} s with the save; launches {launches}", flush=True)
    return {"steps": res.steps, "interrupted": res.interrupted, "launches": launches}


# ------------------------------------------------------------ phase 20
WORLD_SERVE_SECONDS, WORLD_SWAP_AT = 6.0, 2.0  # the serve world's closed loop
WORLD_CHECK_ROWS = 256  # rows the serve world answers against the solo runner
CAPI_TRACE_START = 2  # the C client's trace window: step 2 of 2
CAPI_ROWS = ("0:f0x 1:f1y 2:f2z", "1\t3:abc 7:q 12:r", "4:s 5:t 6:u 17:v")
MESH_SYNC_BATCHES = 4  # a mesh slice's shard: 4 steps, one round (the final)
# the legs' budgets (s) and the whole smoke's prediction, written before the run
PHASE20_BUDGET_S = {"serve_world": 45.0, "c_api": 60.0, "mesh_sync": 45.0}
SMOKE_PREDICTED_S = (850.0, 1000.0)


def free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def npz_layout(path: str) -> dict:
    """{member: (dtype, shape)} of an npz, read from the .npy headers."""
    import zipfile

    from numpy.lib import format as npf

    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                major, _ = npf.read_magic(f)
                read = npf.read_array_header_1_0 if major == 1 else npf.read_array_header_2_0
                shape, _, dtype = read(f)
            out[name[:-len(".npy")]] = (dtype.str, list(shape))
    return out


def post_rows(port: int, rows: list, chunk: int) -> list:
    """[(pctrs, generation, step)] of `rows` posted in requests of `chunk`."""
    import http.client

    out = []
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for lo in range(0, len(rows), chunk):
            conn.request("POST", "/predict", json.dumps({"rows": rows[lo:lo + chunk]}))
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            if resp.status != 200:
                fail(f"serve world: status {resp.status}: {payload}")
            out.append((payload["pctr"], payload["generation"], payload["step"]))
    finally:
        conn.close()
    return out


def run_serve_world(cfg, work: str, path: str, card: str, bare: dict) -> dict:
    """Phase 20 (a): `serve` as a world of one NCCL rank (`serve_main`
    with a 1 x 1 mesh, in process: the tables on the rank's block, every
    batch through the control header and `make_sharded_eval_step`) over
    phase 14's FM states. 256 rows against the solo `ServeRunner` on
    steps 1 and 2 (within PCTR_ATOL), serve_bench's closed loop (a
    subprocess) with step 2 committed 2 s in: 0 failed, the world swapped
    to generation 2, and no kernel launched (row-major). SIGTERM to this
    process drains the world (rc 0)."""
    import signal
    import threading

    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.parallel.distributed import init_world, shutdown
    from xflow_tpu_torch.parallel.mesh import make_mesh
    from xflow_tpu_torch.serve.runner import ServeRunner
    from xflow_tpu_torch.serve.server import serve_main

    t_leg = time.perf_counter()
    src, serving = os.path.join(work, "ck_serve_src"), os.path.join(work, "ck_world")
    commit_step(stage_step(src, serving, 1, link=True), 1)
    staged = stage_step(src, serving, 2, link=True)
    with open(path) as f:
        rows = [next(f).split("\t", 1)[1].strip() for _ in range(WORLD_CHECK_ROWS)]
    scfg = override(cfg, **{"train.checkpoint_dir": serving, "serve.port": 0,
                            "serve.max_batch": SERVE_MAX_BATCH, "serve.window_ms": 2.0,
                            "serve.reload_poll_s": 0.5, "mesh.data": 1, "mesh.table": 1,
                            "serve.metrics_path": os.path.join(work, "world.jsonl")})
    want = {}
    for step in (1, 2):
        solo = ServeRunner(override(scfg, **{"train.checkpoint_dir": src}), device=DEVICE)
        solo.load(step=step)
        want[step] = solo.predict_rows(rows)[0]
        del solo
    dev = init_world(0, 1, DEVICE, coordinator=f"127.0.0.1:{free_port()}")
    got: dict = {}
    try:
        if DEVICE == "cuda" and dist.get_backend() != "nccl":
            fail(f"the serve world on the card runs {dist.get_backend()}, not NCCL")
        mesh = make_mesh(scfg, device=dev)
        rfd, wfd = os.pipe()

        def drive():
            try:
                with os.fdopen(rfd) as r:
                    got["ready"] = json.loads(r.readline())
                port = got["ready"]["port"]
                got["before"] = post_rows(port, rows, 64)
                timer = threading.Timer(WORLD_SWAP_AT, commit_step, (staged, 2))
                timer.start()
                t0 = time.perf_counter()
                b = subprocess.run(
                    [sys.executable, "-m", "xflow_tpu_torch.tools.serve_bench", "--url",
                     f"http://127.0.0.1:{port}", "--duration", str(WORLD_SERVE_SECONDS),
                     "--concurrency", str(SERVE_CONNECTIONS), "--data", path,
                     "--rows-per-request", "1-8"],
                    cwd=HERE, capture_output=True, text=True, timeout=120,
                    env={**os.environ, "PYTHONPATH": HERE})
                timer.join()
                got["loop_s"] = time.perf_counter() - t0
                got["bench"] = json.loads(b.stdout.strip().splitlines()[-1])
                got["after"] = post_rows(port, rows, 64)
            except BaseException as e:  # noqa: BLE001 — reported after the drain
                got["error"] = f"{type(e).__name__}: {e}"
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        th = threading.Thread(target=drive, daemon=True)
        st.reset_launches()
        th.start()
        with os.fdopen(wfd, "w") as ready_out:
            rc = serve_main(scfg, device=dev, ready_out=ready_out, mesh=mesh)
        th.join(timeout=60)
        launches = dict(st.LAUNCHES)
    finally:
        shutdown()
    if "error" in got:
        fail(f"serve world: {got['error']}")
    if rc != 0 or got["ready"].get("world") != 1:
        fail(f"serve world: rc {rc}, ready {got.get('ready')}")
    if any(launches.values()):
        fail(f"serve world launched {launches}: serving is row-major")
    rep = got["bench"]
    if rep["errors"]:
        fail(f"serve world: {rep['errors']} failed requests across the reload "
             f"({rep.get('first_error')})")
    errs = {}
    for key, step, gen in (("before", 1, 1), ("after", 2, 2)):
        answers = got[key]
        if {(g, s) for _, g, s in answers} != {(gen, step)}:
            fail(f"serve world {key} the reload: answers from {set((g, s) for _, g, s in answers)}"
                 f", not generation {gen} at step {step}")
        p = [x for a, _, _ in answers for x in a]
        errs[key] = float(max(abs(a - b) for a, b in zip(p, want[step])))
        if errs[key] > PCTR_ATOL:
            fail(f"serve world {key} the reload: pCTRs {errs[key]} from the solo runner's")
    leg_s = time.perf_counter() - t_leg
    out = {"requests_per_s": rep["value"], "rows_per_s": rep["rows_per_s"],
           "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"], "requests": rep["requests"],
           "failed": rep["errors"], "max_abs_err": errs, "leg_s": leg_s,
           "bare": {k: bare[k] for k in ("value", "rows_per_s", "p50_ms", "p99_ms")}}
    print(f"# serve world on {card}: a world of 1 NCCL rank, 1 x 1 mesh, rung "
          f"{SERVE_MAX_BATCH}: {rep['value']} requests/s, {rep['rows_per_s']} rows/s, p50 "
          f"{rep['p50_ms']} / p99 {rep['p99_ms']} ms over {WORLD_SERVE_SECONDS:.0f} s, "
          f"{rep['requests']} requests, 0 failed, step 2 swapped in {WORLD_SWAP_AT:.0f} s in; the "
          f"bare server (phase 15, {FLEET_SECONDS:.0f} s): {bare['value']} requests/s, p50 "
          f"{bare['p50_ms']} / p99 {bare['p99_ms']} ms; pCTRs vs the solo runner {errs}; "
          f"launches 0; {leg_s:.1f} s (budget {PHASE20_BUDGET_S['serve_world']:.0f} s)",
          flush=True)
    return out


CAPI_CLIENT = r"""
#include <stdio.h>
#include "xflow_c_api.h"

/* argv: shard_prefix checkpoint_dir profile_dir device then key value pairs */
int main(int argc, char** argv) {
  void* h = 0;
  if (XFCreate(&h, argv[1], argv[1]) != 0) return 2;
  if (XFSetConfig(h, "device", argv[4]) != 0) return 3;
  if (XFSetConfig(h, "train.checkpoint_dir", argv[2]) != 0) return 3;
  if (XFSetConfig(h, "train.profile_dir", argv[3]) != 0) return 3;
  for (int i = 5; i + 1 < argc; i += 2)
    if (XFSetConfig(h, argv[i], argv[i + 1]) != 0) return 3;
  double pre[1];
  if (XFPredict(h, "0:a 1:b", pre, 1) != -1) return 6;
  if (XFStartTrain(h) != 0) return 4;
  printf("AUC=%.9f\n", XFGetAUC(h));
  if (XFLoadCheckpoint(h, argv[2]) != 0) return 7;
  double p[3];
  int n = XFPredict(h, "0:f0x 1:f1y 2:f2z\n1\t3:abc 7:q 12:r\n4:s 5:t 6:u 17:v", p, 3);
  if (n != 3) return 8;
  for (int i = 0; i < n; ++i) printf("PCTR=%.9f\n", p[i]);
  if (XFPredict(h, "no-colon-tokens", p, 3) != -1) return 10;
  XFDestroy(h);
  return 0;
}
"""


def run_c_api(cfg, work: str, path: str, card: str) -> dict:
    """Phase 20 (b): gcc builds the port's shim (`xflow_tpu_torch/c_api/`)
    and a C client against this Python (`sysconfig`); the client trains
    FM at full width on the card for 2 steps over phase 3's shard (the
    trace window over step 2), reads the AUC, loads the checkpoint and
    predicts 3 rows, within PCTR_ATOL of `ServeRunner(cfg, "cuda")
    .predict_rows` here; the trace names #1-#3, launched in the client's
    own process."""
    import sysconfig

    import numpy as np

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.serve.runner import ServeRunner

    t_leg = time.perf_counter()
    root = os.path.join(work, "c_api")
    os.makedirs(root)
    capi = os.path.join(HERE, "xflow_tpu_torch", "c_api")
    src, exe = os.path.join(root, "client.c"), os.path.join(root, "client")
    with open(src, "w") as f:
        f.write(CAPI_CLIENT)
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    link = [f"-L{libdir}", f"-L{sysconfig.get_config_var('LIBPL')}", f"-lpython{ver}",
            *(sysconfig.get_config_var("LIBS") or "").split(),
            *(sysconfig.get_config_var("SYSLIBS") or "").split(), f"-Wl,-rpath,{libdir}"]
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):  # a static libpython
        link += (sysconfig.get_config_var("LINKFORSHARED") or "").split()
    cmd = ["gcc", src, os.path.join(capi, "xflow_c_api.c"), f"-I{capi}",
           f"-I{sysconfig.get_path('include')}", *link, "-o", exe]
    b = subprocess.run(cmd, capture_output=True, text=True)
    if b.returncode != 0:
        fail(f"gcc could not build the C client on the port's shim: {b.stderr[-3000:]}")
    t_built = time.perf_counter()
    ck, prof = os.path.join(root, "ck"), os.path.join(root, "prof")
    pairs = {"model.name": "fm", "model.v_dim": V_DIM, "model.num_fields": NUM_FIELDS,
             "data.log2_slots": LOG2_SLOTS, "data.max_nnz": NUM_FIELDS,
             "data.batch_size": BATCH, "train.epochs": 1, "train.pred_dump": "false",
             "data.cache": "off", "train.trace_start_step": CAPI_TRACE_START,
             "train.trace_num_steps": 1}
    argv = [exe, path[: -len("-00000")], ck, prof, DEVICE]
    for k, v in pairs.items():
        argv += [k, str(v)]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": HERE})
    run_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the C client exited {r.returncode}: {r.stdout[-1500:]} {r.stderr[-3000:]}")
    auc = float(r.stdout.split("AUC=")[1].split()[0])
    pctr = [float(ln[len("PCTR="):]) for ln in r.stdout.splitlines() if ln.startswith("PCTR=")]
    runner = ServeRunner(override(cfg, **{"train.checkpoint_dir": ck}), device=DEVICE)
    gen = runner.load()
    want = runner.predict_rows(list(CAPI_ROWS))[0]
    err = float(np.max(np.abs(np.asarray(pctr) - want)))
    if gen.step != 2 or len(pctr) != 3 or err > PCTR_ATOL or not 0.0 < auc < 1.0:
        fail(f"the C client: step {gen.step}, AUC {auc}, pCTRs {pctr} against {want.tolist()} "
             f"({err} apart)")
    traced = trace_kernels(prof)
    counts = {k: len(v) for k, v in traced.items()}
    if any(n < 1 for n in counts.values()):
        fail(f"the C client's trace window over step {CAPI_TRACE_START} shows {counts}: #1-#3 "
             "did not launch in the embedded process")
    leg_s = time.perf_counter() - t_leg
    print(f"# C API on {card}: gcc {t_built - t_leg:.1f} s; the client (embedded CPython, FM "
          f"wv [2^{LOG2_SLOTS}, {1 + V_DIM}], 2 steps, evaluate, load, 3 predicts) {run_s:.1f} s; "
          f"AUC {auc:.6f}; pCTRs {pctr} vs ServeRunner {want.tolist()} ({err:.3g} apart); its "
          f"trace of step {CAPI_TRACE_START} names {counts} (#1-#3 in its own process); "
          f"{leg_s:.1f} s (budget {PHASE20_BUDGET_S['c_api']:.0f} s)", flush=True)
    return {"auc": auc, "max_abs_err": err, "traced": counts, "client_s": run_s,
            "leg_s": leg_s}


def run_mesh_sync(cfg, work: str, rate_path: str, card: str, solo_layout: dict) -> dict:
    """Phase 20 (c): the multi-slice syncer on an in-slice mesh. Two
    slices, each `Trainer(cfg, mesh)` on a world of one NCCL rank (a 1 x 1
    mesh, the fully-sharded engine), run one after the other in this
    process over two 4-batch shards, with one round each at K = 1 (the
    final): slice 1 applies slice 0's delta. Each delta holds the members,
    dtypes and shapes of phase 19's single-device slices' files
    (`solo_layout`), each fit launches #2, #5 and #6 once a step, and
    slice 1 ends at slice 0's delta plus its own (normwise within
    SYNC_SUM_RTOL)."""
    import numpy as np
    import torch

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.parallel.distributed import init_world, shutdown
    from xflow_tpu_torch.parallel.mesh import make_mesh
    from xflow_tpu_torch.train import checkpoint as ckpt
    from xflow_tpu_torch.train.trainer import Trainer

    t_leg = time.perf_counter()
    root = os.path.join(work, "mesh_sync")
    os.makedirs(root)
    shards = split_rows(rate_path, [
        (os.path.join(root, f"slice{j}-00000"), j * MESH_SYNC_BATCHES * BATCH,
         MESH_SYNC_BATCHES * BATCH) for j in range(2)])
    sync_dir = os.path.join(root, "sync")
    dev = init_world(0, 1, DEVICE, coordinator=f"127.0.0.1:{free_port()}")
    out = {"launches": {}, "fit_s": {}}
    keys = ("row_sums", "gather_sorted_multi", "scatter_sorted_multi")
    try:
        for j in range(2):
            os.environ["XFLOW_SLICE"], os.environ["XFLOW_NUM_SLICES"] = str(j), "2"
            jcfg = override(cfg, **{
                "data.train_path": shards[j][: -len("-00000")], "train.epochs": 1,
                "train.checkpoint_dir": os.path.join(root, f"ck{j}"), "mesh.data": 1,
                "mesh.table": 1, "optim.fused_scatter": "off", "sync.mode": "bounded",
                "sync.staleness_k": 1, "sync.every_steps": 0, "sync.dir": sync_dir,
                "sync.timeout_s": 30.0, "sync.retries": 0, "train.pred_dump": False,
                "train.metrics_path": os.path.join(root, f"metrics{j}.jsonl")})
            mesh = make_mesh(jcfg, device=dev)
            trainer = Trainer(jcfg, device=dev, mesh=mesh)
            torch.cuda.synchronize() if DEVICE == "cuda" else None
            st.reset_launches()
            t0 = time.perf_counter()
            res = trainer.fit()
            torch.cuda.synchronize() if DEVICE == "cuda" else None
            out["fit_s"][j] = time.perf_counter() - t0
            out["launches"][j] = {k: st.LAUNCHES[k] for k in keys}
            if res.steps != MESH_SYNC_BATCHES or any(
                    v != MESH_SYNC_BATCHES for v in out["launches"][j].values()):
                fail(f"mesh slice {j}: {res.steps} steps, launches {out['launches'][j]}")
            rounds = [x for x in read_jsonl(jcfg.train.metrics_path) if x.get("kind") == "sync"]
            if [(x["round"], x["applied"]) for x in rounds] != [(1, j)]:
                fail(f"mesh slice {j}: sync records {rounds}")
            out[f"round_ms_{j}"] = rounds[0]["dur_ms"]
            del trainer
    finally:
        for k in ("XFLOW_SLICE", "XFLOW_NUM_SLICES"):
            os.environ.pop(k, None)
        shutdown()
    layouts = {j: npz_layout(os.path.join(sync_dir, f"delta_s{j}_r1.npz")) for j in range(2)}
    for j, lay in layouts.items():
        if lay != solo_layout:
            fail(f"mesh slice {j}'s delta {lay} is not the single-device slices' {solo_layout}")
    # slice 1's final z: its own delta and slice 0's over the zero init
    got = np.load(os.path.join(root, "ck1", f"step_{MESH_SYNC_BATCHES}", "state.npz"))
    with np.load(os.path.join(sync_dir, "delta_s0_r1.npz")) as d0, \
            np.load(os.path.join(sync_dir, "delta_s1_r1.npz")) as d1:
        z = "opt/wv/z"
        want = d0[z].astype(np.float64) + d1[z]
        # both slices start from the same seeded state: slice 1's z is
        # init z (zeros) + both deltas
        sum_err = float(np.linalg.norm(got[z] - want) / max(np.linalg.norm(want), 1e-30))
    got.close()
    if sum_err > SYNC_SUM_RTOL:
        fail(f"mesh slice 1's z is {sum_err} from the two deltas' sum")
    leg_s = time.perf_counter() - t_leg
    out.update(delta_layout=layouts[0], sum_err=sum_err, leg_s=leg_s)
    print(f"# mesh sync on {card}: 2 slices, each a world of 1 NCCL rank (1 x 1, fully "
          f"sharded), {MESH_SYNC_BATCHES} steps and one round at K = 1: fits "
          f"{out['fit_s'][0]:.1f} / {out['fit_s'][1]:.1f} s, rounds {out['round_ms_0']:.0f} / "
          f"{out['round_ms_1']:.0f} ms, launches {out['launches']}; the deltas hold "
          f"{sorted(layouts[0])} as the single-device slices' do; slice 1's z vs the deltas' "
          f"sum {sum_err:.3g}; {leg_s:.1f} s (budget {PHASE20_BUDGET_S['mesh_sync']:.0f} s)",
          flush=True)
    return out


def run_phase20(cfg, work: str, path: str, rate_path: str, card: str, bare: dict,
                solo_layout: dict) -> dict:
    """Phase 20: the serve world, the C API and the syncer on a mesh."""
    t_phase = time.perf_counter()
    out = {"serve_world": run_serve_world(cfg, work, path, card, bare),
           "c_api": run_c_api(cfg, work, path, card),
           "mesh_sync": run_mesh_sync(cfg, work, rate_path, card, solo_layout)}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"# phase 20 took {out['phase_s']:.1f} s (budget "
          f"{sum(PHASE20_BUDGET_S.values()):.0f} s)", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
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

        laps, marks = {}, [t_start]

        def lap(name: str) -> None:  # seconds since the last lap, by phase function
            marks.append(time.perf_counter())
            laps[name] = round(marks[-1] - marks[-2], 1)

        lap("build_and_inputs")
        gen = ServeRunner(cfg, device=DEVICE).load()
        kern = check_kernels(cfg, gen, path)
        lap("check_kernels")
        kern += check_train_kernels(cfg, path)
        lap("check_train_kernels")
        it = batch_iterator(path, mcfg.data)
        mvm_batch = next(it)  # parsed once for the MVM checks
        it.close()
        seg_cfg = mvm_config(cfg, mcfg.train.checkpoint_dir, **{"model.mvm_exclusive": "off"})
        kern += check_multi_kernels(seg_cfg, mvm_batch)
        lap("check_multi_kernels")
        mvm_product = check_mvm_product_kernels(mcfg, mvm_batch)
        lap("check_mvm_product_kernels")
        hot = check_hot_scatters()
        lap("check_hot_scatters")
        mvm_steps_card_vs_cpu(mcfg, mvm_batch)
        lap("mvm_steps_card_vs_cpu")
        eval_launches = run_slice(cfg, gen, path, rate_path)
        lap("run_slice")
        train_launches, two_pass = run_training(cfg, work, path, rate_path)
        lap("run_training")
        lr_launches = run_lr(cfg, work, path, mvm_batch)
        lap("run_lr")
        segment = run_mvm_training(mcfg, work, path, rate_path)
        lap("run_mvm_training")
        ffm_kern = run_ffm(cfg, work, path, rate_path)
        lap("run_ffm")
        wide = check_wide_row_sums(cfg, path)
        lap("check_wide_row_sums")
        lab_kern = run_lab(work)
        lap("run_lab")
        run_serve(cfg, work, path, card)
        lap("run_serve")
        bare = run_fleet(cfg, work, path, card)
        lap("run_fleet")
        run_online(cfg, work, path, rate_path, card)
        lap("run_online")
        zipf = run_observe(work, rate_path, card)
        lap("run_observe")
        mesh = run_mesh(cfg, work, path, rate_path, card)
        lap("run_mesh")
        launch = run_launch(cfg, work, rate_path, card)
        lap("run_launch")
        p20 = run_phase20(cfg, work, path, rate_path, card, bare,
                          launch["multislice"]["delta_layout"])
        lap("run_phase20")
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
        if k["name"] in zipf:
            k["zipf"] = zipf[k["name"]]
        if k["name"] in mesh["launches"]:
            k["mesh"] = dict(mesh["launches"][k["name"]])
        if k["name"] == "scatter_sorted_multi":
            k["mesh"].update({key: mesh[key] for key in (
                "fs_positions", "fs_real", "fs_pads", "fs_scatter_ms", "fs_library_ms",
                "fs_bound_ms", "fs_max_abs_err")})
        if k["name"] == "gather_sorted_multi":
            k["mesh"]["fs_gather_ms"] = mesh["fs_gather_ms"]
        if k["name"] == "row_sums":
            k["mesh"]["fully_sharded"] = mesh["fs_row_sums"]
        if k["name"] in mesh["signal"]["launches"]:
            k["mesh"]["signal"] = mesh["signal"]["launches"][k["name"]]
        if k["name"] in launch["elastic"]["launches"] and k["name"] in OBS_KERNEL_NAMES:
            k["launch"] = {"elastic_resume": launch["elastic"]["launches"][k["name"]],
                           "solo_slice": launch["multislice"]["solo_launches"][k["name"]],
                           "slices_traced": {j: v[k["name"]] for j, v in
                                             launch["multislice"]["trace_launches"].items()}}
        if k["name"] in p20["c_api"]["traced"]:
            k["c_api_traced"] = p20["c_api"]["traced"][k["name"]]
        if k["name"] in p20["mesh_sync"]["launches"][0]:
            k.setdefault("mesh", {})["sync"] = {j: v[k["name"]]
                                 for j, v in p20["mesh_sync"]["launches"].items()}
    kern += lab_kern
    for k in kern:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    total = time.perf_counter() - t_start
    print(f"# seconds by phase function: {laps}", flush=True)
    print(f"# the smoke took {total:.1f} s (predicted {SMOKE_PREDICTED_S[0]:.0f}-"
          f"{SMOKE_PREDICTED_S[1]:.0f} s; limit 1200 s)", flush=True)
    print(card)
    print(json.dumps({"kernels": kern, "launch": launch, "phase20": p20}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
