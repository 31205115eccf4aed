#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit as nvidia-smi reports them;
2. build every CUDA kernel of the inference path from `xflow_tpu_torch/csrc/`
   (one nvcc per source, started together);
3. write the slice's inputs from a seed at the FM headline's full width
   (fused `wv [2^22, 11]`, 18 fields, 65,536-row batches): a committed
   npz checkpoint and a libffm shard of 2 x 65,536 rows;
4. load the checkpoint with `ServeRunner.load()` and hold each kernel
   against its plain PyTorch version on the main path's own inputs
   (the first batch's plan and gathered rows): the gather bit-exact with
   bf16 off and on, the row sum within 1e-4 relative over a 1e-2 floor
   (|got - want| <= 1e-4 * (|want| + 1e-2), float atomics reorder the
   sum); CUDA-event times of the kernel, the plain version and one
   PyTorch library call computing the same function;
5. the main path: `evaluate` over the shard on the card with the launch
   counts set to 0 just before and read just after (each kernel must have
   launched), the first batch's pCTRs held against the same evaluate on
   the CPU, and `predict_rows` on 8 rows held against their evaluate
   pCTRs (atol 1e-5).

The last three lines of standard output: the card line, the kernels
JSON, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
run outside a checkout of the repository, it fails before printing any.
"""

from __future__ import annotations

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
RTOL, FLOOR = 1e-4, 1e-2
PCTR_ATOL = 1e-5


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


def make_inputs(work: str, cfg):
    import numpy as np

    from xflow_tpu_torch.data.synth import generate_shards
    from xflow_tpu_torch.train.checkpoint import save_tables

    rng = np.random.default_rng(SEED)
    S, K = cfg.num_slots, 1 + V_DIM
    wv = (rng.standard_normal((S, K), dtype=np.float32) * np.float32(0.05))
    t0 = time.perf_counter()
    save_tables(cfg.train.checkpoint_dir, {"wv": wv}, step=1)
    t_ck = time.perf_counter() - t0
    t0 = time.perf_counter()
    (path,) = generate_shards(
        os.path.join(work, "test"), 1, SHARD_ROWS, num_fields=NUM_FIELDS,
        ids_per_field=IDS_PER_FIELD, seed=SEED,
    )
    print(f"# inputs: checkpoint {wv.nbytes / 1e6:.1f} MB in {t_ck:.1f} s, "
          f"shard {os.path.getsize(path) / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return path


def check_kernels(cfg, gen, path) -> list:
    """Each kernel against its plain version on the main path's inputs."""
    import torch

    from xflow_tpu_torch.data.libffm import iter_batches
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.models.fm import stack_channels
    from xflow_tpu_torch.ops import sorted_table as st

    batch = next(iter_batches(path, cfg.data))
    arrays = to_device(batch_arrays(batch, cfg), "cuda")
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
    ch = vals.shape[0]
    got = st.row_sums_cuda(vals, rows, BATCH)
    want = st.row_sums_plain(vals, rows, BATCH)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err / (want.abs() + FLOOR)).max().item()
    if not rel <= RTOL:
        fail(f"row_sums differs from its plain version: {rel} > {RTOL} (over a {FLOOR} floor)")
    print(f"# row_sums: max err {rel:.3g} relative over a {FLOOR} floor "
          f"(tolerance {RTOL}) over {tuple(got.shape)}", flush=True)
    r_ms = cuda_ms(lambda: st.row_sums_cuda(vals, rows, BATCH))
    r_plain = cuda_ms(lambda: st.row_sums_plain(vals, rows, BATCH))
    rows_l = rows.long()
    r_lib = cuda_ms(lambda: torch.zeros((BATCH, ch), device="cuda").index_add_(0, rows_l, vals.T))
    r_bound, r_by = bound_ms(ch * np_ * 4 + np_ * 4 + BATCH * ch * 4, ch * np_)
    results.append({
        "name": "row_sums", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/row_sums.cu",
        "replaces": "xflow_tpu/ops/sorted_table.py:1162",
        "max_abs_err": err.max().item(), "ms": r_ms, "plain_ms": r_plain,
        "bound_ms": r_bound, "bound_by": r_by, "library_ms": r_lib,
    })
    return results


def first_batch(cfg, tables, path, device):
    from xflow_tpu_torch.evaluate import predict_batches

    it = predict_batches(cfg, tables, path, device)
    try:
        return next(it)
    finally:
        it.close()


def run_slice(cfg, gen, path) -> dict:
    """The main path on the card, with the launch counts around it."""
    import numpy as np
    import torch

    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.ops import sorted_table as st
    from xflow_tpu_torch.serve.runner import ServeRunner

    st.reset_launches()
    t0 = time.perf_counter()
    auc, ll = evaluate(cfg, gen.tables, path, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    n_batches = -(-SHARD_ROWS // BATCH)
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path ({launches})")
    if not (np.isfinite(auc) and np.isfinite(ll) and 0.0 <= auc <= 1.0 and ll < 0.0):
        fail(f"evaluate gave auc={auc} logloss={ll}")
    # the weights are random, so an AUC near 0.5 is what a right path gives
    print(f"# evaluate on cuda: auc={auc} logloss={ll} over {n_batches} batches, "
          f"{wall / n_batches * 1e3:.1f} ms per batch end to end (host parse + plan + "
          f"forward); launches {launches}", flush=True)

    # first batch: the card against the CPU
    _, p_gpu = first_batch(cfg, gen.tables, path, "cuda")
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
    runner = ServeRunner(cfg, device="cuda")
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
        arrays = to_device(host, "cuda")
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
        from xflow_tpu_torch.serve.runner import ServeRunner

        gen = ServeRunner(cfg, device="cuda").load()
        kern = check_kernels(cfg, gen, path)
        launches = run_slice(cfg, gen, path)
    for k in kern:
        k["launches"] = launches[k["name"]]
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
