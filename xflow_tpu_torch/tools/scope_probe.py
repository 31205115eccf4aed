"""What the train step's scope ranges and a profiler session cost on the
card, and what a fused-FM trace window holds:

    python -m xflow_tpu_torch.tools.scope_probe [--work DIR]

At FM width (S = 2^22, k = 10, 18 fields, 65,536-row batches of the
port's uniform bulk data, 200,000 ids a field, seed 0), FTRL, the guard
on:

- `costs`: the host microseconds of one `torch.profiler.record_function`
  range (entered and left) and of one small launch, 20,000 of each; the
  guarded fused-FM step's CUDA-event time (10 calls) on one batch with
  its ranges always open and with each a no-op, 4 of each, alternating;
  and the step with the guard off. Taken in a fresh process and again
  after one `torch.profiler` session in it;
- `trace`: `Trainer.fit` over 6 batches with `log_every` 1 and the trace
  window over steps 3-4: each window record's `device_ms` and
  `achieved_hbm_gbps`, and `tools/trace_attrib.py`'s table of the window
  with `other`'s largest events.

One JSON line on standard output, with the card's name and power limit.
Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROWS, FIELDS, V_DIM, LOG2_SLOTS, IDS = 65536, 18, 10, 22, 200_000
BATCHES, TRACE_START, TRACE_STEPS = 6, 3, 2
CALLS, STEP_REPS, ROUNDS = 20_000, 10, 4


def _config(**extra):
    from xflow_tpu_torch.config import Config, override

    return override(Config(), **{"model.name": "fm", "model.v_dim": V_DIM,
                                 "model.num_fields": FIELDS, "data.max_nnz": FIELDS,
                                 "data.batch_size": ROWS, "data.log2_slots": LOG2_SLOTS, **extra})


def _per_call_us(fn) -> float:
    import torch

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return round((time.perf_counter() - t) / CALLS * 1e6, 3)


def _cuda_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(STEP_REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return round(a.elapsed_time(b) / STEP_REPS, 4)


def costs(shard: str) -> dict:
    """The `costs` part (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import batch_arrays, to_device
    from xflow_tpu_torch.train import step as step_mod
    from xflow_tpu_torch.train.trainer import Trainer

    cfg = _config()
    it = batch_iterator(shard, cfg.data)
    host = batch_arrays(next(it), cfg)
    it.close()
    trainer = Trainer(cfg, device="cuda")
    state, arrays = trainer.state, to_device(host, "cuda")
    unguarded = step_mod.make_train_step(
        trainer.model, trainer.optimizer, override(cfg, **{"train.nonfinite_guard": "off"}))
    x = torch.ones(16, device="cuda")

    def one_range():
        with torch.profiler.record_function("grad"):
            pass

    def measure() -> dict:
        out = {"range_us": _per_call_us(one_range),
               "launch_us": _per_call_us(lambda: x.add_(1.0)), "open_ms": [], "none_ms": []}
        scope = step_mod.scope
        try:
            for i in range(2 * ROUNDS):
                bare = (i + i // 2) % 2 == 1  # open, none, none, open, ...
                step_mod.scope = ((lambda name: contextlib.nullcontext()) if bare
                                  else torch.profiler.record_function)
                out["none_ms" if bare else "open_ms"].append(
                    _cuda_ms(lambda: trainer.train_step(state, arrays)))
        finally:
            step_mod.scope = scope
        out["guard_off_ms"] = _cuda_ms(lambda: unguarded(state, arrays))
        return out

    fresh = measure()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            trainer.train_step(state, arrays)
        torch.cuda.synchronize()
    return {"fresh": fresh, "after_a_profiler_session": measure()}


def trace(prefix: str, work: str) -> dict:
    """The `trace` part (see the module docstring)."""
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.tools import trace_attrib as ta
    from xflow_tpu_torch.train.trainer import Trainer

    prof = os.path.join(work, "prof")
    metrics = os.path.join(work, "metrics_rank0.jsonl")
    Trainer(_config(**{"data.train_path": prefix, "train.epochs": 1, "train.log_every": 1,
                       "train.metrics_path": metrics, "train.profile_dir": prof,
                       "train.trace_start_step": TRACE_START,
                       "train.trace_num_steps": TRACE_STEPS}), device="cuda").fit()
    recs = [r for r in read_jsonl(metrics) if "loss" in r]
    events = ta.load_trace(ta.find_trace(prof))
    totals, counts, total_us = ta.attribute(events)
    other: dict = {}
    for e, scope in ta.event_scopes(events):
        if scope == "other":
            other[e["name"][:60]] = other.get(e["name"][:60], 0.0) + float(e["dur"])
    return {"device_ms": [r["device_ms"] for r in recs],
            "achieved_hbm_gbps": [r.get("achieved_hbm_gbps") for r in recs],
            "scopes": ta.payload(totals, counts, total_us),
            "other_top_ms": {k: round(v / 1e3, 4) for k, v in
                             sorted(other.items(), key=lambda kv: -kv[1])[:6]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xflow_tpu_torch.tools.scope_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="", help="work directory (default: a temporary one)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scope_probe: no CUDA card", file=sys.stderr)
        return 2
    from xflow_tpu_torch.data.synth import generate_shards_bulk

    with tempfile.TemporaryDirectory() as tmp:
        work = args.work or tmp
        (shard,), _ = generate_shards_bulk(os.path.join(work, "train"), 1, BATCHES * ROWS,
                                           num_fields=FIELDS, ids_per_field=IDS, seed=0)
        out = {"costs": costs(shard), "trace": trace(os.path.join(work, "train"), work)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
