"""Sparse-primitive microbench lab of the port: one harness for every
hot-path probe, the counterpart of `xflow_tpu/tools/bench_lab.py`.

    python -m xflow_tpu_torch.tools.bench_lab --suite core [--device cpu] [core flags]
    python -m xflow_tpu_torch.tools.bench_lab --suite micro|layout|mosaic|scatter|rowsum
    python -m xflow_tpu_torch.tools.bench_lab --suite hostplane [--rows N] [--caps 1,2,4]

The suites run on the card unless `--device cpu` is given; a CUDA device
that is asked for and missing is an error, never a fall back to the CPU.

- the shared harness: `timeit` (CUDA events around `inner` calls, the
  best of `iters`; on the CPU `perf_counter` with the result forced)
  replaces the JAX lab's `timeit_scan` / `timeit_carry`. Eager PyTorch
  hoists nothing out of a loop, so the JAX caveat does not apply; where
  the op itself carries its state (a scatter-add into the table it
  returns) the lab keeps that dependency, so the work equals the JAX
  cell's. `try_build` replaces `try_compile`: it builds, launches and
  checks one probe and reports OK/FAIL, never raising;
- `--suite core`: the gather / scatter-add / segment-sum matrix over
  table size x nnz x dtype, written as ONE record with the JAX record's
  keys. `bytes_accessed` is reckoned from the op's shapes (see
  `core_bytes`); the JAX record's `compile_time_s` and `flops` have no
  counterpart here. The default `--out` is `BENCH_LAB_TORCH.json`: the
  repository's `BENCH_LAB.json` is the JAX package's record;
- `micro`, `layout`, `scatter`: the JAX suites' ops as PyTorch calls
  (`index_select`, `index_add_`, elementwise, the windowed one-hot
  product through `torch.matmul`);
- `mosaic`: the slice-shape probes, kernels #7-#10 (`ops/lab.py`,
  `csrc/lab_mosaic.cu`), each checked bitwise against its numpy slice,
  the TMA encode result of each shape's plain 2-D tensor map, and the
  transpose E;
- `rowsum`: kernel #11 (`csrc/lab_rowsum.cu`) against its plain version
  and `np.add.at`, timed beside #2 (`row_sums_cuda`, the same contract),
  `zeros` + `index_add_` and the plain version.

- `hostplane`: the host data plane (`data/native.py`), on the host: the
  native parser's rows a second at 1, 2, 4 threads and the native
  planner's with 8 sub-batch plans on pools of 1, 2, 4 workers.

`mosaic` also reads the launch floor: a one-element `torch.zeros` fill
by the same profiler (`floor_ms`), and on the card gives the pieces #8-#10
cut each slice into (`pieces`, `ops/lab.py::col_pieces` / `row_pieces`).

Each suite function takes its shapes as keyword arguments with the JAX
values as defaults (so tests run them small), prints what the JAX suite
prints, and returns a record; `main` exits 1 where a record says
``"ok": False``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CORE_OPS = ("gather", "scatter_add", "segment_sum")
FLOOR = 1e-2  # the floor of the row sums' relative errors


# ----------------------------------------------------------- shared harness


def resolve_device(name: str) -> torch.device:
    """The device a suite runs on; raises where CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the lab runs on the card (pass --device cpu "
                           "to run the plain versions on the CPU)")
    return dev


def _force(out) -> None:
    while isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor) and out.numel():
        out.reshape(-1)[0].item()


def timeit(fn, device: torch.device, iters: int = 6, inner: int = 4) -> float:
    """Best seconds per call of fn() over `iters` runs of `inner` calls,
    after one warm-up call. On CUDA: events recorded around the `inner`
    calls on the current stream. On the CPU: `perf_counter`, each run's
    last result forced."""
    _force(fn())
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                out = fn()
            _force(out)
            t = time.perf_counter() - t0
        best = min(best, t / inner)
    return best


def device_ms(fn, reps: int = 50) -> float | None:
    """Device milliseconds per call of fn() on the card by `torch.profiler`:
    the own device time of every kernel, copy and memset it ran, summed
    over `reps` calls (after one warm-up call) and divided by `reps`. None
    where the profiler saw no device time. For a kernel of a few blocks the
    host's dispatch of a call takes longer than the kernel, so CUDA events
    around back-to-back calls read the host; this reads the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _force(fn())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / reps / 1e3 if total_us > 0 else None


def try_build(name: str, fn) -> bool:
    """Build, launch and check one probe (fn raises on a wrong result):
    print ``name: OK`` or ``name: FAIL — reason``. Never raises."""
    try:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"{name}: OK")
        return True
    except Exception as e:  # the probe's verdict is the line it prints
        msg = str(e).split("\n")[0][:140]
        print(f"{name}: FAIL — {msg}")
        return False


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0].strip()


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


# --------------------------------------------------------------- core sweep


def core_bytes(op: str, S: int, N: int, K: int, elem: int) -> int:
    """Bytes a cell's op must move, reckoned from its shapes (no XLA cost
    analysis here): 4 B an index; gather reads N rows and writes them
    (N*K*e each way); scatter_add reads the N*K values and reads and
    writes the N*K table entries they land on; segment_sum does the same
    into a fresh table, which it also writes whole (S*K*e)."""
    rows = N * K * elem
    if op == "gather":
        return 4 * N + 2 * rows
    if op == "scatter_add":
        return 4 * N + 3 * rows
    if op == "segment_sum":
        return S * K * elem + 4 * N + 3 * rows
    raise ValueError(f"op={op!r}: expected one of {CORE_OPS}")


def core_cell(op, table_log2, nnz_log2, dtype, row_width, iters, inner, device, seed=0):
    """One sweep cell: seeded operands (the JAX cell's numpy draws), the
    op timed by `timeit`, its bytes and achieved rate."""
    if dtype not in ("f32", "bf16"):
        # a silent float32 fallback would mislabel cells
        raise ValueError(f"dtype={dtype!r}: expected f32|bf16")
    if op not in CORE_OPS:
        raise ValueError(f"op={op!r}: expected one of {CORE_OPS}")
    S, N, K = 1 << table_log2, 1 << nnz_log2, int(row_width)
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.default_rng(seed + (table_log2 << 16) + (nnz_log2 << 8))
    idx = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(device)
    tab = torch.zeros((S, K), dtype=tdtype, device=device)
    vals = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(device, tdtype)

    if op == "gather":
        fn = lambda: tab.index_select(0, idx)  # noqa: E731
    elif op == "scatter_add":
        # the table is the carry: each call adds into the table it returned
        fn = lambda: tab.index_add_(0, idx, vals)  # noqa: E731
    else:
        fn = lambda: torch.zeros((S, K), dtype=tdtype, device=device).index_add_(0, idx, vals)  # noqa: E731
    t = timeit(fn, device, iters=iters, inner=inner)
    nbytes = core_bytes(op, S, N, K, tab.element_size())
    return {
        "op": op,
        "table_log2": int(table_log2),
        "nnz_log2": int(nnz_log2),
        "dtype": dtype,
        "row_width": K,
        "time_ms": round(t * 1e3, 4),
        "ns_per_element": round(t / (N * K) * 1e9, 4),
        "bytes_accessed": nbytes,
        "achieved_gbps": round(nbytes / t / 1e9, 4),
    }


def suite_core(argv=(), *, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(
        prog="bench_lab --suite core",
        description="deterministic gather/scatter-add/segment-sum sweep matrix -> "
        "BENCH_LAB_TORCH.json (BENCH_LAB.json is the JAX package's record)",
    )
    ap.add_argument("--table-log2", default="22",
                    help="comma list of log2 table sizes (default 22)")
    ap.add_argument("--nnz-log2", default="21",
                    help="comma list of log2 occurrence counts (default 21)")
    ap.add_argument("--dtypes", default="f32", help="comma list from {f32, bf16} (default f32)")
    ap.add_argument("--ops", default=",".join(CORE_OPS), help=f"comma list from {CORE_OPS}")
    ap.add_argument("--row-width", type=int, default=11,
                    help="table row width K (default 11 = fused FM)")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--inner", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--round", type=int, default=None,
                    help="trajectory round stamped into the record")
    ap.add_argument("--out", default="BENCH_LAB_TORCH.json",
                    help="output path ('-' = stdout); not BENCH_LAB.json, the JAX record")
    args = ap.parse_args(list(argv))

    dev = resolve_device(device)
    tables = [int(x) for x in args.table_log2.split(",") if x]
    nnzs = [int(x) for x in args.nnz_log2.split(",") if x]
    dtypes = [x.strip() for x in args.dtypes.split(",") if x.strip()]
    ops = [x.strip() for x in args.ops.split(",") if x.strip()]
    cells = []
    for op in ops:
        for tl in tables:
            for nl in nnzs:
                for dt in dtypes:
                    cell = core_cell(op, tl, nl, dt, args.row_width, args.iters, args.inner,
                                     dev, seed=args.seed)
                    cells.append(cell)
                    print(
                        f"{op:12s} S=2^{tl:<2d} N=2^{nl:<2d} {dt:4s} "
                        f"{cell['time_ms']:10.3f} ms  {cell['ns_per_element']:8.3f} ns/elem"
                        f"  {cell['achieved_gbps']:7.2f} GB/s",
                        file=sys.stderr,
                    )
    # headline: the gather cell at the LARGEST swept shape
    heads = [c for c in cells if c["op"] == "gather" and c["dtype"] == "f32"] or cells
    head = max(heads, key=lambda c: (c["table_log2"], c["nnz_log2"]))
    record = {
        "kind": "bench_lab",
        "device": device_name(dev),
        "host_cores": os.cpu_count(),
        "metric": f"lab_{head['op']}_ns_per_element",
        "value": head["ns_per_element"],
        "unit": "ns/element",
        "headline_cell": f"lab_{head['op']}_s{head['table_log2']}_n{head['nnz_log2']}"
                         f"_{head['dtype']}",
        "row_width": args.row_width,
        "iters": args.iters,
        "inner": args.inner,
        "seed": args.seed,
        "cells": cells,
    }
    if dev.type == "cuda":
        record["power_limit"] = power_limit()
    if args.round is not None:
        record["round"] = int(args.round)
    payload = json.dumps(record, indent=1)
    if args.out == "-":
        print(payload)
    else:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        print(f"bench_lab: wrote {len(cells)} cell(s) to {args.out}", file=sys.stderr)
    return record


# --------------------------------------------------- suite: micro (raw ops)


def suite_micro(argv=(), *, device: str = "cuda", log2_slots: int = 22, log2_nnz: int = 21,
                k: int = 11, dedup_log2=(17, 19), iters: int = 8, inner: int = 4) -> dict:
    """Raw latencies of the sparse-table ops (the JAX `micro` suite). The
    JAX cells run loop-invariant and out of place, so a scatter-add here
    is `index_add` into a copy of the table."""
    dev = resolve_device(device)
    S, N, K = 1 << log2_slots, 1 << log2_nnz, k
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(dev)
    idx_sorted = torch.sort(idx).values
    tab1 = torch.zeros((S,), device=dev)
    tabk = torch.zeros((S, K), device=dev)
    val1 = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
    valk = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(dev)

    def t(fn):
        return timeit(fn, dev, iters=iters, inner=inner)

    res = {}
    res["gather_scalar_2M"] = t(lambda: tab1.index_select(0, idx))
    res["gather_rows_2M_x11"] = t(lambda: tabk.index_select(0, idx))
    res["scatter_add_scalar_2M"] = t(lambda: tab1.index_add(0, idx, val1))
    res["scatter_add_rows_2M_x11"] = t(lambda: tabk.index_add(0, idx, valk))
    res["scatter_add_rows_sorted"] = t(lambda: tabk.index_add(0, idx_sorted, valk))
    res["segment_sum_rows_to_table"] = t(
        lambda: torch.zeros((S, K), device=dev).index_add_(0, idx, valk))
    res["segment_sum_sorted_hint"] = t(
        lambda: torch.zeros((S, K), device=dev).index_add_(0, idx_sorted, valk))
    res["ftrl_elementwise_3xSxK"] = t(lambda: tabk + tabk * tabk)
    # dedup shape: U unique rows + re-gather occurrences from the small array
    for u_log in dedup_log2:
        U = 1 << u_log
        uniq = torch.from_numpy(rng.integers(0, S, U).astype(np.int32)).to(dev)
        inv = torch.from_numpy(rng.integers(0, U, N).astype(np.int32)).to(dev)
        res[f"dedup_gather_U{U >> 10}k"] = t(
            lambda: tabk.index_select(0, uniq).index_select(0, inv))
        res[f"dedup_scatter_U{U >> 10}k"] = t(
            lambda: tabk.index_add(0, uniq, torch.zeros((U, K), device=dev).index_add_(0, inv, valk)))

    print(f"# device={device_name(dev)}")
    for name, v in res.items():
        print(f"{name:32s} {v * 1e3:8.2f} ms")
    return {"ok": True, "device": device_name(dev), "ms": {n: v * 1e3 for n, v in res.items()}}


# ------------------------------------------------- suite: layout (carried)


def suite_layout(argv=(), *, device: str = "cuda", log2_slots: int = 22, log2_nnz: int = 21,
                 k: int = 11, iters: int = 6, inner: int = 4) -> dict:
    """[S, k] against flat layouts, each state carried from call to call
    (the JAX `layout` suite)."""
    dev = resolve_device(device)
    S, K, N = 1 << log2_slots, k, 1 << log2_nnz
    if (S * K) % 128:
        raise ValueError(f"S * K = {S * K} must be a multiple of 128 for the [S*K/128, 128] layout")
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(dev)
    valk = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(dev)

    def carried(step, init):
        box = [init]

        def run():
            box[0] = step(box[0])
            return box[0]

        return timeit(run, dev, iters=iters, inner=inner)

    full = lambda *shape: torch.full(shape, 1.0, device=dev)  # noqa: E731
    mul = lambda x: x * 1.000001 + 1e-9  # noqa: E731
    r = {}
    r["elementwise [4M,11]"] = carried(mul, full(S, K))
    r["elementwise flat 44M"] = carried(mul, full(S * K))
    r["elementwise [344k,128]"] = carried(mul, full(S * K // 128, 128))

    a2d, aflat = full(S, K), full(S * K)
    r["gather rows [S,11]"] = timeit(lambda: a2d.index_select(0, idx).sum(), dev, iters, inner)
    r["gather via reshape"] = timeit(lambda: aflat.view(S, K).index_select(0, idx).sum(), dev,
                                     iters, inner)
    # scatter-add rows: the table is the carry, a true sequential dependency
    r["scatter rows [S,11]"] = carried(lambda t: t.index_add_(0, idx, valk), full(S, K))
    r["scatter via reshape"] = carried(
        lambda t: t.view(S, K).index_add_(0, idx, valk).view(S * K), full(S * K))

    # FTRL-ish update: w, n, z carried, g fixed
    def ftrl_step(c):
        w, n, z = c
        g = valk.sum() * 0 + 1e-4  # scalar, negligible
        n2 = n + g * g
        z2 = z + g - (torch.sqrt(n2) - torch.sqrt(n)) * 20.0 * w
        w2 = torch.where(z2.abs() <= 5e-5, torch.zeros((), device=dev),
                         -z2 / ((1.0 + torch.sqrt(n2)) * 20.0 + 10.0))
        return w2, n2, z2

    r["ftrl pass [4M,11]x3"] = carried(ftrl_step, (full(S, K), full(S, K) * 0.5, full(S, K) * 0.1))
    r["ftrl pass flat x3"] = carried(ftrl_step, (full(S * K), full(S * K) * 0.5, full(S * K) * 0.1))

    print(f"# device={device_name(dev)}  (s/iter, carry-threaded)")
    for name, v in r.items():
        print(f"{name:24s} {v * 1e3:8.2f} ms")
    return {"ok": True, "device": device_name(dev), "ms": {n: v * 1e3 for n, v in r.items()}}


# ---------------------------------------------------- suite: mosaic (TMA)


def _same(got, want, what: str) -> None:
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what} differs from the slice it copies")


def mosaic_inputs(seed: int = 0, block_rows: int = 512, chunk: int = 512, k: int = 11,
                  log2_slots: int = 14, log2_n: int = 13) -> dict:
    """`suite_mosaic`'s arrays from `seed`, as numpy: #7's table [S, K],
    #8's d_t [K, N], #9's sl_row [1, N], #10's d_rows [N, K] and the
    offsets `off` (S / block_rows + 1 of them, each a slice in range)."""
    S, N = 1 << log2_slots, 1 << log2_n
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((S, k), dtype=np.float32)
    d_t = rng.standard_normal((k, N), dtype=np.float32)
    sl_row = rng.integers(-(1 << 31), 1 << 31, (1, N), dtype=np.int64).astype(np.int32)
    d_rows = rng.standard_normal((N, k), dtype=np.float32)
    off = rng.integers(0, N - chunk + 1, S // block_rows + 1).astype(np.int32)
    return {"table": table, "d_t": d_t, "sl_row": sl_row, "d_rows": d_rows, "off": off}


def suite_mosaic(argv=(), *, device: str = "cuda", block_rows: int = 512, chunk: int = 512,
                 k: int = 11, log2_slots: int = 14, log2_n: int = 13, grid: int = 4,
                 transpose_log2: int = 22, seed: int = 0, iters: int = 6, inner: int = 20) -> dict:
    """The slice-shape probes #7-#10 (`ops/lab.py`): each built, launched
    over the TPU probe's grid and checked bitwise against the numpy slice
    (or 2 * table); the TMA encode result of each shape's plain 2-D tensor
    map (the TPU probe's OK/FAIL); the transpose E. The data and `off`
    come from `seed` (the TPU probe used zeros, which no copy could get
    wrong). A probe runs 4 to 32 blocks, so the host's dispatch of a call
    outlasts its kernel: on the card each time (`ms`, `plain_ms`,
    `library_ms`) is device time by `torch.profiler` (`device_ms`), and
    `host_ms` holds the CUDA events' figures around back-to-back calls
    beside it (on the CPU both are `perf_counter` times)."""
    from xflow_tpu_torch.ops import lab

    dev = resolve_device(device)
    W, C, K = block_rows, chunk, k
    S = 1 << log2_slots
    x = mosaic_inputs(seed, W, C, K, log2_slots, log2_n)
    table, d_t, sl_row, d_rows, off = (x[n] for n in ("table", "d_t", "sl_row", "d_rows", "off"))
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    t_table, t_dt, t_sl, t_rows, t_off = map(on, (table, d_t, sl_row, d_rows, off))

    def col_want(a):
        starts = (off[:grid] // C) * C
        tiles = np.stack([a[:, s:s + C] for s in starts])
        return torch.from_numpy(tiles), torch.from_numpy(tiles[:, 0, 0].copy())

    rows_tiles = np.stack([d_rows[o:o + C] for o in off[:grid]])
    want = {
        "a": torch.from_numpy(table * np.float32(2.0)),
        "b": col_want(d_t),
        "c": col_want(sl_row),
        "d": (torch.from_numpy(rows_tiles), torch.from_numpy(rows_tiles[:, 0, 0].copy())),
    }
    probes = {
        "a": (f"A block ({W},{K}) f32", lambda: lab.block_scale(t_table, W, 2.0)),
        "b": (f"B dma [{K},{C}] of [{K},N] f32", lambda: lab.col_slices(t_dt, t_off, C, grid)),
        "c": (f"C dma [1,{C}] of [1,N] i32", lambda: lab.col_slices(t_sl, t_off, C, grid)),
        "d": (f"D dma [{C},{K}] of [N,{K}] f32 dyn-row",
              lambda: lab.row_slices(t_rows, t_off, C, grid)),
    }

    def check(key):
        got = probes[key][1]()
        plain = plain_fns[key]()
        if key == "a":
            got, plain, ref = (got,), (plain,), (want["a"],)
        else:
            ref = want[key]
        for part, g, p, r in zip(("tiles", "scalars"), got, plain, ref):
            _same(g, p, f"{key.upper()}'s {part} against its plain version")
            _same(g, r, f"{key.upper()}'s {part} against numpy")

    plain_fns = {
        "a": lambda: lab.block_scale_plain(t_table, W, 2.0),
        "b": lambda: lab.col_slices_plain(t_dt, t_off, C, grid),
        "c": lambda: lab.col_slices_plain(t_sl, t_off, C, grid),
        "d": lambda: lab.row_slices_plain(t_rows, t_off, C, grid),
    }
    ok = {key: try_build(name, lambda key=key: check(key)) for key, (name, _) in probes.items()}

    # the TMA encode of each shape's plain 2-D tensor map
    box = lab.TMA_BOX
    maps = {
        "a": (t_table, (min(W, box), K)),
        "b": (t_dt, (K, box)),
        "c": (t_sl, (1, box)),
        "d": (t_rows, (min(C, box), K)),
    }
    tma = {}
    for key, (src, bx) in maps.items():
        what = (f"{key.upper()} tensor map [{src.shape[0]},{src.shape[1]}] "
                f"{'i32' if src.dtype == torch.int32 else 'f32'} box [{bx[0]},{bx[1]}]")
        if dev.type != "cuda":
            print(f"{what}: not run (no CUDA device)")
            continue
        tma[key] = lab.tma_encode(src, bx)
        print(f"{what}: {lab.tma_result(tma[key])}")

    # times beside the plain version and one library call
    starts = torch.from_numpy((off[:grid] // C) * C).to(dev).long()
    span = torch.arange(C, device=dev)
    col_idx = (starts[:, None] + span).reshape(-1)
    row_idx = (t_off[:grid].long()[:, None] + span).reshape(-1)
    # one library call computing each probe's tiles: all `grid` slices at
    # once (a slice's .clone() copies one); the bytes each probe must move
    library = {
        "a": (lambda: t_table * 2, 2 * S * K * 4),
        "b": (lambda: t_dt.index_select(1, col_idx), 2 * grid * K * C * 4 + 8 * grid),
        "c": (lambda: t_sl.index_select(1, col_idx), 2 * grid * C * 4 + 8 * grid),
        "d": (lambda: t_rows.index_select(0, row_idx), 2 * grid * C * K * 4 + 8 * grid),
    }
    rec = {}
    for key, (name, fn) in probes.items():
        if not ok[key]:
            continue
        fns = {"kernel": fn, "plain": plain_fns[key], "library": library[key][0]}
        host = {f: timeit(g, dev, iters=iters, inner=inner) * 1e3 for f, g in fns.items()}
        dev_t = {f: device_ms(g) for f, g in fns.items()} if dev.type == "cuda" else {}
        by = "torch.profiler" if dev_t and None not in dev_t.values() else (
            "CUDA events" if dev.type == "cuda" else "perf_counter")
        t = dev_t if by == "torch.profiler" else host
        rec[key] = {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
                    "ms_by": by, "host_ms": host, "bytes": library[key][1], "max_abs_err": 0.0}
        if key != "a" and dev.type == "cuda":  # the pieces #8-#10 launched with
            rec[key]["pieces"] = lab.PIECES[f"mosaic_{key}"]
        cut = f", {rec[key]['pieces']} pieces a slice" if "pieces" in rec[key] else ""
        print(f"{name}{cut}: {t['kernel']:.5f} ms (plain {t['plain']:.4f}, library "
              f"{t['library']:.4f}) by {by}; back-to-back calls {host['kernel']:.4f} (plain "
              f"{host['plain']:.4f}, library {host['library']:.4f})")

    # the launch floor: one one-element fill, read as the probes are
    fill = lambda: torch.zeros(1, device=dev)  # noqa: E731
    floor = device_ms(fill) if dev.type == "cuda" else None
    floor_by = "torch.profiler" if floor is not None else "perf_counter"
    if floor is None:
        floor, floor_by = timeit(fill, dev, iters=iters, inner=inner) * 1e3, (
            "CUDA events" if dev.type == "cuda" else "perf_counter")
    print(f"launch floor (torch.zeros(1) fill): {floor:.5f} ms by {floor_by}")

    # E: transpose cost [4M, 11] <-> [11, 4M]
    big = torch.ones((1 << transpose_log2, K), device=dev)
    s = [0.0]

    def tr():
        s[0] += 1.0
        return (big + s[0]).t().contiguous()

    t_e = timeit(tr, dev, iters=4, inner=1)
    print(f"E transpose [{big.shape[0]},{K}]->[{K},{big.shape[0]}]: {t_e * 1e3:.3f} ms")
    gate = all(ok.values()) and (dev.type != "cuda" or (tma["b"] == 0 and tma["c"] == 0))
    return {"ok": gate, "device": device_name(dev), "probes_ok": ok, "tma": tma,
            "kernels": rec, "transpose_ms": t_e * 1e3, "off": off[:grid].tolist(),
            "floor_ms": floor, "floor_by": floor_by}


# ------------------------------------------- suite: scatter (windowed plan)


def host_sort_plan(slots_flat: np.ndarray, S: int, C: int = 1024, W: int = 2048):
    """(perm [M], sorted_slots [M], bases [M//C]) — chunks grid-aligned.

    perm maps sorted position -> occurrence index (N = dummy zero row).
    The windowed-matmul scatter design probe's host planner."""
    N = slots_flat.shape[0]
    order = np.argsort(slots_flat, kind="stable")
    ss = slots_flat[order]
    win = ss // W
    # chunk boundaries: every C occurrences, or window change
    M_cap = N + (S // W + 1) * C
    perm = np.full(M_cap, N, np.int32)
    srt = np.zeros(M_cap, np.int32)
    bases = []
    pos = 0
    i = 0
    while i < N:
        w = win[i]
        j = min(N, i + C)
        # shrink to this window only
        j = i + int(np.searchsorted(win[i:j], w + 1))
        take = j - i
        perm[pos: pos + take] = order[i:j]
        srt[pos: pos + take] = ss[i:j]
        srt[pos + take: pos + C] = w * W  # dummies point in-window
        bases.append(w * W)
        pos += C
        i = j
    nchunks = len(bases)
    return (
        perm[: nchunks * C],
        srt[: nchunks * C],
        np.asarray(bases, np.int32),
    )


def windowed_scatter(d, perm, srt2d, bases, S: int, W: int,
                     onehot_bytes: int = 1 << 28) -> torch.Tensor:
    """The windowed one-hot scatter: each chunk of C sorted occurrences
    becomes a [C, W] one-hot of its window, multiplied into its [W, K]
    update by `torch.matmul` (float32 throughout: TF32 is off for
    matmuls by default), the updates added into their windows. Chunks go
    in groups whose one-hot stays under `onehot_bytes`."""
    nchunks, C = srt2d.shape
    K = d.shape[1]
    dpad = torch.cat([d, torch.zeros((1, K), dtype=d.dtype, device=d.device)])
    ds = dpad.index_select(0, perm).view(nchunks, C, K)
    tab = torch.zeros((S, K), dtype=d.dtype, device=d.device)
    windows = tab.view(S // W, W, K)
    iota = torch.arange(W, device=d.device, dtype=torch.int32)
    group = max(1, onehot_bytes // (C * W * 4))
    for g0 in range(0, nchunks, group):
        sch, base = srt2d[g0:g0 + group], bases[g0:g0 + group]
        onehot = ((sch - base[:, None])[:, :, None] == iota).to(d.dtype)  # [g, C, W]
        upd = torch.matmul(onehot.transpose(1, 2), ds[g0:g0 + group])  # [g, W, K]
        windows.index_add_(0, (base // W).long(), upd)
    return tab


def suite_scatter(argv=(), *, device: str = "cuda", log2_slots: int = 22, log2_nnz: int = 21,
                  k: int = 11, chunk: int = 1024, window: int = 2048, iters: int = 5) -> dict:
    """Sorted windowed-matmul scatter design probe (the JAX `scatter`
    suite): host plan, permute gather, windowed scatter end to end, the
    `index_add_` baseline and their difference."""
    dev = resolve_device(device)
    C, W = chunk, window
    S, N, K = 1 << log2_slots, 1 << log2_nnz, k
    rng = np.random.default_rng(0)
    slots = rng.integers(0, S, N).astype(np.int32)
    d_occ = rng.normal(size=(N, K)).astype(np.float32)

    t0 = time.perf_counter()
    perm, srt, bases = host_sort_plan(slots, S, C, W)
    t_host = time.perf_counter() - t0
    nchunks = len(bases)
    print(f"host plan: {t_host * 1e3:.1f} ms, nchunks={nchunks} (pad {nchunks * C / N:.3f}x)")

    tperm = torch.from_numpy(perm).to(dev)
    tsrt = torch.from_numpy(srt.reshape(nchunks, C)).to(dev)
    tbases = torch.from_numpy(bases).to(dev)
    td = torch.from_numpy(d_occ).to(dev)
    tslots = torch.from_numpy(slots).to(dev)

    def permute():
        dpad = torch.cat([td, torch.zeros((1, K), device=dev)])
        return dpad.index_select(0, tperm)

    t_perm = timeit(permute, dev, iters=iters, inner=1)
    print(f"permute gather [{len(perm)},{K}]: {t_perm * 1e3:7.1f} ms")
    windowed = lambda: windowed_scatter(td, tperm, tsrt, tbases, S, W)  # noqa: E731
    t_win = timeit(windowed, dev, iters=iters, inner=1)
    print(f"windowed scatter e2e   : {t_win * 1e3:7.1f} ms")
    xla = lambda: torch.zeros((S, K), device=dev).index_add_(0, tslots, td)  # noqa: E731
    t_xla = timeit(xla, dev, iters=iters, inner=1)
    print(f"index_add_ scatter     : {t_xla * 1e3:7.1f} ms")
    err = (windowed() - xla()).abs().max().item()
    print(f"max |windowed - index_add_|: {err:.3e}")
    return {"ok": True, "device": device_name(dev), "host_plan_ms": t_host * 1e3,
            "nchunks": nchunks, "permute_ms": t_perm * 1e3, "windowed_ms": t_win * 1e3,
            "index_add_ms": t_xla * 1e3, "max_abs_err": err}


# --------------------------------------------- suite: rowsum (row reduction)


def rel_err(got: torch.Tensor, want: torch.Tensor, floor: float = 1e-30) -> float:
    """Max ELEMENTWISE relative error (in float64 on the host): with a
    table's huge dynamic range a global-max denominator would hide wrong
    small entries. `floor` is the scale below which differences count as
    absolute (reductions whose terms cancel to about 0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((got - want).abs() / (want.abs() + floor)).max())


def reorder_err(got: torch.Tensor, want: torch.Tensor, vals: torch.Tensor,
                rows: torch.Tensor, num_rows: int) -> float:
    """|got - want| as a share of the most that two float32 summation
    orders of the same terms may differ by: 2 (n - 1) 2^-24 sum |x| for a
    row of n terms x (each order is within (n - 1) u sum |x| of the exact
    sum). Under 1 is reordering alone; a lost or misrouted term of a
    unit-scale sum reads in the thousands."""
    rows_l = rows.long().cpu()
    n = torch.bincount(rows_l, minlength=num_rows).double()[:, None]
    abs_sum = torch.zeros((num_rows, vals.shape[0]), dtype=torch.float64).index_add_(
        0, rows_l, vals.double().abs().cpu().T)
    bound = 2 * (n - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
    diff = (got.double().cpu() - want.double().cpu()).abs()
    if bool((diff[bound == 0] > 0).any()):
        return float("inf")
    return (diff / bound.clamp(min=1e-300)).max().item()


def suite_rowsum(argv=(), *, device: str = "cuda", batch: int = 65536, ch: int = 24,
                 np_occ: int = 2098176, num_batches: int = 4, iters: int = 3) -> dict:
    """The row-reduction probe, kernel #11 (`ops/lab.py::lab_rowsum`):
    first its error on the first batch against its plain version and
    against `np.add.at` (the JAX suite's own check); then the times per
    batch, over the `num_batches` batches, of the lab kernel, of #2 (`row_sums_sorted`: the same
    contract) on the same inputs, of `zeros` + `index_add_` (the JAX
    suite's `jax.ops.segment_sum`) and of the plain version; and the L2
    vector reductions the kernel sends a batch (`l2_reductions`, computed
    from the first batch's inputs: one a nonzero quad in range).

    Each error is printed two ways: relative over a 1e-2 floor, and as a
    share of the float32 reorder bound (`reorder_err`). The gate is the
    bound (raises over 1): at this shape a row sums about 32 unit-scale
    terms whose partial sums reach 20-30, so any two summation orders
    differ by a few ulps of 16 (9.5e-6), over 1e-4 of a 1e-2 floor, the
    TPU kernel's own even/odd order (the plain version) included."""
    from xflow_tpu_torch.ops import lab
    from xflow_tpu_torch.ops import sorted_table as st

    dev = resolve_device(device)
    B, CH, Np, K = batch, ch, np_occ, num_batches
    rng = np.random.default_rng(0)
    rows = rng.integers(0, B, (K, Np)).astype(np.int32)
    vals = rng.normal(size=(K, CH, Np)).astype(np.float32)
    t_rows, t_vals = torch.from_numpy(rows).to(dev), torch.from_numpy(vals).to(dev)

    want = np.zeros((B, CH), np.float32)
    np.add.at(want, rows[0], vals[0].T)
    t_want = torch.from_numpy(want)
    plain = lab.rowsum_plain(t_vals[0], t_rows[0], B)
    got = lab.lab_rowsum(t_vals[0], t_rows[0], B)
    e = {
        "max_abs_err": (got.cpu() - plain.cpu()).abs().max().item(),
        "max_abs_np": (got.cpu() - t_want).abs().max().item(),
        "rel_plain": rel_err(got, plain, FLOOR), "rel_np": rel_err(got, t_want, FLOOR),
        "bound_plain": reorder_err(got, plain, t_vals[0], t_rows[0], B),
        "bound_np": reorder_err(got, t_want, t_vals[0], t_rows[0], B),
    }
    print(f"correctness: max abs err = {e['max_abs_np']:.2e} vs np.add.at, "
          f"{e['max_abs_err']:.2e} vs plain; relative over a {FLOOR} floor {e['rel_np']:.2e} / "
          f"{e['rel_plain']:.2e}; share of the float32 reorder bound {e['bound_np']:.3f} / "
          f"{e['bound_plain']:.3f}")
    if not (e["bound_plain"] <= 1 and e["bound_np"] <= 1):
        raise AssertionError(f"lab_rowsum beyond the float32 reorder bound: {e}")

    l2 = lab.rowsum_l2_reductions(t_vals[0], t_rows[0], B)
    print(f"L2 vector reductions a batch (computed from the inputs): {l2:,}")

    rows_l = t_rows.long()
    methods = {
        "lab rowsum (red.v4)": lambda i: lab.lab_rowsum(t_vals[i], t_rows[i], B),
        "row_sums (#2)": lambda i: st.row_sums_sorted(t_vals[i], t_rows[i], B),
        "zeros + index_add_": lambda i: torch.zeros((B, CH), device=dev).index_add_(
            0, rows_l[i], t_vals[i].T),
        "plain": lambda i: lab.rowsum_plain(t_vals[i], t_rows[i], B),
    }
    times = {}
    for name, fn in methods.items():
        def all_batches(fn=fn):
            return [fn(i) for i in range(K)]

        best = timeit(all_batches, dev, iters=iters, inner=1) / K
        times[name] = best * 1e3
        print(f"{name}: {best * 1e3:.4f} ms ({best / Np * 1e9:.4f} ns/occurrence)")
    return {"ok": True, "device": device_name(dev), "errors": e, "ms": times,
            "l2_reductions": l2, "bytes": Np * (CH + 1) * 4 + B * CH * 4, "adds": Np * CH}


# -------------------------------------------------------------------- main


# ---------------------------------------------- suite: hostplane (CPU side)


def _hostplane_parse(path: str, caps, cfg) -> dict:
    """Rows a second the input pipeline reads from `path` at each parser
    thread count (a warm pass first: the page cache and the pool)."""
    from xflow_tpu_torch.config import override
    from xflow_tpu_torch.data.pipeline import batch_iterator

    out = {}
    for cap in caps:
        c = override(cfg, **{"data.parser_threads": cap})
        for _ in batch_iterator(path, c.data):
            pass
        t0 = time.perf_counter()
        n = sum(b.num_rows for b in batch_iterator(path, c.data))
        out[f"parse_rows_per_sec_{cap}w"] = round(n / (time.perf_counter() - t0), 1)
    return out


def _hostplane_plan(caps, batch: int, nnz: int, log2_slots: int, num_sub: int) -> dict:
    """Rows a second the native planner plans, `num_sub` sub-batch plans
    at a time on a pool of each size (the trainer's parallel unit)."""
    from concurrent.futures import ThreadPoolExecutor

    from xflow_tpu_torch.data.native import native_plan_sorted
    from xflow_tpu_torch.ops.sorted_table import WINDOW, padded_len

    S = 1 << log2_slots
    rng = np.random.default_rng(0)
    bs = batch // num_sub
    subs = [np.ascontiguousarray(rng.integers(0, S, (bs, nnz)).astype(np.int32))
            for _ in range(num_sub)]
    mask = np.ones((bs, nnz), np.float32)

    def one(i):
        return native_plan_sorted(subs[i], mask, None, S, WINDOW, padded_len(bs * nnz))

    out = {}
    for cap in caps:
        with ThreadPoolExecutor(max_workers=cap) as pool:
            list(pool.map(one, range(num_sub)))  # warm
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                list(pool.map(one, range(num_sub)))
            dt = (time.perf_counter() - t0) / reps
        out[f"plan_rows_per_sec_{cap}w"] = round(batch / dt, 1)
    return out


def suite_hostplane(argv=(), *, device: str = "cpu", rows: int = 500_000,
                    batch: int = 65536, nnz: int = 18, log2_slots: int = 22,
                    num_sub: int = 8, caps: str = "1,2,4") -> dict:
    """The host data plane's scaling, after the JAX lab's `hostplane`:
    the native parser's rows a second at each thread count in `caps`,
    over a bulk synthetic shard of `rows` rows (200,000 ids a field),
    and the native planner's rows a second with `num_sub` sub-batch
    plans on a pool of each size. Host only: `device` is not used.
    `host_cores` is the cores this process may run on."""
    import tempfile

    ap = argparse.ArgumentParser(prog="bench_lab --suite hostplane")
    ap.add_argument("--rows", type=int, default=rows)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--nnz", type=int, default=nnz)
    ap.add_argument("--log2-slots", type=int, default=log2_slots)
    ap.add_argument("--num-sub", type=int, default=num_sub,
                    help="concurrent sub-batch plans (the trainer's parallelism unit)")
    ap.add_argument("--caps", default=caps)
    args = ap.parse_args(list(argv))

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.data.synth import generate_shards_bulk

    cap_list = [int(c) for c in args.caps.split(",")]
    record = {"host_cores": len(os.sched_getaffinity(0))}
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "t")
        generate_shards_bulk(prefix, 1, args.rows, num_fields=args.nnz,
                             ids_per_field=200_000, seed=0)
        cfg = override(Config(), **{
            "data.batch_size": args.batch, "data.max_nnz": args.nnz,
            "data.log2_slots": args.log2_slots, "model.num_fields": args.nnz,
        })
        record.update(_hostplane_parse(prefix + "-00000", cap_list, cfg))
    record.update(_hostplane_plan(cap_list, args.batch, args.nnz, args.log2_slots,
                                  args.num_sub))
    print(json.dumps(record))
    return record


SUITES = {
    "core": suite_core,
    "micro": suite_micro,
    "layout": suite_layout,
    "mosaic": suite_mosaic,
    "scatter": suite_scatter,
    "rowsum": suite_rowsum,
    "hostplane": suite_hostplane,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        description="sparse-primitive microbench lab of the PyTorch port (the counterpart of "
        "xflow_tpu.tools.bench_lab)"
    )
    ap.add_argument("--suite", default="core", choices=sorted(SUITES),
                    help="which probe suite to run (default: the core sweep matrix -> "
                         "BENCH_LAB_TORCH.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions on the CPU")
    args, rest = ap.parse_known_args(argv)
    record = SUITES[args.suite](rest, device=args.device)
    return 0 if record.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
