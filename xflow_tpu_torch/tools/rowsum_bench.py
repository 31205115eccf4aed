"""Times of the row sum #2 (`row_sums_cuda`, `csrc/row_sums.cu`) on the
card at the main paths' shapes:

    python xflow_tpu_torch/tools/rowsum_bench.py [--root DIR]

Plans (S = 2^22, made with numpy from a seed; a flat plan's rows are the
occurrences' rows in slot order, padded with `padded_len`'s pads at row 0,
value 0):

- `fm`: 65,536 rows x 18 fields of uniform slots, every channel N(0, 1),
  at FM's ch 24, MVM's product ch 32 and the wide ch 104, 128 and 136;
- `zipf`: the same rows with power-law slots (alpha 1.05, 200,000 ids a
  field), ch 24;
- `skewed`: `fm` with 4,096 of its occurrences moved to one row, ch 24;
- `fullshard`: the 1 x 1 fully-sharded buffer of `fm` (2,359,808
  positions: 1,179,648 real, then pads at row 0), ch 24.

Each case: the kernel checked bitwise against its plain version on the
CPU and across two launches, then CUDA-event times (20 calls) of the
kernel and of `zeros` + `index_add_` on the same inputs, each launched
kernel's device time by torch.profiler, and the bytes bound (vals and
rows read once, [B, ch] written once, 3.35 TB/s). One JSON line on
standard output, the card's name and power limit in it. `--root DIR`
imports `xflow_tpu_torch` from another checkout (DIR holds the
package), so two versions are timed in one call on one card, each in its
own process (run it as a script, as above, for `--root` to take
effect). Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

S = 1 << 22
FIELDS, ROWS = 18, 65536
PEAK_BYTES_PER_S = 3.35e12
REPS, SEED = 20, 0
ZIPF_ALPHA, ZIPF_IDS = 1.05, 200_000
CHUNK = 512
SKEW_TERMS, SKEW_ROW = 4096, 7


def _rows(slots, cap: int):
    """A flat plan's rows: each occurrence's row in slot order, then pads
    at row 0 to `cap`; and which positions are real."""
    import numpy as np

    order = np.argsort(slots.ravel(), kind="stable")
    rows = np.zeros(cap, np.int32)
    rows[: order.size] = order // slots.shape[1]
    return rows, np.arange(cap) < order.size


def _cases(seed: int):
    import numpy as np

    from xflow_tpu_torch.ops.sorted_table import padded_len

    rng = np.random.default_rng(seed)
    uni = rng.integers(0, S, (ROWS, FIELDS)).astype(np.int32)
    pmf = 1.0 / np.arange(1, ZIPF_IDS + 1, dtype=np.float64) ** ZIPF_ALPHA
    ids = np.searchsorted(np.cumsum(pmf / pmf.sum()), rng.random((ROWS, FIELDS)))
    place = rng.permutation(S)[: FIELDS * ZIPF_IDS].reshape(FIELDS, ZIPF_IDS)
    zipf = place[np.arange(FIELDS)[None, :], ids].astype(np.int32)
    n = ROWS * FIELDS
    fm = _rows(uni, padded_len(n))
    skew_rows = fm[0].copy()
    skew_rows[rng.permutation(n)[:SKEW_TERMS]] = SKEW_ROW
    return [
        *[("fm", ch, fm) for ch in (24, 32, 104, 128, 136)],
        ("zipf", 24, _rows(zipf, padded_len(n))),
        ("skewed", 24, (skew_rows, fm[1])),
        ("fullshard", 24, _rows(uni, -(-2 * n // CHUNK) * CHUNK + CHUNK)),
    ]


def _ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each CUDA kernel `fn` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0][-40:]:
            e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def run(reps: int = REPS, seed: int = SEED) -> dict:
    import numpy as np
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    rng = np.random.default_rng(seed + 1)
    out = []
    for case, ch, (rows_np, real) in _cases(seed):
        v_np = rng.standard_normal((ch, rows_np.size), dtype=np.float32) * real[None, :]
        v_cpu, r_cpu = torch.from_numpy(v_np), torch.from_numpy(rows_np)
        v, r = v_cpu.cuda(), r_cpu.cuda()

        def kernel(v=v, r=r):
            return st.row_sums_cuda(v, r, ROWS)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        want = st.row_sums_plain(v_cpu, r_cpu, ROWS)
        bitwise = bool(torch.equal(got, again) and torch.equal(got.cpu(), want))
        r_l = r.long()
        np_ = rows_np.size
        out.append({
            "case": case, "ch": ch, "positions": np_, "real": int(real.sum()),
            "bitwise": bitwise, "max_abs_err": (got.cpu() - want).abs().max().item(),
            "ms": _ms(kernel, reps),
            "library_ms": _ms(lambda: torch.zeros((ROWS, ch), device="cuda").index_add_(
                0, r_l, v.T), reps),
            "bound_ms": (np_ * (ch + 1) * 4 + ROWS * ch * 4) / PEAK_BYTES_PER_S * 1e3,
            "kernels_ms": _kernel_ms(kernel, reps),
        })
        c = out[-1]
        print(f"# {case} ch={ch}: {c['ms']:.4f} ms, zeros + index_add_ {c['library_ms']:.4f}, "
              f"bound {c['bound_ms']:.4f}, bitwise {bitwise}; by kernel "
              f"{ {n: round(t, 4) for n, t in c['kernels_ms'].items()} }",
              file=sys.stderr, flush=True)
    return {"cases": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="", help="import xflow_tpu_torch from this checkout")
    args = p.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 2
    import xflow_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    res = run()
    res.update({"ok": all(c["bitwise"] for c in res["cases"]), "card": card,
                "package": xflow_tpu_torch.__file__})
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
