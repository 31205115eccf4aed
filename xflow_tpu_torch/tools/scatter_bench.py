"""Times of the staged scatters, #4 (`scatter_sorted`) and #6
(`scatter_sorted_multi`), on the card at the main paths' shapes:

    python xflow_tpu_torch/tools/scatter_bench.py [--root DIR]

Plans (S = 2^22, made with numpy from a seed: sorted slots padded to a
multiple of 512 with S - 1, pads carrying d = 0):

- `uniform`: 65,536 rows x 18 fields of uniform slots, flat (#4 at FM's
  K = 11 and MVM's K = 10) and stacked in 4 buffers (#6 at K = 10);
- `ffm`: 131,072 x 18 uniform, #4 at FFM's K = 73;
- `hot`: `uniform` with every row's first field on one slot, a run of
  65,536 (16,384 a buffer stacked), as `chip_smoke.check_hot_scatters`;
- `zipf`: 65,536 x 18 draws of a power law (alpha 1.05) bounded to
  200,000 ids a field (`gen-data --zipf-alpha 1.05`, bench.py's end-to-end
  data), ids placed on slots by a seeded permutation;
- `fullshard`: the 1 x 1 fully-sharded buffer of `uniform` (2,359,808
  positions: 1,179,648 real, then pads at S - 1), #6 at K = 11.

Each case: the kernel checked bitwise against its plain version on the
CPU and across two launches, then CUDA-event times (20 calls) of the
kernel and of `zeros` + `index_add_` on the same inputs, each launched
kernel's device time by torch.profiler, and the bytes bound (d[:K] and
the slots read once, [S, K] written once, 3.35 TB/s). One JSON line on
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
HOT_SLOT = 12345
REPS, SEED = 20, 0
ZIPF_ALPHA, ZIPF_IDS = 1.05, 200_000
CHUNK = 512


def _padded(sorted_slots, cap):
    import numpy as np

    return np.concatenate([sorted_slots, np.full(cap - sorted_slots.size, S - 1, np.int32)])


def _cap(n: int) -> int:
    return -(-n // CHUNK) * CHUNK


def _flat(slots):
    """(sorted_slots, win_off, real) of a flat plan of `slots` [B, F]."""
    import numpy as np

    ss = np.sort(slots.ravel()).astype(np.int32)
    real = np.arange(_cap(ss.size)) < ss.size
    ss = _padded(ss, _cap(ss.size))
    wo = np.searchsorted(ss, np.arange(0, S + 1, 2048)).astype(np.int32)
    return ss, wo, real


def _stacked(slots, ns=4):
    """(sorted_slots [ns * cap], loc_off [ns, S/2048 + 1], real) of `slots`
    cut into ns row blocks, each sorted on its own."""
    import numpy as np

    parts = [np.sort(p.ravel()).astype(np.int32) for p in np.split(slots, ns)]
    cap = _cap(max(p.size for p in parts))
    real = np.concatenate([np.arange(cap) < p.size for p in parts])
    bufs = [_padded(p, cap) for p in parts]
    loc = np.stack([np.searchsorted(b, np.arange(0, S + 1, 2048)) for b in bufs])
    loc[:, -1] = cap
    return np.concatenate(bufs), loc.astype(np.int32), real


def _fullshard(slots):
    """The 1 x 1 fully-sharded buffer: the real occurrences, then pads to
    a capacity of twice their count plus one CHUNK (`fullshard_capacity`
    at slack 2.0)."""
    import numpy as np

    ss = np.sort(slots.ravel()).astype(np.int32)
    cap = -(-2 * ss.size // CHUNK) * CHUNK + CHUNK
    loc = np.searchsorted(_padded(ss, cap), np.arange(0, S + 1, 2048)).astype(np.int32)
    loc[-1] = cap
    return _padded(ss, cap), loc[None, :], np.arange(cap) < ss.size


def _cases(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    uni = rng.integers(0, S, (ROWS, FIELDS)).astype(np.int32)
    hot = uni.copy()
    hot[:, 0] = HOT_SLOT
    pmf = 1.0 / np.arange(1, ZIPF_IDS + 1, dtype=np.float64) ** ZIPF_ALPHA
    ids = np.searchsorted(np.cumsum(pmf / pmf.sum()), rng.random((ROWS, FIELDS)))
    place = rng.permutation(S)[: FIELDS * ZIPF_IDS].reshape(FIELDS, ZIPF_IDS)
    zipf = place[np.arange(FIELDS)[None, :], ids].astype(np.int32)
    ffm = rng.integers(0, S, (2 * ROWS, FIELDS)).astype(np.int32)
    flat, stack = "scatter_sorted", "scatter_sorted_multi"
    return [
        ("uniform", flat, 11, _flat(uni)), ("uniform", flat, 10, _flat(uni)),
        ("uniform", stack, 10, _stacked(uni)), ("ffm", flat, 73, _flat(ffm)),
        ("hot", flat, 11, _flat(hot)), ("hot", stack, 10, _stacked(hot)),
        ("zipf", flat, 11, _flat(zipf)), ("zipf", stack, 10, _stacked(zipf)),
        ("fullshard", stack, 11, _fullshard(uni)),
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
    return {e.key.split("(")[0][-40:]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def run(reps: int = REPS, seed: int = SEED) -> dict:
    import numpy as np
    import torch

    from xflow_tpu_torch.ops import sorted_table as st

    rng = np.random.default_rng(seed + 1)
    out = []
    for case, name, k, (ss_np, off_np, real) in _cases(seed):
        d_np = rng.standard_normal((st._k8(k), ss_np.size), dtype=np.float32)
        d_np[:k] *= real[None, :]
        d_cpu, ss_cpu, off_cpu = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (d_np, ss_np, off_np))
        d, ss, off = d_cpu.cuda(), ss_cpu.cuda(), off_cpu.cuda()
        if name == "scatter_sorted":
            def kernel(d=d, ss=ss, off=off, k=k):
                return st.scatter_sorted_cuda(d, ss, off, S, k)
            want = st.scatter_sorted_plain(d_cpu, ss_cpu, S, k)
        else:
            def kernel(d=d, ss=ss, off=off, k=k):
                return st.scatter_sorted_multi_cuda(d, ss, off, S, k)
            want = st.scatter_sorted_multi_plain(d_cpu, ss_cpu, off_cpu, S, k)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(got, again) and torch.equal(got.cpu(), want))
        ss_l = ss.long()
        np_ = ss_np.size
        _, counts = np.unique(ss_np[real], return_counts=True)
        out.append({
            "case": case, "name": name, "k": k, "positions": np_,
            "longest_run": int(max(counts.max(), np_ - int(real.sum()))), "bitwise": bitwise,
            "ms": _ms(kernel, reps),
            "library_ms": _ms(lambda: torch.zeros((S, k), device="cuda").index_add_(
                0, ss_l, d[:k].T), reps),
            "bound_ms": (S * k * 4 + k * np_ * 4 + np_ * 4) / PEAK_BYTES_PER_S * 1e3,
            "kernels_ms": _kernel_ms(kernel, reps),
        })
        print(f"# {case} {name} K={k}: {out[-1]['ms']:.4f} ms, zeros + index_add_ "
              f"{out[-1]['library_ms']:.4f}, bound {out[-1]['bound_ms']:.4f}, bitwise "
              f"{bitwise}; by kernel "
              f"{ {n: round(v, 4) for n, v in out[-1]['kernels_ms'].items()} }",
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
