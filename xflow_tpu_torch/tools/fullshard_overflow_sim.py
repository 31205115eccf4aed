"""Mesh-scale fullshard overflow accounting (host only, no devices), after
`xflow_tpu/tools/fullshard_overflow_sim.py`, with its numbers.

The fully-sharded engine sizes its per-(source, owner block) exchange
buffers as ``slack x uniform-hash expectation + one spare CHUNK``
(`parallel/sorted_fullshard.fullshard_capacity`). On skewed data a hot
key concentrates occurrences in ONE owner block, and when any buffer
overflows, the whole batch falls back, on every rank, to the row-major
sharded step (the trainer's one all_reduce(MAX) of the overflow flags).
A large mesh should know its expected fallback rate before production,
not discover it; this tool plans synthetic Zipf batches against
virtual owner-block grids and reports overflow rates per slack.

Why overflow is FUNDAMENTAL at high skew + many blocks, not a tuning
failure: a bounded power law with exponent alpha over N slots gives
the hottest slot a share p1 = 1/H(alpha, N) of ALL occurrences
(H the generalized harmonic number — e.g. alpha=1.05, N=2^24:
H~10.9 so p1~9%). Those occurrences all land in the hot slot's owner
block, so the needed slack is at least p1 x (D x T) x (occurrences
per source) / expectation = p1 x D x T: at D x T = 512 that is ~47x —
a 47x memory overprovision to never fall back. The engineering answer
at that scale is a modest slack that absorbs the TAIL (every block
whose load is near-uniform) plus the coordinated fallback for the
hot-head batches, whose rate this tool measures. The reference's
parameter server never dies on a hot key either; it serves it slowly
(its FTRL server, `src/optimizer/ftrl.h`).

Usage:
    python -m xflow_tpu_torch.tools.fullshard_overflow_sim [--quick]

Prints a markdown table plus one JSON line with the raw rates, the JAX
tool's output for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# ops/sorted_table.CHUNK and the capacity rule, mirrored so the tool
# imports neither torch nor the planner
CHUNK = 512


def capacity(slack: float, rows_src: int, nnz: int, d: int, t: int) -> int:
    expect = rows_src * nnz / (d * t)
    cap = int(np.ceil(slack * expect / CHUNK)) * CHUNK
    return max(cap, CHUNK) + CHUNK


_CDF_CACHE: dict = {}


def zipf_cdf(num_slots: int, alpha: float) -> np.ndarray:
    key = (num_slots, alpha)
    if key not in _CDF_CACHE:
        pmf = 1.0 / np.arange(1, num_slots + 1, dtype=np.float64) ** alpha
        _CDF_CACHE[key] = np.cumsum(pmf / pmf.sum())
    return _CDF_CACHE[key]


def zipf_slots(rng, num_slots: int, alpha: float, n: int) -> np.ndarray:
    """Bounded power-law ranks scrambled by a multiplicative bijection
    mod num_slots — frequency skew survives, index locality does not
    (bench.py draw_slots' scheme; hashed id streams have no locality)."""
    ranks = np.searchsorted(zipf_cdf(num_slots, alpha), rng.random(n))
    return ((ranks * 2654435761) % num_slots).astype(np.int64)


def batch_max_counts(
    rng, alpha: float, d: int, t: int, num_slots: int, rows_src: int,
    nnz: int, batches: int,
) -> np.ndarray:
    """[batches] max per-(source, owner) occurrence count. Each of the
    `d` source shards draws its own rows; owner block = slot //
    (num_slots / (d*t)) — the engine's block map. One pass serves every
    slack value (overflow ⇔ max count > slack budget)."""
    s_block = num_slots // (d * t)
    out = np.empty(batches, np.int64)
    for b in range(batches):
        mx = 0
        for _src in range(d):
            slots = zipf_slots(rng, num_slots, alpha, rows_src * nnz)
            mx = max(mx, int(np.bincount(slots // s_block,
                                         minlength=d * t).max()))
        out[b] = mx
    return out


def run(quick: bool = False) -> dict:
    num_slots = (1 << 20) if quick else (1 << 24)  # north-star per-pod shape
    nnz = 18  # Criteo-ish
    global_rows = 1 << 16
    batches = 3 if quick else 20
    slacks = [1.5, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
    grids = [(8, 1), (8, 8), (64, 8)]  # D*T = 8 / 64 / 512
    alphas = [1.05, 1.1, 1.3]
    rng = np.random.default_rng(0)
    rows = {}
    for alpha in alphas:
        for (d, t) in grids:
            rows_src = max(global_rows // d, 1024)
            mx = batch_max_counts(rng, alpha, d, t, num_slots, rows_src,
                                  nnz, batches)
            # the engine raises only when a block's REAL occurrences
            # exceed the FULL cap (fullshard_buffers clamps spans to
            # n_real first, so the spare CHUNK is usable headroom)
            rates = [
                float((mx > capacity(s, rows_src, nnz, d, t)).mean())
                for s in slacks
            ]
            rows[f"a{alpha}_dt{d * t}"] = {
                "rates": rates,
                # the slack that would have held every batch: the worst
                # buffer load over the trial vs the uniform expectation
                "needed_slack": round(
                    float(mx.max()) / (rows_src * nnz / (d * t)), 1
                ),
            }
    return {"slacks": slacks, "grids": [d * t for d, t in grids],
            "alphas": alphas, "rows": rows, "batches": batches,
            "num_slots": num_slots}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    res = run(args.quick)
    slacks = res["slacks"]
    print(
        "| skew \\ slack | "
        + " | ".join(str(s) for s in slacks)
        + " | needed |"
    )
    print("|---" * (len(slacks) + 2) + "|")
    for key, row in res["rows"].items():
        cells = " | ".join(f"{r:.0%}" for r in row["rates"])
        print(f"| {key} | {cells} | {row['needed_slack']} |")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
