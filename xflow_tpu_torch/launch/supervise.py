"""Supervised restart, after `xflow_tpu/launch/supervise.py`: the part the
serving fleet needs.

- `supervise(run_attempt, ...)` re-runs an attempt until it exits 0 or
  the restart budget (`max_restarts`) is spent, with exponential backoff
  and jitter between attempts. The attempt index is the restart
  generation: the fleet exports it to a relaunched replica as
  `XFLOW_RESTART_GEN`, stamped as `gen` into every record it writes.
- `min_uptime_s`: an attempt that dies faster than this is taken for a
  configuration error (a crash loop would burn every restart in
  seconds), and supervision stops with its exit code.

The training launchers' multi-rank wait, teardown and degraded-mode
supervision are not taken over (they come with the launch layer).
"""

from __future__ import annotations

import random
import sys
import time
from typing import Callable

BACKOFF_CAP_S = 60.0


def backoff_delay(attempt: int, base_s: float, rng=None) -> float:
    """base_s * 2^attempt capped at BACKOFF_CAP_S, scaled uniformly into
    [0.5, 1.0]x, so N restarted processes do not relaunch in lockstep."""
    d = min(float(base_s) * (2.0 ** max(int(attempt), 0)), BACKOFF_CAP_S)
    return d * (rng or random).uniform(0.5, 1.0)


def supervise(
    run_attempt: Callable[[int], int],
    max_restarts: int = 0,
    restart_backoff: float = 1.0,
    min_uptime_s: float = 0.0,
    label: str = "launch",
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    out=None,
) -> int:
    """Run `run_attempt(gen)` (gen 0 = the first launch) until it returns
    0 or the restart budget is spent; returns the last attempt's exit
    code. max_restarts=0 runs one attempt."""
    err = out or sys.stderr
    gen = 0
    while True:
        t0 = clock()
        rc = int(run_attempt(gen))
        uptime = clock() - t0
        if rc == 0:
            if gen:
                print(f"{label}: succeeded after {gen} restart(s)", file=err)
            return 0
        if gen >= max_restarts:
            if max_restarts > 0:
                print(f"{label}: restart budget exhausted ({max_restarts} restart(s)); "
                      f"giving up with rc={rc}", file=err)
            return rc
        if min_uptime_s > 0 and uptime < min_uptime_s:
            print(f"{label}: attempt {gen} died after {uptime:.1f}s (< min uptime "
                  f"{min_uptime_s:g} s): a configuration error, not a transient fault; "
                  "not restarting", file=err)
            return rc
        delay = backoff_delay(gen, restart_backoff)
        print(f"{label}: attempt {gen} exited rc={rc} after {uptime:.1f}s; restarting "
              f"generation {gen + 1} in {delay:.1f}s ({max_restarts - gen} restart(s) left)",
              file=err)
        sleep(delay)
        gen += 1
