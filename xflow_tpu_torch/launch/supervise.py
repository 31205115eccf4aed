"""Supervised restart, after `xflow_tpu/launch/supervise.py`: the one
loop the training launchers and the serving fleet wrap their jobs in.

- `supervise(run_attempt, ...)` re-runs an attempt until it exits 0 or
  the restart budget (`max_restarts`) is spent, with exponential backoff
  and jitter between attempts. The attempt index is the restart
  generation: the launchers export it as `XFLOW_RESTART_GEN`, stamped as
  `gen` into every record. A training relaunch forces
  `train.resume=true` (`resume_forward_args`), so it restores the last
  committed checkpoint and its data_state.
- `min_uptime_s`: an attempt that dies faster than this is taken for a
  configuration error (a crash loop would burn every restart in
  seconds), and supervision stops with its exit code.
- `wait_fail_fast` is the launchers' one wait: the first rank that
  exits non-zero, or the watchdog's dead verdict (a wedged rank never
  exits), tears the whole world down (`terminate_procs`), since its
  peers would block in a collective forever.
- `DeadHostTracker`: with `--allow-shrink`, a dead verdict (a lost host,
  where a crashed process would have exited) shrinks the next attempt to
  the survivors; the elastic resume then covers the lost rank's shards.

- `retry_call(fn, ...)` calls `fn` with bounded backoff-spaced retries
  (the rendezvous of `parallel/distributed.py`).
"""

from __future__ import annotations

import random
import sys
import time
from typing import Callable, Optional

BACKOFF_CAP_S = 60.0
# the exit code of an attempt that only the watchdog's dead verdict
# failed (a wedged rank has no exit code of its own): EX_TEMPFAIL
EX_TEMPFAIL = 75


class DeadHostTracker:
    """The lost hosts of degraded-mode supervision (`--allow-shrink`).

    A rank that exits non-zero is a dead process on a live host: the
    relaunch keeps the world's shape. A watchdog dead or missing verdict
    (no heartbeat across the grace window) is a lost host: with
    `allow_shrink` the next attempt runs on the survivors, with the
    world size recomputed. `record` takes a label (a host for
    launch-dist, a (gen, rank) tag for launch-local's emulated slots);
    launch-dist `revive`s a host its probe reaches again. Off, every
    method leaves the shape alone."""

    def __init__(self, allow_shrink: bool = False):
        self.allow_shrink = bool(allow_shrink)
        self.lost: set = set()

    def record(self, label) -> None:
        if self.allow_shrink:
            self.lost.add(label)

    def attempt_recorder(self, labels: Optional[list] = None, gen: int = 0):
        """The watchdog's `on_dead` hook for one attempt. It records one
        loss: once a host wedges, its peers block in the next collective
        and go stale too, and the culprit ordering (lowest step first)
        makes the first verdict the lost host. `labels` maps the
        verdict's rank to a host (launch-dist); None tags it (gen, rank).
        Malformed or out-of-range ranks are ignored."""
        fired: list = []

        def on_dead(row: dict) -> None:
            r = row.get("rank")
            if fired or not isinstance(r, int) or r < 0:
                return
            if labels is None:
                fired.append(row)
                self.record((gen, r))
            elif r < len(labels):
                fired.append(row)
                self.record(labels[r])

        return on_dead

    def revive(self, label) -> None:
        self.lost.discard(label)

    def shrunk_world(self, total: int, floor: int = 1) -> int:
        """The next attempt's world: `total` less the lost, at least `floor`."""
        if not self.allow_shrink:
            return int(total)
        return max(int(total) - len(self.lost), int(floor))

    def survivors(self, items: list) -> list:
        """`items` less the lost labels, in order (the first survivor is
        rank 0 and the coordinator)."""
        if not self.allow_shrink:
            return list(items)
        return [x for x in items if x not in self.lost]


def backoff_delay(attempt: int, base_s: float, rng=None,
                  cap_s: float = BACKOFF_CAP_S) -> float:
    """base_s * 2^attempt capped at `cap_s`, scaled uniformly into
    [0.5, 1.0]x, so N restarted processes do not relaunch in lockstep."""
    d = min(float(base_s) * (2.0 ** max(int(attempt), 0)), float(cap_s))
    return d * (rng or random).uniform(0.5, 1.0)


def retry_call(
    fn: Callable,
    what: str,
    retries: int,
    base_s: float,
    cap_s: float = BACKOFF_CAP_S,
    cleanup: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    out=None,
):
    """`fn()` with up to `retries` backoff-spaced retries: each failure is
    logged with its reason and the delay, `cleanup` (when given) tears
    down what the failed call left between attempts, and the last
    failure propagates unchanged."""
    for attempt in range(max(int(retries), 0) + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — every failure retries; the last propagates
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, base_s, cap_s=cap_s)
            print(f"{what}: attempt {attempt + 1}/{retries + 1} failed "
                  f"({type(e).__name__}: {e}); retrying in {delay:.1f}s",
                  file=out or sys.stderr)
            if cleanup is not None:
                try:
                    cleanup()
                except Exception:  # noqa: BLE001 — a failed teardown must not mask the retry
                    pass
            sleep(delay)


def terminate_procs(procs, kill_after_s: float = 5.0) -> None:
    """SIGTERM every live process, then SIGKILL what is left after
    `kill_after_s` (a rank blocked in a collective never reaches a
    point where it would act on the TERM)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + kill_after_s
    while time.monotonic() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()


def wait_fail_fast(procs, teardown: Callable, dead_verdict=None, label: str = "launch",
                   grace_s: float = 0.0, poll_s: float = 0.2, out=None) -> int:
    """Poll the ranks until all exit. On the first non-zero exit, or the
    watchdog's verdict (`dead_verdict`, a threading.Event its on_dead
    policy sets), wait `grace_s` for the others' own error output, then
    `teardown(procs)`. Returns the first bad exit code (EX_TEMPFAIL for a
    verdict alone), or 0 when every rank exited clean."""
    first_bad = 0
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c]  # non-zero and not None
        if not first_bad and (bad or (dead_verdict is not None and dead_verdict.is_set())):
            first_bad = bad[0] if bad else EX_TEMPFAIL
            reason = (f"a rank exited with code {first_bad}" if bad
                      else "watchdog verdict: dead/missing rank")
            grace_note = f" in {grace_s:.0f}s" if grace_s > 0 else ""
            print(f"{label}: {reason}; terminating the remaining ranks{grace_note} (peers "
                  "would otherwise block in collectives forever)", file=out or sys.stderr)
            if grace_s > 0:
                deadline = time.monotonic() + grace_s
                while time.monotonic() < deadline and any(p.poll() is None for p in procs):
                    time.sleep(poll_s)
            teardown(procs)
        if all(c is not None for c in codes):
            return first_bad or next((c for c in codes if c), 0)
        time.sleep(poll_s)


def resume_forward_args(forward_args: list) -> list:
    """A relaunch's `train` argv: the original one with `train.resume=true`
    forced last, so it wins over a `--set train.resume=false` given."""
    return [*forward_args, "--set", "train.resume=true"]


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
