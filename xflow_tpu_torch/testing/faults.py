"""Fault injectors, after `xflow_tpu/testing/faults.py`: the serving
chaos injectors (`serve_faults_from_env`, `hard_kill`), the checkpoint
write fault (`ckpt_write_fault`), the fit loop's kill and pacing drills
(`kill_step_from_env`, `fit_delays_from_env`, `abort_after_step`) and
the multi-slice tier's (`sync_faults_from_env`). Each environment
injector is read once, when the run or the syncer starts; unset, none
costs anything a step. The corruption helpers are not taken over."""

from __future__ import annotations

import errno
import os
import signal
import time

from xflow_tpu_torch.telemetry import resolve_replica, resolve_restart_gen, resolve_slice


def _num(name: str, cast, default):
    try:
        return cast(os.environ.get(name, default) or default)
    except ValueError:
        return cast(default)


def kill_step_from_env(rank: int) -> int:
    """The 1-based step after which this rank SIGKILLs itself (0 = off),
    the supervised-restart drill:

    - XFLOW_FAULT_KILL_STEP: kill once that step completed, after its
      heartbeat and checkpoint cadence (a kill on a checkpoint step
      leaves that step committed);
    - XFLOW_FAULT_KILL_RANK: only this rank (default every rank);
    - XFLOW_FAULT_KILL_GEN (default 0): only in this restart generation,
      so the relaunch, which inherits the environment, survives.
    """
    try:
        step = int(os.environ.get("XFLOW_FAULT_KILL_STEP", 0) or 0)
    except ValueError:
        return 0
    if step <= 0:
        return 0
    r = os.environ.get("XFLOW_FAULT_KILL_RANK")
    if r is not None:
        try:
            if int(r) != rank:
                return 0
        except ValueError:
            return 0
    try:
        want_gen = int(os.environ.get("XFLOW_FAULT_KILL_GEN", 0) or 0)
    except ValueError:
        want_gen = 0
    return step if resolve_restart_gen() == want_gen else 0


def abort_after_step(trainer, step: int) -> None:
    """Make `trainer`'s training stream raise RuntimeError right after
    the batch of the 1-based step `step` (counted across epochs and
    fits) was taken, the in-process crash: checkpoints committed before
    it survive, so a resume runs the data_state path."""
    orig = trainer._train_feed
    counter = [0]

    def wrapped(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            counter[0] += 1
            if counter[0] >= step:
                raise RuntimeError(f"injected abort after step {counter[0]} "
                                   "(testing/faults.abort_after_step)")

    trainer._train_feed = wrapped


def fit_delays_from_env(rank: int) -> tuple[float, int, float]:
    """(per_step_sleep_s, stall_step, stall_s) for this rank, the
    straggler drill:

    - XFLOW_FAULT_STEP_DELAY_S: sleep this long before every step;
    - XFLOW_FAULT_STALL_S (+ XFLOW_FAULT_STALL_STEP, default 1): sleep
      once, after that 1-based step;
    - XFLOW_FAULT_DELAY_RANK: only this rank (default every rank).
    """
    r = os.environ.get("XFLOW_FAULT_DELAY_RANK")
    if r is not None:
        try:
            if int(r) != rank:
                return 0.0, 0, 0.0
        except ValueError:
            return 0.0, 0, 0.0
    delay = float(os.environ.get("XFLOW_FAULT_STEP_DELAY_S", 0) or 0)
    stall = float(os.environ.get("XFLOW_FAULT_STALL_S", 0) or 0)
    stall_step = int(os.environ.get("XFLOW_FAULT_STALL_STEP", 1) or 1)
    return delay, stall_step, stall


def sync_faults_from_env() -> tuple[int, float]:
    """(kill_round, sync_delay_s) of this slice's sync tier, read once
    when its `SliceSyncer` is built:

    - XFLOW_FAULT_SLICE_KILL_ROUND: SIGKILL the slice as it enters that
      1-based round, before its delta publishes (the slice-loss drill);
    - XFLOW_FAULT_SYNC_DELAY_S: sleep this long in every round (a
      straggling slice);
    - XFLOW_FAULT_SLICE: only the slice of this index (XFLOW_SLICE);
      XFLOW_FAULT_SLICE_KILL_SLICE / XFLOW_FAULT_SYNC_DELAY_SLICE
      override it for one injector;
    - XFLOW_FAULT_SLICE_KILL_GEN (default 0): kill only in this restart
      generation, so the relaunched slice rejoins.
    """

    def targeted(var: str) -> bool:
        target = os.environ.get(var, os.environ.get("XFLOW_FAULT_SLICE"))
        if target is None:
            return True
        try:
            return int(target) == resolve_slice()
        except (ValueError, TypeError):
            return False

    kill = (_num("XFLOW_FAULT_SLICE_KILL_ROUND", int, 0)
            if targeted("XFLOW_FAULT_SLICE_KILL_SLICE") else 0)
    delay = (_num("XFLOW_FAULT_SYNC_DELAY_S", float, 0.0)
             if targeted("XFLOW_FAULT_SYNC_DELAY_SLICE") else 0.0)
    if kill > 0 and resolve_restart_gen() != _num("XFLOW_FAULT_SLICE_KILL_GEN", int, 0):
        kill = 0
    return max(kill, 0), max(delay, 0.0)


def hard_kill() -> None:
    """SIGKILL this process: no atexit, no finally, no flush beyond what
    is on disk, as a host that is preempted or killed for memory."""
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except OSError:
        pass
    os._exit(137)


def serve_faults_from_env() -> tuple[float, int]:
    """(per_batch_delay_s, kill_after_batches) for this serve process,
    read once when the `ServeApp` is built (no cost a batch when unset):

    - XFLOW_FAULT_SERVE_DELAY_S: sleep this long before every device
      batch (a persistently slow replica);
    - XFLOW_FAULT_SERVE_KILL_BATCHES: SIGKILL the process right after the
      Nth answered batch (a replica dying under load);
    - XFLOW_FAULT_SERVE_REPLICA: only the fleet replica of this index
      (XFLOW_REPLICA) injects; unset = every process;
    - XFLOW_FAULT_SERVE_KILL_GEN (default 0): kill only in this restart
      generation, so the supervised relaunch, which inherits the
      environment, survives and rejoins.
    """

    target = os.environ.get("XFLOW_FAULT_SERVE_REPLICA")
    if target is not None:
        try:
            if int(target) != resolve_replica():
                return 0.0, 0
        except ValueError:
            return 0.0, 0
    delay = _num("XFLOW_FAULT_SERVE_DELAY_S", float, 0.0)
    kill = _num("XFLOW_FAULT_SERVE_KILL_BATCHES", int, 0)
    if kill > 0 and resolve_restart_gen() != _num("XFLOW_FAULT_SERVE_KILL_GEN", int, 0):
        kill = 0
    return max(delay, 0.0), max(kill, 0)


def ckpt_write_fault(tier: str):
    """The disk-fault seam of checkpoint writes, for the async tiered
    drills: a callback `fault(tmp_path)` the writer calls on each staged
    temp file just before its commit rename, or None when no fault is
    armed. Resolved once a save a tier, so the ENOSPC budget is a
    save's, not the run's.

    - XFLOW_FAULT_CKPT_ENOSPC_BYTES: once the save's staged bytes pass
      this budget, raise OSError(ENOSPC), a volume filling mid-write;
    - XFLOW_FAULT_CKPT_SLOW_S_PER_MB: sleep size/1e6 * this a staged
      file, a slow disk that holds a save in flight;
    - XFLOW_FAULT_CKPT_TIER: only "primary" or "replica" (default both).
    """
    target = os.environ.get("XFLOW_FAULT_CKPT_TIER")
    if target is not None and target != tier:
        return None

    enospc = _num("XFLOW_FAULT_CKPT_ENOSPC_BYTES", int, 0)
    slow = _num("XFLOW_FAULT_CKPT_SLOW_S_PER_MB", float, 0.0)
    if enospc <= 0 and slow <= 0:
        return None
    written = {"bytes": 0}

    def fault(tmp_path: str) -> None:
        size = os.path.getsize(tmp_path)
        if slow > 0:
            time.sleep(size / 1e6 * slow)
        written["bytes"] += size
        if 0 < enospc < written["bytes"]:
            raise OSError(errno.ENOSPC, "injected ENOSPC (XFLOW_FAULT_CKPT_ENOSPC_BYTES)",
                          tmp_path)

    return fault
