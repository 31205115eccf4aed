"""Fault injectors, after `xflow_tpu/testing/faults.py`: the serving
chaos injectors (`serve_faults_from_env`, `hard_kill`) and the
checkpoint write fault (`ckpt_write_fault`). The trainer's kill and
pacing injectors and the corruption helpers are not taken over."""

from __future__ import annotations

import errno
import os
import signal
import time

from xflow_tpu_torch.telemetry import resolve_replica, resolve_restart_gen


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

    def num(name: str, cast, default):
        try:
            return cast(os.environ.get(name, default) or default)
        except ValueError:
            return cast(default)

    target = os.environ.get("XFLOW_FAULT_SERVE_REPLICA")
    if target is not None:
        try:
            if int(target) != resolve_replica():
                return 0.0, 0
        except ValueError:
            return 0.0, 0
    delay = num("XFLOW_FAULT_SERVE_DELAY_S", float, 0.0)
    kill = num("XFLOW_FAULT_SERVE_KILL_BATCHES", int, 0)
    if kill > 0 and resolve_restart_gen() != num("XFLOW_FAULT_SERVE_KILL_GEN", int, 0):
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

    def num(name: str, cast, default):
        try:
            return cast(os.environ.get(name, default) or default)
        except ValueError:
            return cast(default)

    enospc = num("XFLOW_FAULT_CKPT_ENOSPC_BYTES", int, 0)
    slow = num("XFLOW_FAULT_CKPT_SLOW_S_PER_MB", float, 0.0)
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
