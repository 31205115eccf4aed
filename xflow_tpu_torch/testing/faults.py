"""The serving chaos injectors, after `xflow_tpu/testing/faults.py`
(`serve_faults_from_env`, `hard_kill`). The training fault injectors
are not taken over."""

from __future__ import annotations

import os
import signal

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
