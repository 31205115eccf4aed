"""One host's multi-process launcher, after `xflow_tpu/launch/local.py`:
`launch-local` starts N `python -m xflow_tpu_torch train` processes
joined by a coordinator on 127.0.0.1, rank k reading `<prefix>-0000k`,
under the supervision loop (`launch/supervise.py`) and, with a run dir,
the liveness watchdog (`launch/watchdog.py`).

Each child gets the JAX package's environment: `XFLOW_COORDINATOR`,
`XFLOW_NUM_PROCESSES`, `XFLOW_PROCESS_ID`, `XFLOW_RUN_ID` (one id for
every rank and generation), `XFLOW_RESTART_GEN` and `XFLOW_ORIG_WORLD`
(the launch's first world, so a shrunk relaunch that has no data_state
yet still covers every shard).

One deliberate difference from the JAX launcher: JAX puts its children
on the CPU (`JAX_PLATFORMS=cpu` unless `XFLOW_LAUNCH_PLATFORM` says
otherwise), since every child landing on the host's one accelerator
would never form a world. The port's children take the `--device` in
the forwarded arguments, cuda by default: one card a rank over NCCL, and
a world larger than the host's cards raises with NCCL's reason
(`parallel/distributed.local_device`). `--device cpu` runs the world on
the CPU over gloo, the emulation the tests use.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

from xflow_tpu_torch.telemetry import new_run_id


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_metrics_args(run_dir: str, rank: int) -> list[str]:
    """`train` arguments that point rank `rank`'s records and heartbeat
    into the run dir, one file a rank a stream
    (`<run_dir>/metrics_rank<k>.jsonl`, `<run_dir>/heartbeat_rank<k>.jsonl`:
    what `tools/metrics_report.py` globs and the watchdog polls)."""
    if not run_dir:
        return []
    return ["--set", f"train.metrics_path={os.path.join(run_dir, f'metrics_rank{rank}.jsonl')}",
            "--set", f"train.heartbeat_path={os.path.join(run_dir, f'heartbeat_rank{rank}.jsonl')}"]


def resolve_launch_run_id() -> str:
    """The run id every process of this launch stamps: an exported
    XFLOW_RUN_ID, else a fresh one each launch (two launches from one
    process must not share an id, so not the process-cached
    `telemetry.resolve_run_id`)."""
    return new_run_id()


def _launch_local_once(num_processes: int, forward_args: list, port: int = 0,
                       run_dir: str = "", straggler_factor: float = 0.0,
                       dead_after_s: float = 0.0, watchdog_poll_s: float = 0.0,
                       run_id: str = "", gen: int = 0, on_dead_row=None,
                       orig_world: int = 0) -> int:
    """One attempt: start the ranks, watch them, return the job's exit
    code. The first non-zero exit, or the watchdog's dead verdict, tears
    every rank down (`wait_fail_fast`); `launch_local` decides on a
    relaunch."""
    from xflow_tpu_torch.launch.supervise import terminate_procs, wait_fail_fast

    port = port or _free_port()
    coordinator = f"127.0.0.1:{port}"
    watchdog = None
    dead_verdict = threading.Event()
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        from xflow_tpu_torch.launch.watchdog import RunWatchdog

        def on_dead(row):
            # the poller thread only sets the flag; teardown is the wait loop's
            if on_dead_row is not None:
                on_dead_row(row)
            dead_verdict.set()

        watchdog = RunWatchdog(run_dir, num_ranks=num_processes,
                               straggler_factor=straggler_factor, dead_after_s=dead_after_s,
                               poll_s=watchdog_poll_s, run_id=run_id, on_dead=on_dead, gen=gen)
        watchdog.start()
    procs = []
    try:
        for rank in range(num_processes):
            env = dict(os.environ)
            env.update(
                XFLOW_COORDINATOR=coordinator,
                XFLOW_NUM_PROCESSES=str(num_processes),
                XFLOW_ORIG_WORLD=str(orig_world or num_processes),
                XFLOW_PROCESS_ID=str(rank),
                XFLOW_RUN_ID=run_id,
                XFLOW_RESTART_GEN=str(gen),
            )
            cmd = [sys.executable, "-m", "xflow_tpu_torch", "train", *forward_args,
                   *rank_metrics_args(run_dir, rank)]
            procs.append(subprocess.Popen(cmd, env=env))
        return wait_fail_fast(procs, terminate_procs, dead_verdict=dead_verdict,
                              label="launch-local")
    except BaseException:
        terminate_procs(procs)
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()


def launch_local(num_processes: int, forward_args: list, port: int = 0, run_dir: str = "",
                 straggler_factor: float = 0.0, dead_after_s: float = 0.0,
                 watchdog_poll_s: float = 0.0, max_restarts: int = 0,
                 restart_backoff: float = 1.0, min_uptime_s: float = 0.0,
                 allow_shrink: bool = False) -> int:
    """The local world under the supervision loop: on a non-zero exit or
    a dead verdict the whole job is torn down and, while `max_restarts`
    lasts, relaunched with `train.resume=true` under the same run dir and
    run id, the generation stamped into every record. With
    `allow_shrink`, a dead verdict (the emulated lost host: a wedged
    rank) relaunches on the surviving rank count, ranks renumbered, and
    the elastic resume covers every shard."""
    from xflow_tpu_torch.launch.supervise import DeadHostTracker, resume_forward_args, supervise

    if forward_args and forward_args[0] == "--":
        forward_args = forward_args[1:]
    run_id = resolve_launch_run_id()
    tracker = DeadHostTracker(allow_shrink)

    def attempt(gen: int) -> int:
        n = tracker.shrunk_world(num_processes)
        if n < num_processes:
            print(f"launch-local: relaunching generation {gen} DEGRADED at {n}/{num_processes} "
                  f"rank(s) (--allow-shrink; {len(tracker.lost)} emulated host(s) lost)",
                  file=sys.stderr)
        args = forward_args if gen == 0 else resume_forward_args(forward_args)
        return _launch_local_once(n, args, port=port, run_dir=run_dir,
                                  straggler_factor=straggler_factor, dead_after_s=dead_after_s,
                                  watchdog_poll_s=watchdog_poll_s, run_id=run_id, gen=gen,
                                  on_dead_row=tracker.attempt_recorder(gen=gen),
                                  orig_world=num_processes)

    return supervise(attempt, max_restarts=max_restarts, restart_backoff=restart_backoff,
                     min_uptime_s=min_uptime_s, label="launch-local")
