"""The multi-machine launcher, after `xflow_tpu/launch/dist.py`:
`launch-dist` starts one `python -m xflow_tpu_torch train` a host over
ssh, under the supervision loop.

    python -m xflow_tpu_torch launch-dist --hosts hosts.txt -- \
        --train /data/train --model fm ...

- `hosts.txt`: one host a line (`user@host` allowed), `#` comments. The
  first host is rank 0 and the coordinator.
- Each rank gets the `XFLOW_*` contract (`parallel/distributed.py`):
  `XFLOW_COORDINATOR=<host0>:<port>`, `XFLOW_NUM_PROCESSES=N`,
  `XFLOW_PROCESS_ID=k`, and every rank and generation one
  `XFLOW_RUN_ID`, `XFLOW_ORIG_WORLD` and `XFLOW_RESTART_GEN`.
- `--workdir` may hold `{rank}` and `{host}`; `--env K=V` adds to the
  environment; `--ssh-cmd` swaps the remote runner.
- `--dry-run` prints each host's command line instead of running it.

Like the JAX launcher it sets no platform: each machine's ranks take the
forwarded `--device` (cuda by default, one card a rank over NCCL).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading


def parse_hosts(path: str) -> list[str]:
    """A hosts file's hosts, in order: one a line (`user@host` allowed),
    blank lines and `#` comments ignored. The first is rank 0."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line.split()[0])
    if not hosts:
        raise ValueError(f"hosts file {path!r} lists no hosts")
    return hosts


def rank_command(host: str, rank: int, hosts: list, forward_args: list, port: int,
                 workdir: str = "", python: str = "", env_extra: dict | None = None,
                 run_dir: str = "") -> str:
    """The shell line rank `rank` runs on `host` (what `--dry-run`
    prints). `run_dir`, a remote path, takes the rank's records and
    heartbeat (`launch/local.rank_metrics_args`).

    The line wraps the rank so that it dies with its ssh connection: ssh
    without a tty does not signal the remote command when the client
    dies, and a rank blocked in a collective would outlive a teardown.
    The launcher holds the client's stdin open and never writes it; the
    watcher's `read` returns when that pipe closes (the client exits, is
    killed, or the network drops) and then TERMs, and 5 s later KILLs,
    the rank's process group (or the rank itself on shells without job
    control). A rank that ends on its own keeps its exit status."""
    from xflow_tpu_torch.launch.local import rank_metrics_args

    coordinator_host = hosts[0].rsplit("@", 1)[-1]
    env = {
        "XFLOW_COORDINATOR": f"{coordinator_host}:{port}",
        "XFLOW_NUM_PROCESSES": str(len(hosts)),
        "XFLOW_PROCESS_ID": str(rank),
        **(env_extra or {}),
    }
    forward_args = [*forward_args, *rank_metrics_args(run_dir, rank)]
    py = python or "python3"
    parts = []
    if workdir:
        wd = workdir.format(rank=rank, host=host.rsplit("@", 1)[-1])
        parts.append(f"mkdir -p {shlex.quote(wd)} && cd {shlex.quote(wd)}")
    parts.append(" ".join([*(f"{k}={shlex.quote(v)}" for k, v in env.items()),
                           py, "-m", "xflow_tpu_torch", "train",
                           *(shlex.quote(a) for a in forward_args)]))
    inner = " && ".join(parts)
    return (
        f"exec 3<&0; set -m 2>/dev/null; ( {inner} ) & xfp=$!; set +m 2>/dev/null; "
        "{ while read -r xfl; do :; done; "
        "kill -TERM -- -$xfp 2>/dev/null; kill -TERM $xfp 2>/dev/null; sleep 5; "
        "kill -KILL -- -$xfp 2>/dev/null; kill -KILL $xfp 2>/dev/null; } <&3 & "
        "xfw=$!; wait $xfp; xfs=$?; kill $xfw 2>/dev/null; exit $xfs"
    )


def probe_host(host: str, ssh_cmd: str = "ssh", timeout_s: float = 10.0) -> bool:
    """Whether `<ssh_cmd> host true` succeeds within `timeout_s`: a lost
    host that answers again rejoins at the next relaunch."""
    try:
        r = subprocess.run([*shlex.split(ssh_cmd), host, "true"], stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL,
                           timeout=timeout_s)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def launch_dist(hosts: list, forward_args: list, port: int = 29431, ssh_cmd: str = "ssh",
                workdir: str = "", python: str = "", env_extra: dict | None = None,
                dry_run: bool = False, run_dir: str = "", straggler_factor: float = 0.0,
                dead_after_s: float = 0.0, watchdog_poll_s: float = 0.0, max_restarts: int = 0,
                restart_backoff: float = 1.0, min_uptime_s: float = 0.0,
                allow_shrink: bool = False) -> int:
    """One rank a host over ssh, under the supervision loop: an attempt
    (`_launch_dist_once`) fails fast on the first non-zero exit or dead
    verdict, and with `max_restarts` the whole job relaunches on the same
    hosts, run id and run dir with `train.resume=true`, the generation in
    `XFLOW_RESTART_GEN`. With `allow_shrink` a dead verdict marks its
    host lost and the relaunch runs on the survivors (the first is rank 0);
    a lost host that answers `probe_host` again rejoins."""
    from xflow_tpu_torch.launch.local import resolve_launch_run_id
    from xflow_tpu_torch.launch.supervise import DeadHostTracker, resume_forward_args, supervise

    if forward_args and forward_args[0] == "--":
        forward_args = forward_args[1:]
    env_extra = dict(env_extra or {})
    env_extra.setdefault("XFLOW_RUN_ID", resolve_launch_run_id())
    env_extra.setdefault("XFLOW_ORIG_WORLD", str(len(hosts)))
    if dry_run:
        return _launch_dist_once(hosts, forward_args, port=port, ssh_cmd=ssh_cmd,
                                 workdir=workdir, python=python, env_extra=env_extra,
                                 dry_run=True, run_dir=run_dir)
    tracker = DeadHostTracker(allow_shrink)

    def attempt(gen: int) -> int:
        for lost in sorted(tracker.lost):
            if probe_host(lost, ssh_cmd=ssh_cmd):
                print(f"launch-dist: lost host {lost} answers again; rejoining the world at "
                      f"generation {gen}", file=sys.stderr)
                tracker.revive(lost)
        alive = tracker.survivors(hosts) or hosts[:1]
        if len(alive) < len(hosts):
            print(f"launch-dist: relaunching generation {gen} DEGRADED on "
                  f"{len(alive)}/{len(hosts)} host(s) (--allow-shrink; lost: "
                  f"{', '.join(sorted(tracker.lost))}); rank 0 = {alive[0]}", file=sys.stderr)
        args = forward_args if gen == 0 else resume_forward_args(forward_args)
        env_gen = {**env_extra, "XFLOW_RESTART_GEN": str(gen)}
        return _launch_dist_once(alive, args, port=port, ssh_cmd=ssh_cmd, workdir=workdir,
                                 python=python, env_extra=env_gen, run_dir=run_dir,
                                 straggler_factor=straggler_factor, dead_after_s=dead_after_s,
                                 watchdog_poll_s=watchdog_poll_s, gen=gen,
                                 on_dead_row=tracker.attempt_recorder(labels=alive))

    return supervise(attempt, max_restarts=max_restarts, restart_backoff=restart_backoff,
                     min_uptime_s=min_uptime_s, label="launch-dist")


def _launch_dist_once(hosts: list, forward_args: list, port: int = 29431, ssh_cmd: str = "ssh",
                      workdir: str = "", python: str = "", env_extra: dict | None = None,
                      dry_run: bool = False, run_dir: str = "", straggler_factor: float = 0.0,
                      dead_after_s: float = 0.0, watchdog_poll_s: float = 0.0, gen: int = 0,
                      on_dead_row=None) -> int:
    """One attempt: one rank a host over ssh, waited for together. The
    first non-zero exit, or the watchdog's verdict, terminates the rest
    after a 10 s grace for their own error output, and its code returns.
    Rank 0 starts last, so the workers' connects never wait on a slow
    host's start."""
    from xflow_tpu_torch.launch.supervise import terminate_procs, wait_fail_fast

    env_extra = dict(env_extra or {})
    cmds = [rank_command(h, i, hosts, forward_args, port, workdir, python, env_extra,
                         run_dir=run_dir) for i, h in enumerate(hosts)]
    if dry_run:
        for i, (h, c) in enumerate(zip(hosts, cmds)):
            print(f"# rank {i} on {h}:")
            print(f"{ssh_cmd} {h} {shlex.quote(c)}")
        return 0
    watchdog = None
    dead_verdict = threading.Event()
    if run_dir:
        try:
            os.makedirs(run_dir, exist_ok=True)
        except OSError as e:
            print(f"launch-dist: cannot create run dir {run_dir!r} locally ({e}); live "
                  "watchdog disabled — run `tools/metrics_report.py --health` on the "
                  "collected files afterwards", file=sys.stderr)
    if run_dir and os.path.isdir(run_dir):
        # the run dir is visible here (a shared filesystem): watch the beats
        from xflow_tpu_torch.launch.watchdog import RunWatchdog

        def on_dead(row):
            if on_dead_row is not None:
                on_dead_row(row)
            dead_verdict.set()

        watchdog = RunWatchdog(run_dir, num_ranks=len(hosts), straggler_factor=straggler_factor,
                               dead_after_s=dead_after_s, poll_s=watchdog_poll_s,
                               run_id=env_extra.get("XFLOW_RUN_ID", ""), on_dead=on_dead,
                               gen=gen)
        watchdog.start()
    procs = []

    def teardown(procs):
        # closing stdin fires each remote watcher; then TERM, then KILL
        for p in procs:
            if p.stdin:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        terminate_procs(procs)

    try:
        for i in reversed(range(len(hosts))):
            # stdin held open and never written: its EOF is the rank's death signal
            procs.append(subprocess.Popen([*shlex.split(ssh_cmd), hosts[i], cmds[i]],
                                          stdin=subprocess.PIPE))
        return wait_fail_fast(procs, teardown, dead_verdict=dead_verdict, label="launch-dist",
                              grace_s=10.0, poll_s=0.5)
    except BaseException:
        teardown(procs)
        for p in procs:
            p.wait()
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()
