"""The serving fleet, after `xflow_tpu/serve/fleet.py`: N supervised
replicas behind the failover router (`python -m xflow_tpu_torch
serve-fleet`). One fleet process owns:

- **N replica processes**, each `python -m xflow_tpu_torch serve
  --device <dev>` on its own fixed port, each in its own supervision
  loop (`launch/supervise.supervise`: restart budget, backoff with
  jitter, the min-uptime crash-loop stop). A killed replica relaunches
  with the next restart generation (`XFLOW_RESTART_GEN`) while the others
  serve: the client sees retries, not an outage.
- **The device.** Replicas run on `--device` (default `cuda`): each is
  its own process with its own CUDA context and its own copy of the
  tables on the card. A replica without a card exits 2, the startup gate
  fails, and the fleet exits 1; nothing falls back to the CPU. The fleet
  process itself imports no torch: it only routes.
- **Identity.** Replica k exports XFLOW_REPLICA=k, XFLOW_REPLICA_PORT,
  XFLOW_PROCESS_ID=k and XFLOW_NUM_PROCESSES=N under one XFLOW_RUN_ID,
  so each writes its own stamped `serve_replica<k>.jsonl` under
  `--run-dir`; the router writes `serve_router.jsonl` (rank -1).
- **Staggered reload.** Replica k exports XFLOW_RELOAD_STAGGER_S = k x
  serve.reload_stagger_s: a new checkpoint swaps through the fleet one
  replica at a time.
- **The router** (`serve/router.py`), in process, on the client-facing
  port.
- **Ordered drain.** SIGTERM drains the router first (stop admitting,
  finish what is in flight), then signals the replicas, each of which
  drains its own queue (`drain_fleet`).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Optional

from xflow_tpu_torch.config import Config

STARTUP_TIMEOUT_S = 600.0


def _free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def replica_env(base: dict, idx: int, port: int, run_id: str, gen: int, stagger_s: float,
                world: int = 1) -> dict:
    """The environment one replica attempt launches with: the fleet's
    identity and stagger contract. The device is the replica's
    `--device` flag, not the environment. A replica is a solo server, so
    no coordinator it might inherit forms a serve world."""
    env = dict(base)
    env.pop("XFLOW_COORDINATOR", None)
    env.update(
        XFLOW_RUN_ID=run_id,
        XFLOW_PROCESS_ID=str(idx),  # the rank stamp: a replica's stream keys apart
        XFLOW_NUM_PROCESSES=str(max(int(world), 1)),
        XFLOW_RESTART_GEN=str(gen),
        XFLOW_REPLICA=str(idx),
        XFLOW_REPLICA_PORT=str(port),
        XFLOW_RELOAD_STAGGER_S=str(idx * max(stagger_s, 0.0)),
    )
    return env


class ReplicaSupervisor:
    """One replica's supervision loop on its own thread. An attempt
    spawns `python -m xflow_tpu_torch serve ... --port <fixed>` with the
    fleet's environment, reads its ready line (the first JSON line on
    its stdout), and waits for it to exit. The port never changes across
    restarts, so the router's backend address stays valid: a rejoin is
    the health loop seeing /healthz answer again."""

    def __init__(self, idx: int, port: int, serve_args: list, run_id: str, stagger_s: float,
                 world: int = 1, max_restarts: int = 0, restart_backoff: float = 1.0,
                 min_uptime_s: float = 0.0, log_path: str = "", on_ready=None):
        self.idx = int(idx)
        self.port = int(port)
        self._serve_args = list(serve_args)
        self._run_id = run_id
        self._stagger_s = stagger_s
        self._world = world
        self._max_restarts = max_restarts
        self._restart_backoff = restart_backoff
        self._min_uptime_s = min_uptime_s
        self._log_path = log_path
        self._on_ready = on_ready
        self._proc: Optional[subprocess.Popen] = None
        self._proc_lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"xflow-fleet-replica{idx}")
        self.rc: Optional[int] = None
        self.generations = 0  # attempts launched (restarts = generations - 1)

    def start(self) -> None:
        self._thread.start()

    def _spawn(self, gen: int) -> subprocess.Popen:
        env = replica_env(os.environ, self.idx, self.port, self._run_id, gen, self._stagger_s,
                          world=self._world)
        cmd = [sys.executable, "-m", "xflow_tpu_torch", "serve", *self._serve_args,
               "--port", str(self.port)]
        # without a run dir the replica's stderr is the fleet's: a replica
        # that cannot start (no card, no checkpoint) says why
        log = open(self._log_path, "a") if self._log_path else None
        try:
            return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
        finally:
            if log is not None:
                log.close()  # the child holds its own descriptor

    def _attempt(self, gen: int) -> int:
        if self._stopping.is_set():
            return 0  # woken from a backoff by shutdown: no relaunch
        self.generations = gen + 1
        proc = self._spawn(gen)
        with self._proc_lock:
            self._proc = proc
        ready = None
        for line in proc.stdout:
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue  # stray non-JSON output is not a failed start
            if isinstance(parsed, dict):
                ready = parsed
                break
        # keep the pipe drained: a child blocked on a full pipe would look wedged
        threading.Thread(target=lambda f=proc.stdout: deque(f, maxlen=0), daemon=True,
                         name=f"xflow-fleet-replica{self.idx}-stdout").start()
        if ready and self._on_ready:
            self._on_ready(self.idx, gen, ready)
        rc = proc.wait()
        with self._proc_lock:
            self._proc = None
        # an exit during the fleet's shutdown is the shutdown, not a fault
        return 0 if self._stopping.is_set() else rc

    def _run(self) -> None:
        from xflow_tpu_torch.launch.supervise import supervise

        self.rc = supervise(
            self._attempt, max_restarts=self._max_restarts,
            restart_backoff=self._restart_backoff, min_uptime_s=self._min_uptime_s,
            label=f"serve-fleet replica {self.idx}",
            sleep=lambda s: self._stopping.wait(s),  # a backoff wakes on shutdown
        )

    def terminate(self, sig=signal.SIGTERM) -> None:
        """Stop supervising (no relaunch) and signal the live attempt."""
        self._stopping.set()
        with self._proc_lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(sig)
            except OSError:
                pass

    def join(self, timeout_s: float = 30.0) -> None:
        self._thread.join(timeout=timeout_s)
        with self._proc_lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()


def drain_fleet(router, supervisors, drain_timeout_s: float = 30.0, out=None) -> bool:
    """The shutdown order: (1) the router stops admitting and waits out
    every request in flight; (2) only then do the replicas get SIGTERM
    (each drains its own queue). A replica gone before its admitted
    request finished would turn a clean shutdown into 503s. Returns
    router.drain()'s verdict."""
    err = out or sys.stderr
    print("serve-fleet: draining router (stop admitting, finish in-flight)", file=err)
    drained = router.drain(timeout_s=drain_timeout_s)
    if not drained:
        print("serve-fleet: drain timeout: requests remained in flight", file=err)
    print("serve-fleet: stopping replicas", file=err)
    for sup in supervisors:
        sup.terminate()
    return drained


def _stop_all(supervisors, timeout_s: float = 10.0) -> None:
    for sup in supervisors:
        sup.terminate()
    for sup in supervisors:
        sup.join(timeout_s)


def fleet_main(cfg: Config, serve_args: list, run_dir: str = "", max_restarts: int = 0,
               restart_backoff: float = 1.0, min_uptime_s: float = 0.0, ready_out=None) -> int:
    """`python -m xflow_tpu_torch serve-fleet`: spawn N supervised
    replicas on ports picked here, wait until each has printed its ready
    line (else exit 1), start the router over them, print one ready line
    {serving, fleet, router_host, router_port, run_id, pid, replicas:
    [{replica, port, step, pid, device}]}, serve until SIGTERM/SIGINT,
    then drain router first and return 0."""
    from xflow_tpu_torch.jsonl import JsonlAppender
    from xflow_tpu_torch.launch.local import resolve_launch_run_id
    from xflow_tpu_torch.serve.lifecycle import wait_for_signal
    from xflow_tpu_torch.serve.router import Backend, CircuitBreaker, Router, \
        make_router_http_server
    from xflow_tpu_torch.tracing import Tracer

    scfg = cfg.serve
    n = int(scfg.replicas)
    if n < 1:
        print("serve-fleet: need >= 1 replica", file=sys.stderr)
        return 2
    run_id = resolve_launch_run_id()
    # the router's appender resolves run_id and world from the environment
    os.environ["XFLOW_RUN_ID"] = run_id
    os.environ["XFLOW_NUM_PROCESSES"] = str(n)
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)

    ports = [_free_port(scfg.host) for _ in range(n)]
    ready_info: dict = {}
    ready_lock, ready_evt = threading.Lock(), threading.Event()

    def on_ready(idx: int, gen: int, ready: dict) -> None:
        if gen > 0:
            print(f"serve-fleet: replica {idx} rejoined (restart generation {gen}, step "
                  f"{ready.get('step')})", file=sys.stderr)
        # the first ready line of each replica passes the startup gate,
        # whatever its generation
        with ready_lock:
            ready_info.setdefault(idx, ready)
            if len(ready_info) == n:
                ready_evt.set()

    supervisors = []
    for idx in range(n):
        args = list(serve_args)
        if run_dir:
            args += ["--metrics-path", os.path.join(run_dir, f"serve_replica{idx}.jsonl")]
        supervisors.append(ReplicaSupervisor(
            idx, ports[idx], args, run_id, stagger_s=scfg.reload_stagger_s, world=n,
            max_restarts=max_restarts, restart_backoff=restart_backoff,
            min_uptime_s=min_uptime_s,
            log_path=os.path.join(run_dir, f"replica{idx}.log") if run_dir else "",
            on_ready=on_ready))
    for sup in supervisors:
        sup.start()

    # the startup gate: every replica's ready line, or a supervisor that
    # gave up; a partial fleet does not serve
    deadline = time.monotonic() + STARTUP_TIMEOUT_S
    while not ready_evt.wait(0.2):
        if time.monotonic() > deadline or any(s.rc not in (None, 0) for s in supervisors):
            print("serve-fleet: replicas failed to start", file=sys.stderr)
            _stop_all(supervisors)
            return 1

    router_app = JsonlAppender(os.path.join(run_dir, "serve_router.jsonl") if run_dir else "",
                               stamp={"rank": -1, "run_id": run_id},
                               max_bytes=scfg.metrics_max_bytes)
    router = Router(
        [Backend(idx, scfg.host, ports[idx],
                 breaker=CircuitBreaker(fail_threshold=scfg.eject_failures,
                                        open_s=scfg.circuit_open_s))
         for idx in range(n)],
        deadline_ms=scfg.route_deadline_ms, retries=scfg.route_retries,
        hedge_ms=scfg.route_hedge_ms, health_poll_s=scfg.health_poll_s, appender=router_app,
        tracer=Tracer(router_app, sample_rate=scfg.trace_sample_rate,
                      slow_ms=scfg.trace_slow_ms))
    router.start()
    try:
        srv = make_router_http_server(router, scfg.host, max(scfg.port, 0))
    except Exception:
        # the router's port failed (in use): the replicas are processes of
        # their own and would outlive this one
        router.close()
        _stop_all(supervisors)
        raise
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    router.event("fleet_start", replicas=n, ports=ports, router_port=srv.server_address[1])

    ready = {
        "serving": True,
        "fleet": True,
        "router_host": srv.server_address[0],
        "router_port": srv.server_address[1],
        "run_id": run_id,
        "pid": os.getpid(),
        "replicas": [{"replica": idx, "port": ports[idx],
                      **{k: ready_info[idx].get(k) for k in ("step", "pid", "device")}}
                     for idx in range(n)],
    }
    print(json.dumps(ready), file=ready_out or sys.stdout, flush=True)

    def exhausted() -> Optional[int]:
        if all(s.rc is not None for s in supervisors):
            print("serve-fleet: all replica supervisors exhausted; shutting down",
                  file=sys.stderr)
            return max(s.rc or 0 for s in supervisors) or 1
        return None

    try:
        return wait_for_signal(exhausted) or 0
    finally:
        drain_fleet(router, supervisors)
        srv.shutdown()
        for sup in supervisors:
            sup.join(30.0)
        router.event("fleet_final")
        router.close()
        srv.server_close()
