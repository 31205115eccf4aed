"""The process-wide metric registry and the record stamp's identity,
after `xflow_tpu/telemetry.py`: named counters, gauges and timers that
the server's telemetry increments and `GET /stats` snapshots, and the
`resolve_*` functions that read a process's identity from the launcher's
environment (`XFLOW_RUN_ID`, `XFLOW_PROCESS_ID`, `XFLOW_RESTART_GEN`,
`XFLOW_NUM_PROCESSES`, `XFLOW_REPLICA`, `XFLOW_REPLICA_PORT`; the
serving fleet exports them to every replica). Unset, a process is rank
0 of a world of 1, generation 0, outside a fleet. The trainer's
heartbeat, HBM gauges and compile accounting are not taken over.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

import numpy as np

_RUN_ID: Optional[str] = None


def _env_int(name: str) -> Optional[int]:
    """An integer environment variable, or None when unset or unparseable."""
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def new_run_id() -> str:
    """A fresh launch-scoped id, or the exported XFLOW_RUN_ID."""
    return os.environ.get("XFLOW_RUN_ID") or uuid.uuid4().hex[:12]


def resolve_run_id() -> str:
    """XFLOW_RUN_ID when a launcher exported it, else one random id a
    process (cached, so every sink of the process stamps the same id)."""
    global _RUN_ID
    rid = os.environ.get("XFLOW_RUN_ID")
    if rid:
        return rid
    if _RUN_ID is None:
        _RUN_ID = new_run_id()
    return _RUN_ID


def resolve_rank() -> int:
    """XFLOW_PROCESS_ID, else 0 (the port runs one process)."""
    rank = _env_int("XFLOW_PROCESS_ID")
    return 0 if rank is None else rank


def resolve_restart_gen() -> int:
    """The supervised restart generation (XFLOW_RESTART_GEN), else 0."""
    return _env_int("XFLOW_RESTART_GEN") or 0


def resolve_world_size() -> int:
    """XFLOW_NUM_PROCESSES when positive, else 1 (a fleet's world is its
    replica count)."""
    n = _env_int("XFLOW_NUM_PROCESSES")
    return n if n and n > 0 else 1


def resolve_replica() -> Optional[int]:
    """This serving replica's index (XFLOW_REPLICA), or None outside a fleet."""
    return _env_int("XFLOW_REPLICA")


def resolve_replica_port() -> Optional[int]:
    """The port the fleet gave this replica (XFLOW_REPLICA_PORT), stable
    across its restarts, or None outside a fleet."""
    return _env_int("XFLOW_REPLICA_PORT")


class Counter:
    """A monotonically increasing count, thread-safe."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc({n}): counters are monotone, use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """The last value set."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Timer:
    """Durations: run totals (`count`, `total_s`) and a window of the
    newest WINDOW_CAP observations that `percentile` reads and
    `window_reset` clears."""

    WINDOW_CAP = 8192

    __slots__ = ("_lock", "count", "total_s", "_window")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total_s = 0.0
        self._window: deque = deque(maxlen=self.WINDOW_CAP)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += float(seconds)
            self._window.append(float(seconds))

    def timing(self):
        timer = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.observe(time.perf_counter() - self._t0)
                return False

        return _Ctx()

    def percentile(self, q: float) -> float:
        """The q-th percentile (0..100) of the window; NaN when empty."""
        with self._lock:
            if not self._window:
                return float("nan")
            return float(np.percentile(np.asarray(self._window), q))

    def window_reset(self) -> list:
        """Return and clear the window's observations."""
        with self._lock:
            out = list(self._window)
            self._window.clear()
            return out


class Registry:
    """Create-or-get named metrics in one flat namespace; a name keeps
    its kind (asking for a counter where a gauge lives raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(f"telemetry metric {name!r} is a {type(m).__name__}, "
                                f"not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def snapshot(self) -> dict:
        """{name: value}: counters and gauges by value, timers as
        `<name>.count` and `<name>.total_s` (run totals)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for name, m in items:
            if isinstance(m, Timer):
                out[f"{name}.count"] = m.count
                out[f"{name}.total_s"] = round(m.total_s, 6)
            else:
                out[name] = m.value
        return out


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry the serve counters and `/stats` share."""
    return _DEFAULT
