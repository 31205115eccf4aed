"""The process-wide metric registry, after the registry part of
`xflow_tpu/telemetry.py`: named counters, gauges and timers that the
server's telemetry increments and `GET /stats` snapshots. The trainer's
heartbeat, HBM gauges and compile accounting are not taken over.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np


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
