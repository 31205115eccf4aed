"""The batch-shape ladder and the closed-loop SLO controller, a copy of
`xflow_tpu/serve/autotune.py`.

The ladder (`parse_ladder`, `pick_rung`): `serve.ladder` names the batch
shapes ("32,64,256"); each device batch is padded to the smallest rung
that fits, so a small batch does not pay for max_batch rows. The runner
warms every rung up before the ready line.

`AutotuneController` reads each flushed kind="serve" window and steers
the coalescer toward `serve.slo_p99_ms`:

- over the SLO with queue wait dominating: shrink `window_ms`;
- over the SLO with device time dominating: step the release rung down;
- under the SLO: restore a lowered rung first, then, with device time
  dominating, grow `window_ms`;
- inside the hysteresis band: no decision. Each direction reversal
  halves the knob's step, so the controller converges;
- asked to shrink below the window floor: pin there and emit one
  `floor_pinned` decision, then stay quiet until load turns.

A decision's knob is "window_ms" or "rung"; its reason one of
queue_dominated, device_dominated, device_headroom, rung_restore and
floor_pinned (the JAX package's vocabulary).

Clock-injectable and socket-free: the device worker feeds `observe()`
the windows `ServeMetrics.maybe_flush` returns and applies the
decisions; `/stats` serves `state()`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# damping never erases a knob's step: a later load change must move it
MIN_STEP_FRAC = 0.02


def parse_ladder(scfg) -> tuple:
    """`serve.ladder` ("16,64,256") -> ascending rungs. Rungs above
    `serve.max_batch` clamp to it, max_batch always joins as the top
    rung, "" = max_batch alone. Raises ValueError on a non-integer or
    non-positive rung."""
    top = int(scfg.max_batch)
    rungs = {top}
    text = str(scfg.ladder).strip()
    if text:
        for tok in text.split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                r = int(tok)
            except ValueError:
                raise ValueError(f"serve.ladder: rung {tok!r} is not an integer") from None
            if r <= 0:
                raise ValueError(f"serve.ladder: rung {r} must be >= 1")
            rungs.add(min(r, top))
    return tuple(sorted(rungs))


def pick_rung(n_rows: int, rungs: tuple) -> int:
    """The smallest rung that fits `n_rows`, else the top rung."""
    for r in rungs:
        if n_rows <= r:
            return r
    return rungs[-1]


@dataclass(frozen=True)
class Decision:
    """One knob move `old` -> `new` for `reason` (`old == new` only for
    the floor_pinned warning)."""

    knob: str
    old: float
    new: float
    reason: str


class AutotuneController:
    """The SLO controller. `observe(window)` -> [Decision] runs on the
    device worker; `state()` snapshots for `/stats` on handler threads
    (the lock covers that read). `clock` is injectable."""

    def __init__(self, scfg, rungs: Optional[tuple] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.slo_ms = float(scfg.slo_p99_ms)
        if self.slo_ms <= 0:
            raise ValueError(f"serve.slo_p99_ms={self.slo_ms}: the autotuner needs a "
                             "positive latency target")
        self.band_frac = max(float(scfg.autotune_band_frac), 0.0)
        self.min_window_ms = max(float(scfg.autotune_min_window_ms), 0.0)
        # a coalescing delay of the whole p99 budget is already too long
        self.max_window_ms = max(self.slo_ms, self.min_window_ms)
        self.rungs = tuple(rungs) if rungs else parse_ladder(scfg)
        self._clock = clock
        self._lock = threading.Lock()
        self.window_ms = float(scfg.window_ms)
        self.rung = self.rungs[-1]
        step0 = min(max(float(scfg.autotune_step_frac), MIN_STEP_FRAC), 0.9)
        self._step = {"window_ms": step0, "rung": step0}
        self._last_dir = {"window_ms": 0, "rung": 0}
        self._floor_warned = False
        self.windows_seen = 0
        self.decision_count = 0
        self._last_decision_t: Optional[float] = None

    def _damped(self, knob: str, direction: int) -> float:
        """The knob's step fraction: halved (floored) on a direction
        reversal, kept on a same-direction move."""
        prev = self._last_dir[knob]
        if prev != 0 and prev != direction:
            self._step[knob] = max(self._step[knob] * 0.5, MIN_STEP_FRAC)
        self._last_dir[knob] = direction
        return self._step[knob]

    def _rung_step(self, up: bool) -> Optional[Decision]:
        i = self.rungs.index(self.rung)
        j = i + 1 if up else i - 1
        if j < 0 or j >= len(self.rungs):
            return None
        old, self.rung = self.rung, self.rungs[j]
        self._damped("rung", 1 if up else -1)
        return Decision(knob="rung", old=float(old), new=float(self.rung),
                        reason="rung_restore" if up else "device_dominated")

    def observe(self, window: dict) -> list:
        """One flushed window record -> the decisions it justifies."""
        p99 = window.get("total_p99_ms")
        qw = window.get("queue_wait_p99_ms")
        dev = window.get("device_p99_ms")
        if p99 is None or qw is None or dev is None:
            return []
        with self._lock:
            self.windows_seen += 1
            decisions = self._steer_locked(float(p99), float(qw), float(dev))
            if decisions:
                self.decision_count += len(decisions)
                self._last_decision_t = self._clock()
            return decisions

    def _steer_locked(self, p99: float, qw: float, dev: float) -> list:
        hi = self.slo_ms * (1.0 + self.band_frac)
        lo = self.slo_ms * (1.0 - self.band_frac)
        if p99 > hi:
            if qw >= dev:
                return self._shrink_window_locked()
            d = self._rung_step(up=False)
            if d is not None:
                return [d]
            return self._shrink_window_locked()  # the bottom rung: the window is left
        if p99 < lo:
            if self.rung != self.rungs[-1]:
                d = self._rung_step(up=True)
                return [d] if d is not None else []
            if dev >= qw:
                return self._grow_window_locked()
        return []

    def _shrink_window_locked(self) -> list:
        if self.window_ms <= self.min_window_ms:
            if self._floor_warned:
                return []
            self._floor_warned = True
            v = self.window_ms
            return [Decision(knob="window_ms", old=v, new=v, reason="floor_pinned")]
        step = self._damped("window_ms", -1)
        old = self.window_ms
        self.window_ms = max(old * (1.0 - step), self.min_window_ms)
        return [Decision(knob="window_ms", old=old, new=self.window_ms,
                         reason="queue_dominated")]

    def _grow_window_locked(self) -> list:
        if self.window_ms >= self.max_window_ms:
            return []
        step = self._damped("window_ms", +1)
        old = self.window_ms
        self.window_ms = min(old * (1.0 + step), self.max_window_ms)
        self._floor_warned = False  # a new floor episode warns again
        return [Decision(knob="window_ms", old=old, new=self.window_ms,
                         reason="device_headroom")]

    def state(self) -> dict:
        """The controller's live state for `GET /stats`."""
        with self._lock:
            last = self._last_decision_t
            return {
                "slo_p99_ms": self.slo_ms,
                "band_frac": self.band_frac,
                "window_ms": round(self.window_ms, 4),
                "min_window_ms": self.min_window_ms,
                "rung": self.rung,
                "rungs": list(self.rungs),
                "windows_seen": self.windows_seen,
                "decisions": self.decision_count,
                "floor_pinned": self._floor_warned,
                "step_frac": {k: round(v, 4) for k, v in self._step.items()},
                "since_last_decision_s": (
                    round(self._clock() - last, 3) if last is not None else None
                ),
            }
