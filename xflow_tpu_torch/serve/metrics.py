"""Serve telemetry: kind="serve" JSONL windows and events, a copy of
`xflow_tpu/serve/metrics.py`.

Window records (one every `every_s`, only when traffic flowed) carry
requests/s, rows/s, the batch fill (rows over the padded rungs they
shipped at) and the latency decomposition: queue wait (the coalescing
delay), device (the worker's predict, readback included) and total
(submit to answer), p50 and p99. `generation`/`step` are the newest
pair this sink has recorded, a high-water mark shared with the event
path, so a window flushed after a reload event never stamps the pre-swap
pair. Event records ({"event": "start"|"reload"|"reload_failed"|
"brownout_enter"|"brownout_exit"|"final"}) mark the timeline.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from xflow_tpu_torch.jsonl import JsonlAppender
from xflow_tpu_torch.telemetry import Registry, default_registry

SERVE_WINDOW_KEYS = (
    "requests",
    "rows",
    "qps",
    "rows_per_s",
    "batches",
    "batch_fill",
    "queue_wait_p50_ms",
    "queue_wait_p99_ms",
    "device_p50_ms",
    "device_p99_ms",
    "total_p50_ms",
    "total_p99_ms",
    "window_s",
    "bad_requests",
    "shed_requests",
    "generation",
    "step",
)
# optional: present only while the served generation carries a
# publication sidecar (seconds from its newest ingested row to the flush)
SERVE_FRESHNESS_KEY = "data_freshness_s"


class ServeMetrics:
    """Thread-safe window aggregator over a JSONL sink: `observe_batch`
    runs on the device worker, `observe_bad_request`/`observe_shed` on
    handler threads, `event` on the watcher."""

    def __init__(self, path: str = "", every_s: float = 5.0, batch_size: int = 1,
                 registry: Optional[Registry] = None, max_bytes: int = 0):
        self._app = JsonlAppender(path, max_bytes=max_bytes)
        self._kind = {"kind": "serve"}
        self._every = max(float(every_s), 0.05)
        self._batch_size = max(int(batch_size), 1)
        self._reg = registry or default_registry()
        self._lock = threading.Lock()
        self._win_start = time.perf_counter()
        self._seen_gen = -1
        self._seen_step = -1
        self._reset_window_locked()

    @property
    def appender(self) -> JsonlAppender:
        """The stamped sink the tracer's spans share."""
        return self._app

    def _reset_window_locked(self) -> None:
        self._requests = 0
        self._rows = 0
        self._batches = 0
        self._capacity = 0  # the padded rungs the window's batches shipped at
        self._bad = 0
        self._shed = 0
        self._queue_waits: list = []
        self._device: list = []
        self._totals: list = []

    def observe_batch(self, n_requests: int, n_rows: int, queue_waits_s: list,
                      device_s: float, totals_s: list,
                      batch_size: Optional[int] = None) -> None:
        """`batch_size`: the padded rung this batch shipped at (None =
        the constructor's)."""
        with self._lock:
            self._requests += n_requests
            self._rows += n_rows
            self._batches += 1
            self._capacity += int(batch_size) if batch_size else self._batch_size
            self._queue_waits.extend(queue_waits_s)
            self._device.append(device_s)
            self._totals.extend(totals_s)
        self._reg.counter("serve.requests").inc(n_requests)
        self._reg.counter("serve.rows").inc(n_rows)
        self._reg.counter("serve.batches").inc()

    def observe_bad_request(self) -> None:
        with self._lock:
            self._bad += 1
        self._reg.counter("serve.bad_requests").inc()

    def observe_shed(self) -> None:
        """A brownout priority shed: the server's choice under load,
        counted apart from bad requests."""
        with self._lock:
            self._shed += 1
        self._reg.counter("serve.shed_requests").inc()

    def _advance_seen_locked(self, generation, step) -> tuple:
        """Fold (generation, step) into the high-water mark; the pair
        moves together, and within a generation the step never regresses."""
        if generation is not None and int(generation) > self._seen_gen:
            self._seen_gen = int(generation)
            self._seen_step = int(step) if step is not None else self._seen_step
        elif step is not None and int(generation or -1) == self._seen_gen:
            self._seen_step = max(self._seen_step, int(step))
        return self._seen_gen, self._seen_step

    def event(self, name: str, **extra) -> None:
        """Append an event record now, under the window lock (the fold
        and the append are one step relative to `maybe_flush`)."""
        with self._lock:
            self._advance_seen_locked(extra.get("generation"), extra.get("step"))
            self._app.append({**self._kind, "event": name, **extra})

    def maybe_flush(self, generation: int, step: int, force: bool = False,
                    freshness_s: Optional[float] = None) -> Optional[dict]:
        """Append a window record when the window elapsed (or `force`)
        and traffic flowed; returns it, else None."""
        now = time.perf_counter()
        with self._lock:
            elapsed = now - self._win_start
            if not force and elapsed < self._every:
                return None
            if self._batches == 0 and self._bad == 0 and self._shed == 0:
                self._win_start = now  # an idle window: nothing to say
                return None

            def pct(xs, q):
                return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 3) if xs else None

            rec = {
                **self._kind,
                "requests": self._requests,
                "rows": self._rows,
                "qps": round(self._requests / max(elapsed, 1e-9), 2),
                "rows_per_s": round(self._rows / max(elapsed, 1e-9), 1),
                "batches": self._batches,
                "batch_fill": round(self._rows / max(self._capacity, 1), 4),
                "queue_wait_p50_ms": pct(self._queue_waits, 50),
                "queue_wait_p99_ms": pct(self._queue_waits, 99),
                "device_p50_ms": pct(self._device, 50),
                "device_p99_ms": pct(self._device, 99),
                "total_p50_ms": pct(self._totals, 50),
                "total_p99_ms": pct(self._totals, 99),
                "window_s": round(elapsed, 3),
                "bad_requests": self._bad,
                "shed_requests": self._shed,
            }
            rec["generation"], rec["step"] = self._advance_seen_locked(generation, step)
            if freshness_s is not None:
                rec[SERVE_FRESHNESS_KEY] = round(max(float(freshness_s), 0.0), 3)
            self._reset_window_locked()
            self._win_start = now
            self._app.append(rec)
        self._reg.gauge("serve.qps").set(rec["qps"])
        if rec["batches"]:
            self._reg.gauge("serve.batch_fill").set(rec["batch_fill"])
        if freshness_s is not None:
            self._reg.gauge("serve.data_freshness_s").set(rec[SERVE_FRESHNESS_KEY])
        return rec

    def close(self, generation: int = -1, step: int = -1,
              freshness_s: Optional[float] = None) -> None:
        self.maybe_flush(generation, step, force=True, freshness_s=freshness_s)
        self._app.append({**self._kind, "event": "final"})
        self._app.close()
