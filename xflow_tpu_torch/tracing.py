"""Request-path tracing, a copy of `xflow_tpu/tracing.py`.

Every hop of a request appends `kind="span"` JSONL records through the
stamped appender, keyed by one trace id that travels in the
`X-Trace-Id` header and is echoed back to the client:

- **Deterministic head sampling.** `sampled(trace_id, rate)` hashes the
  trace id itself, so a router and every replica make the same
  keep/drop decision with no coordination; it keeps exactly the ids the
  JAX package's does. `serve.trace_sample_rate=0` turns tracing off.
- **Tail capture.** Spans buffer per trace and flush on the request's
  verdict (`finish(force=)`): errors, sheds and requests over
  `serve.trace_slow_ms` are always kept. `X-Trace-Force: 1` forces it.
- **Shared batch spans.** One device batch answers N requests: it is one
  `device_batch` span added to every member trace and emitted once.

Span record: {"kind": "span", "trace", "span", "parent" (absent on a
root), "name", "t0" (wall seconds), "dur_ms", ...attrs}. Durations are
perf_counter-measured; `t0` converts through one offset a process.
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from collections import OrderedDict
from typing import Iterable, Optional

TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"
FORCE_HEADER = "X-Trace-Force"


def new_id() -> str:
    """A fresh 16-hex trace/span id."""
    return uuid.uuid4().hex[:16]


def clean_id(value: Optional[str]) -> str:
    """A header-supplied id, sanitized: stripped, at most 64 characters
    of [A-Za-z0-9-_.] ('' = unusable): ids land verbatim in JSONL and in
    echoed headers."""
    if not value:
        return ""
    value = value.strip()
    if not value or len(value) > 64:
        return ""
    if not all(c.isalnum() or c in "-_." for c in value):
        return ""
    return value


def sampled(trace_id: str, rate: float) -> bool:
    """The head-sampling decision for one trace id, a pure function of
    the id: rate <= 0 never samples, >= 1 always does."""
    if rate <= 0:
        return False
    if rate >= 1:
        return True
    h = int(hashlib.sha1(trace_id.encode("utf-8", "replace")).hexdigest()[:8], 16)
    return h / float(1 << 32) < rate


class Tracer:
    """A span buffer a process and its sampling verdicts over one
    stamped appender; thread-safe. `span()`/`end()` (or `add()`) buffer
    records under their trace; `finish(trace, force=)` emits them
    (head-sampled or forced) or drops them. A span arriving after the
    verdict follows it. Pending traces and remembered verdicts are
    bounded, evicted oldest first."""

    def __init__(self, appender, sample_rate: float = 0.0, slow_ms: float = 250.0,
                 max_pending: int = 2048, max_verdicts: int = 8192):
        self._app = appender
        self.sample_rate = float(sample_rate)
        self.slow_s = max(float(slow_ms), 0.0) / 1e3
        self._max_pending = max(int(max_pending), 1)
        self._max_verdicts = max(int(max_verdicts), 1)
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, list]" = OrderedDict()
        self._verdicts: "OrderedDict[str, bool]" = OrderedDict()
        self._wall_off = time.time() - time.perf_counter()

    @property
    def enabled(self) -> bool:
        """Tracing is on iff the sample rate is positive."""
        return self.sample_rate > 0

    def wall(self, t_perf: float) -> float:
        return t_perf + self._wall_off

    def span(self, trace: str, name: str, parent: Optional[str] = None,
             t0: Optional[float] = None, **attrs) -> dict:
        """An open span: its id exists now; nothing is buffered until
        `end()`. `t0` is a perf_counter instant (default: now)."""
        s = {"trace": trace, "span": new_id(), "name": name,
             "_t0": time.perf_counter() if t0 is None else float(t0)}
        if parent:
            s["parent"] = parent
        s.update(attrs)
        return s

    def end(self, span: dict, t1: Optional[float] = None, **attrs) -> dict:
        """Close an open span and buffer its record; returns the record."""
        t1 = time.perf_counter() if t1 is None else float(t1)
        t0 = span.pop("_t0")
        rec = {"kind": "span", **span, **attrs, "t0": round(self.wall(t0), 6),
               "dur_ms": round(max(t1 - t0, 0.0) * 1e3, 3)}
        self.add(rec["trace"], rec)
        return rec

    def add(self, trace: str, rec: dict) -> None:
        """Buffer one finished span under its trace, or follow the
        trace's recorded verdict."""
        with self._lock:
            verdict = self._verdicts.get(trace)
            if verdict is None:
                self._pending.setdefault(trace, []).append(rec)
                while len(self._pending) > self._max_pending:
                    self._pending.popitem(last=False)
                return
        if verdict:
            self._emit(rec)

    def add_shared(self, rec: dict, traces: Iterable[str]) -> None:
        """Buffer one record (a device batch) under several traces; the
        first member trace to emit carries it, once."""
        rec["_shared"] = False
        for t in traces:
            self.add(t, rec)

    def _emit(self, rec: dict) -> None:
        if "_shared" in rec:
            with self._lock:
                if rec["_shared"]:
                    return
                rec["_shared"] = True
            rec = {k: v for k, v in rec.items() if k != "_shared"}
        self._app.append(rec)

    def finish(self, trace: str, force: bool = False) -> bool:
        """Deliver the trace's verdict: emit its buffered spans when
        head-sampled or `force`d, else drop them. Returns whether the
        trace was emitted."""
        emit = force or sampled(trace, self.sample_rate)
        with self._lock:
            spans = self._pending.pop(trace, [])
            self._verdicts[trace] = emit
            while len(self._verdicts) > self._max_verdicts:
                self._verdicts.popitem(last=False)
        if emit:
            for rec in spans:
                self._emit(rec)
        return emit

    def pending_traces(self) -> int:
        with self._lock:
            return len(self._pending)


def emit_op_span(appender, name: str, t0_wall: float, dur_s: float, **attrs) -> dict:
    """One operational span (a hot-reload swap, an autotune move),
    always emitted, under a fresh trace id of its own."""
    rec = {"kind": "span", "trace": new_id(), "span": new_id(), "name": name,
           "t0": round(t0_wall, 6), "dur_ms": round(max(dur_s, 0.0) * 1e3, 3), **attrs}
    appender.append(rec)
    return rec


def emit_linked_span(appender, name: str, t0_wall: float, dur_s: float, trace: str,
                     parent: Optional[str] = None, span: Optional[str] = None,
                     **attrs) -> dict:
    """An operational span carrying the caller's trace id: a published
    checkpoint's swap and first served batch continue the trainer's
    ingest trace, so the freshness path is one tree. Always emitted."""
    rec = {"kind": "span", "trace": trace, "span": span or new_id(), "name": name,
           "t0": round(t0_wall, 6), "dur_ms": round(max(dur_s, 0.0) * 1e3, 3), **attrs}
    if parent:
        rec["parent"] = parent
    appender.append(rec)
    return rec
