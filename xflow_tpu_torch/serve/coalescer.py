"""Request microbatching: the coalescing window, a copy of
`xflow_tpu/serve/coalescer.py`.

One padded batch on the card costs about what a one-row batch does, so
per-request dispatch wastes it. The MicroBatcher queues concurrent
requests and releases them as one group when the queued rows reach the
release rung (size flush) or the oldest queued request has waited
`window_s` (deadline flush): an idle server adds at most one window of
latency and a busy one fills its batches.

Requests stay whole: a group never splits a request across two batches
(its rows would otherwise answer at two generations mid-swap). A
request larger than `max_rows` is rejected at submit.

Socket-free and clock-injectable: the HTTP layer (`serve/server.py`)
calls `submit`, the device worker calls `take`, and the tests drive both
with a fake clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

from xflow_tpu_torch.data.schema import make_batch


class RejectedRequest(Exception):
    """A request the coalescer will not queue. `client_error`: the
    client's mistake (empty or oversized: 400, do not retry unchanged);
    else load shedding (backlog full, brownout shed, shutting down: 503,
    retry later). `shed` marks a brownout priority shed, counted apart
    from the backlog cliff."""

    def __init__(self, message: str, client_error: bool = False, shed: bool = False):
        super().__init__(message)
        self.client_error = client_error
        self.shed = shed


@dataclass(frozen=True)
class BrownoutPolicy:
    """Admission control before the hard `max_queue_rows` cliff: a
    backlog >= `high_rows` sustained `after_s` enters brownout (the
    window shrinks by `window_factor`, low-priority submits shed with a
    retryable 503); a backlog <= `low_rows` sustained `after_s` exits.
    The band and the sustain window keep a bursty backlog from flapping
    the mode."""

    high_rows: int
    low_rows: int
    after_s: float = 0.25
    window_factor: float = 0.25

    @staticmethod
    def from_config(scfg) -> "BrownoutPolicy":
        q = int(scfg.max_queue_rows)
        return BrownoutPolicy(
            high_rows=max(int(q * scfg.brownout_high_frac), 1),
            low_rows=max(int(q * scfg.brownout_low_frac), 0),
            after_s=float(scfg.brownout_after_s),
            window_factor=float(scfg.brownout_window_factor),
        )


@dataclass
class PendingRequest:
    """One queued request: ragged rows awaiting a device batch, and the
    trace id and server span id its queue/device spans link to ("" =
    untraced)."""

    fields: list  # per-row int32 arrays
    slots: list  # per-row int32 arrays
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0
    priority: int = 0  # < 0 = sheddable under brownout
    trace: str = ""
    span: str = ""

    @property
    def num_rows(self) -> int:
        return len(self.slots)


class MicroBatcher:
    def __init__(
        self,
        max_rows: int,
        window_s: float,
        max_queue_rows: int = 8192,
        clock: Callable[[], float] = time.perf_counter,
        brownout: Optional[BrownoutPolicy] = None,
        on_brownout: Optional[Callable[[bool, int], None]] = None,
    ):
        if max_rows <= 0:
            raise ValueError(f"max_rows={max_rows}: need >= 1")
        self.max_rows = int(max_rows)
        self.window_s = float(window_s)
        # the rows that trigger a size flush and cap a group (the active
        # ladder rung, which the autotuner moves); the per-request cap
        # stays max_rows
        self._release_rows = int(max_rows)
        self.max_queue_rows = int(max_queue_rows)
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()
        self._queued_rows = 0
        self._closed = False
        # None = no brownout (the cliff only); `on_brownout(active,
        # queued_rows)` runs outside the lock on each mode change
        self._brownout_policy = brownout
        self._on_brownout = on_brownout
        self._brownout = False
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None

    @property
    def queued_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    @property
    def brownout(self) -> bool:
        with self._lock:
            return self._brownout

    def _update_brownout_locked(self, now: float) -> Optional[bool]:
        """Advance the brownout state machine; the new mode on a
        transition, else None."""
        p = self._brownout_policy
        if p is None:
            return None
        q = self._queued_rows
        if not self._brownout:
            self._under_since = None
            if q >= p.high_rows:
                if self._over_since is None:
                    self._over_since = now
                if now - self._over_since >= p.after_s:
                    self._brownout = True
                    self._over_since = None
                    return True
            else:
                self._over_since = None
        else:
            self._over_since = None
            if q <= p.low_rows:
                if self._under_since is None:
                    self._under_since = now
                if now - self._under_since >= p.after_s:
                    self._brownout = False
                    self._under_since = None
                    return False
            else:
                self._under_since = None
        return None

    def _effective_window_locked(self) -> float:
        if self._brownout and self._brownout_policy is not None:
            return self.window_s * self._brownout_policy.window_factor
        return self.window_s

    @property
    def effective_window_s(self) -> float:
        """The coalescing window in force (brownout shrinks it)."""
        with self._lock:
            return self._effective_window_locked()

    @property
    def release_rows(self) -> int:
        with self._lock:
            return self._release_rows

    # the autotuner's setters run on the device worker while handler
    # threads submit: both hold the lock and wake the worker, since a
    # shrink can make the oldest request releasable now
    def set_window_s(self, window_s: float) -> None:
        with self._lock:
            self.window_s = max(float(window_s), 0.0)
            self._cv.notify_all()

    def set_release_rows(self, rows: int) -> None:
        """Move the active release rung, clamped to [1, max_rows]."""
        with self._lock:
            self._release_rows = max(1, min(int(rows), self.max_rows))
            self._cv.notify_all()

    def submit(self, fields_rows: list, slots_rows: list, priority: int = 0,
               trace: str = "", span: str = "") -> Future:
        """Queue one request's rows; returns the Future its caller waits
        on. Raises RejectedRequest (never queuing half a request) when the
        request is empty or oversized, the backlog is full, the batcher
        is closed, or brownout sheds its priority class."""
        n = len(slots_rows)
        if n == 0:
            raise RejectedRequest("request has no rows", client_error=True)
        if n > self.max_rows:
            raise RejectedRequest(
                f"request has {n} rows > serve.max_batch={self.max_rows}; split the request",
                client_error=True,
            )
        now = self._clock()
        req = PendingRequest(fields=list(fields_rows), slots=list(slots_rows), t_submit=now,
                             priority=int(priority), trace=trace, span=span)
        flipped = None
        try:
            with self._lock:
                if self._closed:
                    raise RejectedRequest("server is shutting down")
                flipped = self._update_brownout_locked(now)
                if self._brownout and req.priority < 0:
                    raise RejectedRequest(
                        f"brownout: shedding low-priority requests "
                        f"({self._queued_rows} rows backlogged); retry later",
                        shed=True,
                    )
                if self._queued_rows + n > self.max_queue_rows:
                    raise RejectedRequest(
                        f"queue full ({self._queued_rows} rows backlogged, "
                        f"limit {self.max_queue_rows}); retry later"
                    )
                self._q.append(req)
                self._queued_rows += n
                if flipped is None:
                    # the append may push the backlog over the high-water
                    # line: start the sustain timer now
                    flipped = self._update_brownout_locked(now)
                self._cv.notify_all()
        finally:
            if flipped is not None and self._on_brownout is not None:
                self._on_brownout(flipped, self.queued_rows)
        return req.future

    def take(self, timeout: Optional[float] = None) -> Optional[list]:
        """Block until a group is releasable, then pop and return it
        ([PendingRequest]). None on timeout with no group releasable, or
        when closed and drained (the worker's exit signal).

        Release: queued rows >= the release rung, the oldest request aged
        past the (brownout-shrunk) window, or the batcher closed. The
        group is the longest whole-request prefix within the rung."""
        deadline = None if timeout is None else self._clock() + timeout
        flipped = None
        with self._lock:
            while True:
                now = self._clock()
                if flipped is None:
                    flipped = self._update_brownout_locked(now)
                if self._q:
                    flush_at = self._q[0].t_submit + self._effective_window_locked()
                    if self._queued_rows >= self._release_rows or now >= flush_at or self._closed:
                        group = self._pop_group_locked()
                        break
                    if deadline is not None and now >= deadline:
                        group = None
                        break
                    wake = flush_at if deadline is None else min(flush_at, deadline)
                    self._cv.wait(max(wake - now, 0.0))
                    continue
                if self._closed:
                    group = None
                    break
                if deadline is not None:
                    left = deadline - now
                    if left <= 0:
                        group = None
                        break
                    self._cv.wait(left)
                else:
                    self._cv.wait()
        if flipped is not None and self._on_brownout is not None:
            self._on_brownout(flipped, self.queued_rows)
        return group

    def _pop_group_locked(self) -> list:
        # cap at the release rung, but always pop the head request: one
        # bigger than the rung (within max_rows) releases alone
        cap = max(self._release_rows, self._q[0].num_rows if self._q else 0)
        group = []
        rows = 0
        while self._q and rows + self._q[0].num_rows <= cap:
            req = self._q.popleft()
            rows += req.num_rows
            group.append(req)
        self._queued_rows -= rows
        return group

    def close(self) -> None:
        """Stop accepting; wake the worker so it drains the backlog
        (every queued future still resolves) and then sees None."""
        with self._lock:
            self._closed = True
            self._cv.notify_all()


def assemble_batch(group: list, batch_size: int, max_nnz: int) -> tuple[dict, list]:
    """Pack a group's ragged rows into one padded row-major batch.

    Returns (arrays, spans): {slots, fields, mask, row_mask} host arrays
    of fixed [batch_size, max_nnz] shape, packed by the data path's
    `make_batch` (a row longer than max_nnz keeps its first max_nnz
    features; padding rows are fully masked), and [(request, start,
    stop)] mapping each request to its rows. Raises ValueError when the
    group's rows exceed batch_size."""
    fields, slots, spans = [], [], []
    for req in group:
        spans.append((req, len(slots), len(slots) + req.num_rows))
        fields += req.fields
        slots += req.slots
    b = make_batch(fields, slots, [0.0] * len(slots), batch_size, max_nnz)
    return {"slots": b.slots, "fields": b.fields, "mask": b.mask, "row_mask": b.row_mask}, spans
