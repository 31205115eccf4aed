"""The process-wide metric registry and the record stamp's identity,
after `xflow_tpu/telemetry.py`: named counters, gauges and timers that
the server's telemetry increments and `GET /stats` snapshots, and the
`resolve_*` functions that read a process's identity from the launcher's
environment (`XFLOW_RUN_ID`, `XFLOW_PROCESS_ID`, `XFLOW_RESTART_GEN`,
`XFLOW_NUM_PROCESSES`, `XFLOW_REPLICA`, `XFLOW_REPLICA_PORT`,
`XFLOW_SLICE`, `XFLOW_NUM_SLICES`; the launchers and the serving fleet
export them). A rank started with flags instead of that environment
takes its rank and world size from the `torch.distributed` world it
joined. Unset, a process is rank 0 of a world of 1, generation 0,
outside a fleet and a multi-slice run.

The trainer's observability, after the JAX module: the card's memory
gauges (`device_memory_stats`, `hbm_window_fields`), `StepTimer`'s
one-step-behind split of a step into data wait, dispatch and device
time, the input pipeline's stage profiler (`PipelineProfiler`,
`pipeline_verdict`), the model-health monitor (`HealthMonitor`,
`estimate_collision_rate`), the liveness hooks (`HangWatchdog`,
`install_stack_dump_handler`) and the trace window (`TraceWindow`, over
`torch.profiler`). Where the JAX module blocks on a step's metrics, the
port waits on a CUDA event recorded on the step's stream after the
metrics' copies to the host (`stage_metrics`): never a device-wide
synchronize, which would also wait for the checkpoint snapshot's side
stream. CPU tensors need no wait. Compile accounting
(`CompileRecorder`) is not taken over: the torch step has no compile
step.
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time
import uuid
from collections import deque
from typing import Iterable, Iterator, Optional

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


def _joined_world():
    """`torch.distributed` when this process has joined a world, else
    None. Never imports torch: a process that has not (the serving
    fleet's router) has joined none."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist
    except Exception:  # noqa: BLE001 — a half-torn-down group reads as none
        pass
    return None


def resolve_rank() -> int:
    """XFLOW_PROCESS_ID, the launcher's authority; else this process's
    rank in the `torch.distributed` world it joined (a rank started with
    `--process-id`), as the JAX package falls back to
    `jax.process_index()`; else 0."""
    rank = _env_int("XFLOW_PROCESS_ID")
    if rank is not None:
        return rank
    dist = _joined_world()
    return int(dist.get_rank()) if dist is not None else 0


def resolve_restart_gen() -> int:
    """The supervised restart generation (XFLOW_RESTART_GEN), else 0."""
    return _env_int("XFLOW_RESTART_GEN") or 0


def resolve_world_size() -> int:
    """XFLOW_NUM_PROCESSES when positive; else the size of the
    `torch.distributed` world this process joined, as the JAX package
    falls back to `jax.process_count()`; else 1."""
    n = _env_int("XFLOW_NUM_PROCESSES")
    if n and n > 0:
        return n
    dist = _joined_world()
    return int(dist.get_world_size()) if dist is not None else 1


def resolve_replica() -> Optional[int]:
    """This serving replica's index (XFLOW_REPLICA), or None outside a fleet."""
    return _env_int("XFLOW_REPLICA")


def resolve_slice() -> Optional[int]:
    """This process's slice index in a multi-slice run (XFLOW_SLICE,
    exported by `launch-multislice`), or None outside one."""
    return _env_int("XFLOW_SLICE")


def resolve_num_slices() -> int:
    """The slice count of this launch (XFLOW_NUM_SLICES), 1 outside a
    multi-slice run."""
    n = _env_int("XFLOW_NUM_SLICES")
    return max(n, 1) if n else 1


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

    def discard(self, name: str) -> None:
        """Drop one metric (absent: nothing)."""
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()

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
    """The process-wide registry the serve counters, `/stats` and the
    trainer's window records share."""
    return _DEFAULT


# ------------------------------------------------------------ HBM gauges


def device_memory_stats(device=None) -> dict:
    """The caching allocator's figures for a CUDA `device`: bytes_in_use,
    peak_bytes_in_use (both of allocated tensors) and bytes_limit (the
    card's total memory). {} for the CPU, as JAX's CPU allocator reports
    nothing, and on any failure: a gauge must not end a step."""
    try:
        import torch

        dev = torch.device(device if device is not None else "cuda")
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(dev)
        _, total = torch.cuda.mem_get_info(dev)
    except Exception:  # noqa: BLE001 — gauging never harms the step
        return {}
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def hbm_window_fields(registry: Optional[Registry] = None, device=None) -> dict:
    """The memory fields of one window record (hbm_bytes_in_use,
    hbm_peak_bytes, hbm_bytes_limit), mirrored into the hbm.* gauges; {}
    on the CPU."""
    stats = device_memory_stats(device)
    if not stats:
        return {}
    reg = registry or default_registry()
    reg.gauge("hbm.bytes_in_use").set(stats["bytes_in_use"])
    reg.gauge("hbm.peak_bytes").set(stats["peak_bytes_in_use"])
    return {
        "hbm_bytes_in_use": stats["bytes_in_use"],
        "hbm_peak_bytes": stats["peak_bytes_in_use"],
        "hbm_bytes_limit": stats["bytes_limit"],
    }


# ----------------------------------------------------------------- StepTimer


class StagedMetrics(dict):
    """A step's metrics as host tensors whose copies from the card were
    issued on the step's stream, with `ready`, the CUDA event recorded
    after them: once it has completed, every value reads without a
    sync."""

    ready = None


def stage_metrics(metrics: dict) -> dict:
    """Stage a just-dispatched step's metrics for a one-step-behind read.
    With CUDA tensors among them: each is copied to pinned host memory
    without blocking, then one event is recorded on the current stream
    (`StagedMetrics`). Other values (the guard's host bool) pass as they
    are. Without a CUDA tensor the dict is returned as it is."""
    import torch

    cuda = [v for v in metrics.values() if isinstance(v, torch.Tensor) and v.is_cuda]
    if not cuda:
        return metrics
    out = StagedMetrics()
    for k, v in metrics.items():
        out[k] = v.to("cpu", non_blocking=True) if isinstance(v, torch.Tensor) and v.is_cuda else v
    with torch.cuda.device(cuda[0].device):
        out.ready = torch.cuda.Event()
        out.ready.record()
    return out


def wait_metrics(metrics) -> None:
    """Wait until a staged step's metrics are on the host: its event's
    synchronize, never a device-wide one. Host values need no wait."""
    ev = getattr(metrics, "ready", None)
    if ev is not None:
        ev.synchronize()


class StepTimer:
    """One-step-behind step-time decomposition, after the JAX module's.

    Per step i the fit loop calls:

      for batch in st.batches(iterator):   # data-wait = time inside next()
          ... transfer, dispatch ...
          st.dispatched(metrics_i, rows)   # waits for step i-1's metrics

    `dispatched` records step i's host-side times, then finishes step i-1
    by waiting for its staged metrics (`stage_metrics`' event), which
    overlaps step i's device work. The last step needs `flush()`.

    Per finished step: data_wait_s (inside the iterator's next()),
    dispatch_s (fetch end to dispatch return: the transfer and the
    launches, and any sync inside them), device_s (dispatch return to
    metrics ready; on a host-bound run the wait returns at once and it
    degrades to the pipeline interval) and step_s (completion to
    completion, which telescopes: the steps' sum is the elapsed wall)."""

    def __init__(self, registry: Optional[Registry] = None):
        self._reg = registry or default_registry()
        self._pending = None  # (metrics, rows, wait_s, dispatch_s, dispatch_end)
        self._last_ready: Optional[float] = None
        self._last_wait = 0.0
        self._wait_end: Optional[float] = None
        self._win_rows = 0
        self._win: dict = {"step": [], "wait": [], "dispatch": [], "device": []}
        self._win_start = time.perf_counter()
        self.steps = 0
        self.rows = 0

    def batches(self, iterable: Iterable) -> Iterator:
        """Wrap the batch iterator so the time inside next(), and only
        that, is the step's data wait. Abandonment closes the wrapped
        iterator at once (the prefetch stream's close cascade)."""
        it = iter(iterable)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                self._wait_end = time.perf_counter()
                self._last_wait = self._wait_end - t0
                yield item
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    @property
    def last_wait(self) -> float:
        """The just-fetched batch's data wait, seconds."""
        return self._last_wait

    @property
    def last_wait_end(self) -> Optional[float]:
        """perf_counter instant the just-fetched batch arrived (None
        before the first)."""
        return self._wait_end

    def dispatched(self, metrics, rows: int) -> None:
        """Call right after the step's dispatch returns: finishes the
        previous step (its wait overlaps this step's device work) and
        stages this one."""
        now = time.perf_counter()
        wait_end = self._wait_end if self._wait_end is not None else now
        cur = (metrics, int(rows), self._last_wait, now - wait_end, now)
        self._finish_pending()
        self._pending = cur

    def flush(self) -> None:
        """Finish the last step in flight (the one wait with nothing to
        hide behind, at the end of data)."""
        self._finish_pending()

    def _finish_pending(self) -> None:
        if self._pending is None:
            return
        metrics, rows, wait_s, dispatch_s, dispatch_end = self._pending
        self._pending = None
        wait_metrics(metrics)
        t_ready = time.perf_counter()
        device_s = t_ready - dispatch_end
        # the first step anchors on its own fetch start, so the
        # intervals telescope
        base = (self._last_ready if self._last_ready is not None
                else dispatch_end - dispatch_s - wait_s)
        self._last_ready = t_ready
        self.steps += 1
        self.rows += rows
        self._win_rows += rows
        w = self._win
        w["step"].append(t_ready - base)
        w["wait"].append(wait_s)
        w["dispatch"].append(dispatch_s)
        w["device"].append(device_s)
        self._reg.timer("step.time").observe(t_ready - base)
        self._reg.timer("step.data_wait").observe(wait_s)

    def window_record(self) -> dict:
        """Stats over the steps finished since the last call, then a
        reset; {} when none finished (the first tick under log_every=1).
        The JAX record's roofline gauges need a compiled program's cost
        and are not taken over."""
        w = self._win
        n = len(w["step"])
        if n == 0:
            return {}
        now = time.perf_counter()
        elapsed = max(now - self._win_start, 1e-9)
        step_ms = np.asarray(w["step"]) * 1e3
        rec = {
            "steps_per_s": round(n / elapsed, 3),
            "rows_per_s": round(self._win_rows / elapsed, 1),
            "step_time_p50_ms": round(float(np.percentile(step_ms, 50)), 3),
            "step_time_p99_ms": round(float(np.percentile(step_ms, 99)), 3),
            "data_wait_ms": round(float(np.mean(w["wait"])) * 1e3, 3),
            "dispatch_ms": round(float(np.mean(w["dispatch"])) * 1e3, 3),
            "device_ms": round(float(np.mean(w["device"])) * 1e3, 3),
        }
        self._win = {"step": [], "wait": [], "dispatch": [], "device": []}
        self._win_rows = 0
        self._win_start = now
        self._reg.timer("step.time").window_reset()
        self._reg.timer("step.data_wait").window_reset()
        return rec


# ---------------------------------------------------------- PipelineProfiler

# the stage vocabulary (the JAX module's): two concurrent timelines, the
# prefetch thread's (producer) and the fit loop's (consumer); each
# group's stages sum to at most the window's wall
PIPELINE_PRODUCER_STAGES = (
    "read",  # readline (the Python parser; not on the port's paths)
    "parse",  # the native parser's next batch (read, parse, hash, pad in C)
    "hash",  # the Python parser's hashing
    "batch",  # the Python parser's row assembly
    "pad",  # the Python parser's padded fill
    "cache_read",  # `.xfc` batch slicing (data/shardcache.py)
    "plan",  # batch -> step arrays (the sorted plan, dedup)
    "producer_wait",  # blocked in the prefetch queue's put()
)
PIPELINE_CONSUMER_STAGES = (
    "queue_wait",  # the batch's data wait (time inside next())
    "transfer",  # host -> device (evaluate.to_device)
    "dispatch",  # fetch end -> dispatch return, less the transfer
    "device",  # the wait for the previous step's metrics
)
PIPELINE_STAGES = PIPELINE_PRODUCER_STAGES + PIPELINE_CONSUMER_STAGES
# the host stages a verdict can name (producer_wait is the device-bound
# signal, not a host cost)
_PIPELINE_HOST_STAGES = ("read", "parse", "hash", "batch", "pad", "cache_read", "plan")


def pipeline_verdict(stages: dict, wall_s: float) -> str:
    """One-line bottleneck verdict over stage seconds: a consumer starved
    in get() (`queue_wait`) names the top host stage; a producer blocked
    in put() (`producer_wait`) says the device or dispatch sets the
    pace."""
    if wall_s <= 0:
        return "no pipeline windows"
    pct = lambda k: 100.0 * float(stages.get(k, 0.0)) / wall_s  # noqa: E731
    starved = pct("queue_wait")
    blocked = pct("producer_wait")
    top = max(_PIPELINE_HOST_STAGES, key=pct)
    if starved >= blocked and starved > 10.0:
        return (f"host-bound in {top}: {pct(top):.0f}% of wall "
                f"(consumer starved {starved:.0f}%)")
    if blocked > starved and blocked > 10.0:
        return (f"device-bound: producer blocked {blocked:.0f}% of wall "
                f"(dispatch+device {pct('dispatch') + pct('device'):.0f}%)")
    return (f"balanced: top host stage {top} {pct(top):.0f}%, "
            f"device {pct('device'):.0f}%, queue-wait {starved:.0f}%")


class PipelineProfiler:
    """Per-stage wall time of the training input pipeline
    (train.pipeline_metrics), after the JAX module's: the producer
    stages come from the prefetch thread (the native parse or the
    `.xfc` slicing, the plan, the queue's put), the consumer stages from
    the fit loop, which tiles its iteration into queue_wait, transfer,
    dispatch and device. Nothing here waits on the device. With the
    profiler off (None) every seam takes its unprofiled path. `add`,
    `stage` and `window_record` take one lock. The producer's stages are
    timed as open intervals, so one that spans a window boundary (a put
    blocked across a record) is split between the two windows, and a
    thread's stages never sum past a window's wall; the JAX profiler
    credits a whole occurrence to the window in which it ends."""

    def __init__(self, registry: Optional[Registry] = None):
        self._reg = registry or default_registry()
        self._lock = threading.Lock()
        self._win = {s: 0.0 for s in PIPELINE_STAGES}
        self._producer_blocked = 0.0  # the run's total, a live gauge
        self._win_batches = 0
        self._win_rows = 0
        self._queue_depth = 0
        self._queue_cap = 0
        self._open: dict = {}  # a running stage: [name, the time credited up to]
        self._win_start = time.perf_counter()

    def start(self) -> None:
        """Re-anchor the clock at fit() start and register the prefetch
        gauges."""
        with self._lock:
            self._win_start = time.perf_counter()
        self._reg.gauge("pipeline.queue_depth").set(0)
        self._reg.gauge("pipeline.producer_blocked_s").set(0.0)

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._win[stage] += seconds
            if stage == "producer_wait":
                self._producer_blocked += seconds
                total = self._producer_blocked
        if stage == "producer_wait":
            self._reg.gauge("pipeline.producer_blocked_s").set(round(total, 6))

    def add_many(self, stages: dict) -> None:
        """The fit loop's consumer stages of one step."""
        with self._lock:
            for stage, seconds in stages.items():
                self._win[stage] += seconds

    def stage(self, name: str):
        """Context manager timing one occurrence of a stage. While it
        runs it is open: a window that closes meanwhile takes the part
        before its end, the next window the rest."""
        prof = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.perf_counter()
                with prof._lock:
                    prof._open[id(self)] = [name, self._t0]
                return self

            def __exit__(self, *exc):
                now = time.perf_counter()
                with prof._lock:
                    since = prof._open.pop(id(self))[1]
                    prof._win[name] += now - since
                    if name == "producer_wait":
                        prof._producer_blocked += now - self._t0
                        total = prof._producer_blocked
                if name == "producer_wait":
                    prof._reg.gauge("pipeline.producer_blocked_s").set(round(total, 6))
                return False

        return _Ctx()

    def count_batch(self, rows: int) -> None:
        with self._lock:
            self._win_batches += 1
            self._win_rows += int(rows)

    def close(self) -> None:
        """Drop the profiler's gauges (fit teardown), so a later fit
        without the profiler snapshots no pipeline.* metric."""
        self._reg.discard("pipeline.queue_depth")
        self._reg.discard("pipeline.producer_blocked_s")

    def observe_queue(self, depth: int, cap: int) -> None:
        """A prefetch queue-depth sample (both sides take them)."""
        with self._lock:
            self._queue_depth = int(depth)
            self._queue_cap = int(cap)
        self._reg.gauge("pipeline.queue_depth").set(int(depth))

    def window_record(self) -> dict:
        """The kind="pipeline" payload: wall and stage seconds since the
        last call, then a reset; {} when the window saw nothing."""
        with self._lock:
            now = time.perf_counter()
            for entry in self._open.values():  # split the open stages here
                self._win[entry[0]] += now - entry[1]
                entry[1] = now
            if self._win_batches == 0 and not any(v > 0.0 for v in self._win.values()):
                return {}
            rec = {"wall_s": round(max(now - self._win_start, 1e-9), 6)}
            for s in PIPELINE_STAGES:
                rec[f"{s}_s"] = round(self._win[s], 6)
                self._win[s] = 0.0
            rec["batches"] = self._win_batches
            rec["rows"] = self._win_rows
            rec["queue_depth"] = self._queue_depth
            rec["queue_cap"] = self._queue_cap
            self._win_batches = 0
            self._win_rows = 0
            self._win_start = now
        return rec


# ------------------------------------------------------------- HealthMonitor


def estimate_collision_rate(distinct_slots: int, num_slots: int) -> float:
    """Collision-rate estimate from slot saturation: under uniform
    hashing n keys fill d = S(1 - (1 - 1/S)^n) slots, so n is estimated
    as ln(1 - d/S) / ln(1 - 1/S) and the rate as 1 - d/n. Exact at d ->
    0, 1 at saturation."""
    S, d = int(num_slots), int(distinct_slots)
    if d <= 0 or S <= 1:
        return 0.0
    if d >= S:
        return 1.0
    n_hat = math.log1p(-d / S) / math.log1p(-1.0 / S)
    return max(0.0, 1.0 - d / n_hat)


class HealthMonitor:
    """The host side of train.health_metrics, after the JAX module's. The
    step puts the grad, update and param norms into its metrics
    (train/step.py `health_norms`); `collect()` reads the previous
    step's right after StepTimer waited for them, so no read syncs, and
    keeps the loss EMA, the touched-slot bitmap behind the occupancy and
    collision gauges, and the window's values. `observe_batch` runs on
    the prefetch thread, `collect` and `window_record` on the fit loop:
    the bitmap and the window are under one lock."""

    KEYS = ("grad_norm", "update_norm", "param_norm")

    def __init__(self, mode: str = "off", ema_decay: float = 0.99,
                 registry: Optional[Registry] = None, num_slots: int = 0):
        if mode not in ("off", "norms", "full"):
            raise ValueError(f"health mode {mode!r}: expected off|norms|full")
        self.enabled = mode != "off"
        self.mode = mode
        self._decay = float(ema_decay)
        self._reg = registry or default_registry()
        self._lock = threading.Lock()
        self.loss_ema = float("nan")
        self._pending = None
        self._last: dict = {}
        self._win_grad_max = float("nan")
        self._seen = (np.zeros(int(num_slots), dtype=bool)
                      if self.enabled and num_slots > 0 else None)
        self._num_slots = int(num_slots)

    def staged(self, metrics) -> None:
        """Stage a just-dispatched step's metrics for the next collect."""
        if self.enabled:
            self._pending = metrics

    def collect(self) -> None:
        """Read the previous step's health scalars and loss (ready: the
        StepTimer just waited for them), fold the EMA, set the gauges."""
        if self._pending is None:
            return
        m = self._pending
        self._pending = None
        loss = float(m["loss"]) if "loss" in m else float("nan")
        if loss == loss and abs(loss) != float("inf"):
            self.loss_ema = (loss if self.loss_ema != self.loss_ema
                             else self._decay * self.loss_ema + (1.0 - self._decay) * loss)
            self._reg.gauge("health.loss_ema").set(self.loss_ema)
        vals = {}
        for key in self.KEYS:
            if key in m:
                vals[key] = float(m[key])
                self._reg.gauge(f"health.{key}").set(vals[key])
        if self.mode == "full":
            for key in m:
                if isinstance(key, str) and "." in key and key.split(".")[0] in self.KEYS:
                    vals[key] = float(m[key])
        with self._lock:
            if vals:
                self._last = vals
                g = vals.get("grad_norm")
                if g is not None and (self._win_grad_max != self._win_grad_max
                                      or g > self._win_grad_max):
                    self._win_grad_max = g

    def flush(self) -> None:
        """End of data: the last step's metrics (StepTimer.flush waited)."""
        self.collect()

    def observe_batch(self, slots, mask) -> None:
        """Mark a training batch's masked slots as touched (the prefetch
        thread, on the batch's own slots: before the plan reorders them)."""
        if self._seen is None:
            return
        idx = np.asarray(slots)[np.asarray(mask) > 0]
        with self._lock:
            self._seen[idx] = True

    def window_record(self) -> dict:
        """The health fields of one window record: the last norms, the
        window's grad-norm max, the loss EMA, the occupancy and collision
        gauges; {} before the first collect."""
        if not self.enabled:
            return {}
        with self._lock:
            if not self._last and self.loss_ema != self.loss_ema:
                return {}
            fin = lambda v: round(v, 6) if v == v and abs(v) != float("inf") else None  # noqa: E731
            rec = {
                "grad_norm": fin(self._last.get("grad_norm", float("nan"))),
                "grad_norm_max": fin(self._win_grad_max),
                "update_norm": fin(self._last.get("update_norm", float("nan"))),
                "param_norm": fin(self._last.get("param_norm", float("nan"))),
                "loss_ema": fin(self.loss_ema),
            }
            if self.mode == "full":
                tables: dict = {}
                for key, v in self._last.items():
                    if "." in key:
                        kind, tname = key.split(".", 1)
                        tables.setdefault(tname, {})[kind] = fin(v)
                if tables:
                    rec["health_tables"] = tables
            self._win_grad_max = float("nan")
            if self._seen is not None:
                touched = int(np.count_nonzero(self._seen))
                occ = touched / self._num_slots
                est = estimate_collision_rate(touched, self._num_slots)
                rec["slots_touched"] = touched
                rec["table_occupancy"] = round(occ, 6)
                rec["est_collision_rate"] = round(est, 6)
                self._reg.gauge("health.slots_touched").set(touched)
                self._reg.gauge("health.table_occupancy").set(occ)
                self._reg.gauge("health.est_collision_rate").set(est)
        return rec


# ----------------------------------------------------------- liveness hooks


def install_stack_dump_handler():
    """`kill -USR1 <pid>` dumps every thread's stack (faulthandler).
    Returns a restore callable; a no-op off the main thread and where
    there is no SIGUSR1."""
    try:
        import faulthandler
        import signal

        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        sig = getattr(signal, "SIGUSR1", None)
        if sig is None:
            return lambda: None
        faulthandler.register(sig, all_threads=True)
        return lambda: faulthandler.unregister(sig)
    except Exception:  # noqa: BLE001 — a missing hook never stops training
        return lambda: None


class HangWatchdog:
    """train.hang_timeout_s: a daemon thread dumps every thread's stack
    to stderr when `tick()` has not been called for `timeout_s`, once a
    stall, re-armed by the next tick. Off at 0."""

    def __init__(self, timeout_s: float, out=None):
        self._timeout = float(timeout_s)
        self._out = out  # defaults to sys.stderr at dump time
        self._lock = threading.Lock()
        self._last = time.perf_counter()
        self._dumped = False
        self._stop = threading.Event()
        self._thread = None
        self.dumps = 0
        if self._timeout > 0:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="xflow-hang-watchdog")
            self._thread.start()

    def tick(self) -> None:
        with self._lock:
            self._last = time.perf_counter()
            self._dumped = False

    def _run(self) -> None:
        import faulthandler

        poll = min(max(self._timeout / 4.0, 0.05), 5.0)
        while not self._stop.wait(poll):
            with self._lock:
                idle = time.perf_counter() - self._last
                stalled = idle > self._timeout and not self._dumped
                if stalled:
                    self._dumped = True
                    self.dumps += 1
            if stalled:
                out = self._out or sys.stderr
                print(f"xflow: hang watchdog: no step progress for {idle:.1f}s "
                      f"(> train.hang_timeout_s={self._timeout}); dumping all thread stacks",
                      file=out)
                try:
                    faulthandler.dump_traceback(file=out, all_threads=True)
                except Exception:  # noqa: BLE001 — an out without a fileno
                    pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# --------------------------------------------------------------- TraceWindow


class TorchProfiler:
    """TraceWindow's default profiler: a `torch.profiler` session (CPU,
    and CUDA where a card is present) that `stop_trace` writes as a
    Chrome trace `<dir>/trace_<pid>_<n>.json`."""

    def __init__(self):
        self._prof = None
        self._dir = ""
        self._n = 0

    def start_trace(self, directory: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._dir = directory
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"trace_{os.getpid()}_{self._n}.json")
        self._n += 1
        prof.export_chrome_trace(path)


class TraceWindow:
    """The trace window, after the JAX module's: with `profile_dir` set
    and `start_step` >= 1 the trace starts just before that step's
    dispatch and stops once `num_steps` steps have dispatched;
    `start_step` 0 traces the whole run. `close()` stops a trace the
    data's end left running. `profiler` (start_trace(dir), stop_trace())
    is a seam; the default is `TorchProfiler`."""

    def __init__(self, profile_dir: str, start_step: int = 0, num_steps: int = 0,
                 profiler=None):
        self._dir = profile_dir
        self._start = max(int(start_step), 0)
        self._num = max(int(num_steps), 1)
        self._running = False
        self._done = not profile_dir
        self._prof = profiler

    def _profiler(self):
        if self._prof is None:
            self._prof = TorchProfiler()
        return self._prof

    def maybe_start_run(self) -> None:
        """Before the loop: the whole-run mode (start_step 0) starts here."""
        if not self._done and not self._running and self._start == 0:
            self._profiler().start_trace(self._dir)
            self._running = True

    def before_step(self, step: int) -> None:
        """Window mode: called with the 1-based step about to dispatch."""
        if self._done or self._start == 0:
            return
        if not self._running and step == self._start:
            self._profiler().start_trace(self._dir)
            self._running = True
        elif self._running and step >= self._start + self._num:
            self._stop()

    def _stop(self) -> None:
        if self._running:
            self._profiler().stop_trace()
            self._running = False
        self._done = True

    def close(self) -> None:
        """Stop a trace still running (end of data, abnormal exit)."""
        self._stop()
