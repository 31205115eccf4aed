"""Single-device training (a subset of `xflow_tpu/train/trainer.py`).

`Trainer(cfg, device).fit()` runs epochs over the rank-0 shard of
`data.train_path` (`<prefix>-00000`) in file order, no shuffle. A
prefetch thread reads each batch (`data/pipeline.batch_iterator`: the
shard's `.xfc` cache, or its text through the native parser, with the
bad-record monitor; the first epoch quarantines) and plans it on the host
(`evaluate.batch_arrays`: the native planner's slot-sorted plan in its
compact wire form when the sorted layout is on), so parsing and planning
overlap the card's step; the main thread moves the arrays to the device
and runs the train step. Checkpoints (tables,
optimizer state, step, data_state) land every `train.checkpoint_every`
steps and at the end; `maybe_restore` resumes from the newest loadable
one, and the next `fit` continues the data stream at its stored offset.

The fit loop's bookkeeping is the JAX loop's (`_StepLog`): a step's
metrics are copied to the host without blocking and read one step
behind, after the next step's dispatch (`telemetry.stage_metrics`,
`StepTimer`). Every `train.log_every` steps a window record is staged
and written after the next dispatch (the loss, StepTimer's split, the
card's memory, the health fields, the registry's counters), flushed
before a checkpoint, on a halt, on an error and at the end of data; the
`final` record closes the run. The non-finite guard's flag is consumed
one step behind too; the guard itself reads it on the host inside the
step (`train/step.py`), so with the guard on the step syncs inside its
dispatch. Around it: the heartbeat (`train.heartbeat_path`), the hang
watchdog, SIGUSR1 stack dumps, the trace window (`train.profile_dir`),
the pipeline profiler's kind="pipeline" records, and `train.eval_every`
streaming holdout passes.

The online loop (`data.stream=tail`, `_fit_tail`): a `TailFollower`
spools the growing input into sealed segments inside the same prefetch
thread, each segment's batches take the same read, plan and step, and
every `train.publish_every` steps a checkpoint commits with a
publication sidecar naming the newest ingest trace a step consumed,
which the server reports as freshness; `eval_every` counts
publications there.

Checkpoints: synchronous, or with `train.ckpt_async` a snapshot the fit
loop hands to one writer thread (`train/checkpoint.py`); either way
pruned (`keep_checkpoints`) and mirrored into `ckpt_replica_dir`.
SIGTERM/SIGINT (`ckpt_on_signal`) commit the step reached and end the
run with `interrupted`. The run's records (`train.metrics_path`): the
window and `final` records, `eval_auc`, `pipeline`, `ingest`, `ckpt`,
`publish`, `span` (`checkpoint_save`, `publish`), `interrupted`,
`nonfinite_skipped` and `nonfinite_halt`.

`evaluate` is the JAX one on one process: exact, or bucketed
(`train.eval_buckets`; a streaming pass takes 65,536 under auto) with
the decayed window, either writing `pred_0_<block>.txt` rows.

Not taken over from the JAX trainer: compile accounting and its
roofline gauges (the torch step has no compile step), the fault
injectors of the fit loop, and multi-process coordination.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data import pipeline
from xflow_tpu_torch.data.libffm import shard_path
from xflow_tpu_torch.evaluate import (
    HostDedup,
    batch_arrays,
    dump_rows,
    evaluate,
    predict_batches,
    sorted_layout_on,
    to_device,
)
from xflow_tpu_torch.jsonl import JsonlAppender
from xflow_tpu_torch.metrics import BucketAUC, log_likelihood, resolve_eval_buckets
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.telemetry import (
    HangWatchdog,
    HealthMonitor,
    PipelineProfiler,
    StepTimer,
    TraceWindow,
    default_registry,
    hbm_window_fields,
    install_stack_dump_handler,
    stage_metrics,
    wait_metrics,
)
from xflow_tpu_torch.tracing import emit_linked_span, emit_op_span, new_id
from xflow_tpu_torch.train import checkpoint as ckpt
from xflow_tpu_torch.train.state import TrainState, init_state
from xflow_tpu_torch.train.step import health_mode, make_train_step, nonfinite_guard_on
from xflow_tpu_torch.weights import table_shapes


class NonFiniteHalt(RuntimeError):
    """Raised by fit() when the non-finite guard aborts the run
    (train.nonfinite_guard=halt, or nonfinite_max_consecutive discarded
    steps in a row under skip), after committing the last good state
    when train.checkpoint_dir is set."""


class MetricsLogger(JsonlAppender):
    """The run's JSONL record stream (`train.metrics_path`, "" = off):
    lazy open, a flush a record, and a close that a later record
    reopens in append mode."""

    log = JsonlAppender.append


@dataclass
class TrainResult:
    steps: int = 0
    epochs: int = 0
    examples: int = 0
    seconds: float = 0.0
    last_loss: float = float("nan")
    occupancy: dict = field(default_factory=dict)
    bad_steps: int = 0  # non-finite updates discarded by the guard
    interrupted: int = 0  # the signal number when a signal ended the run

    @property
    def examples_per_sec(self) -> float:
        return self.examples / self.seconds if self.seconds > 0 else 0.0


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


class _StepLog:
    """The fit loop's per-step bookkeeping, the JAX loop's: the transfer
    and dispatch with StepTimer's split (and the pipeline profiler's
    consumer tiling), the health monitor's one-behind collect, the guard
    flag consumed one step behind (`check_pending`), and the window
    record staged at the log cadence and written after the next dispatch
    (`emit`)."""

    def __init__(self, trainer: "Trainer", res: TrainResult, start: float,
                 prof: Optional[PipelineProfiler] = None):
        self.t = trainer
        self.res = res
        self.start = start
        self.prof = prof
        self.timer = StepTimer()
        self.registry = default_registry()
        self.health = trainer._health
        self.pending_ok = None  # (metrics, step) awaiting the guard check
        self.pending_rec = None  # a log-cadence step's record, written one behind
        self.last_metrics = None
        self.bad_run = 0
        # the profiler's tiling mark: the end of the previous iteration
        # (None after a checkpoint or an eval, whose wall is no step's)
        self.mark: Optional[float] = None

    def dispatch(self, batch, host: dict):
        """Transfer, dispatch and stage one step; finish the previous
        one (StepTimer, health) and write its staged record."""
        t, prof = self.t, self.prof
        pc = time.perf_counter
        t0 = pc()
        arrays = to_device(host, t.device)
        t1 = pc()
        t.state, m = t.train_step(t.state, arrays)
        m = stage_metrics(m)
        t2 = pc()
        self.timer.dispatched(m, batch.num_rows)
        if prof is not None:
            t3 = pc()
            wait_end = self.timer.last_wait_end or t0
            fetch_start = wait_end - self.timer.last_wait
            gap = max(fetch_start - self.mark, 0.0) if self.mark is not None else 0.0
            prof.add_many({
                "queue_wait": self.timer.last_wait,
                "transfer": t1 - t0,
                "dispatch": (t2 - t1) + max(t0 - wait_end, 0.0) + gap,
                "device": t3 - t2,
            })
            self.mark = t3
        self.health.collect()
        self.health.staged(m)
        self.emit()
        self.last_metrics = m
        return m

    def check_pending(self) -> bool:
        """Consume the previous step's guard flag; True when the guard
        demands an abort."""
        if self.pending_ok is None:
            return False
        m, at_step = self.pending_ok
        self.pending_ok = None
        if "update_ok" not in m or bool(m["update_ok"]):
            self.bad_run = 0
            return False
        res, cfg = self.res, self.t.cfg
        res.bad_steps += 1
        self.bad_run += 1
        self.t.metrics.log({"step": at_step, "nonfinite_skipped": True,
                            "bad_steps": res.bad_steps})
        print(f"nonfinite update at step {at_step} discarded "
              f"(total {res.bad_steps}, {self.bad_run} consecutive)", file=sys.stderr)
        return cfg.train.nonfinite_guard == "halt" or (
            0 < cfg.train.nonfinite_max_consecutive <= self.bad_run)

    def stage(self, m, epoch: int) -> None:
        """After the guard check: stage this step's flag, and its record
        at the log cadence (host values only: the step, examples,
        elapsed and the counters, read now; the loss later)."""
        res, cfg = self.res, self.t.cfg
        if self.t._guarded:
            self.pending_ok = (m, res.steps)
        if cfg.train.log_every and res.steps % cfg.train.log_every == 0:
            self.pending_rec = (m, res.steps, epoch, res.examples,
                                round(time.perf_counter() - self.start, 3),
                                self.registry.snapshot())

    def emit(self) -> None:
        """Write the staged record: its step's metrics are on the host by
        now (a checkpoint or a halt right after staging waits for them
        here), then the stderr progress line and, with the profiler, the
        pipeline window."""
        if self.pending_rec is None:
            return
        pm, at_step, at_epoch, at_examples, at_elapsed, counters = self.pending_rec
        self.pending_rec = None
        wait_metrics(pm)
        loss = float(pm["loss"])
        finite = _finite(loss)
        if finite or not self.t._guarded:
            self.res.last_loss = loss
        rec = {"step": at_step, "epoch": at_epoch, "loss": loss if finite else None,
               "examples": at_examples, "elapsed_s": at_elapsed}
        rec.update(self.window_fields())
        if counters:
            rec["counters"] = counters
        self.t.metrics.log(rec)
        print(f"step {at_step} epoch {at_epoch} loss {loss}", file=sys.stderr)
        if self.prof is not None:
            prec = self.prof.window_record()
            if prec:
                self.t.metrics.log({"kind": "pipeline", "step": at_step, **prec})

    def window_fields(self) -> dict:
        out = self.timer.window_record()
        out.update(hbm_window_fields(self.registry, self.t.device))
        out.update(self.health.window_record())
        return out

    def salvage(self) -> None:
        """An error's path: write the staged record if it can be read,
        never masking the error."""
        try:
            self.emit()
        except BaseException:  # noqa: BLE001 — the original error is re-raised
            pass

    def finish(self) -> None:
        """End of data: wait for the last step (the one wait with nothing
        behind it), write its staged record and the profiler's tail
        window, and take the last loss (the last finite one under the
        guard)."""
        prof = self.prof
        t0 = time.perf_counter()
        self.timer.flush()
        self.health.flush()
        if prof is not None:
            prof.add("device", time.perf_counter() - t0)
        self.emit()
        if prof is not None:
            prec = prof.window_record()
            if prec:
                self.t.metrics.log({"kind": "pipeline", "step": self.res.steps, **prec})
        if self.last_metrics is not None:
            loss = float(self.last_metrics["loss"])
            if _finite(loss) or not self.t._guarded:
                self.res.last_loss = loss

    def final_record(self) -> None:
        res = self.res
        rec = {"final": True, "steps": res.steps, "examples": res.examples,
               "elapsed_s": round(res.seconds, 3), "occupancy": res.occupancy}
        rec.update(self.window_fields())
        counters = self.registry.snapshot()
        if counters:
            rec["counters"] = counters
        self.t.metrics.log(rec)
        self.t.heartbeat.append({"event": "final", "step": res.steps})


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.model = get_model(cfg.model.name)(cfg)
        self.optimizer = get_optimizer(cfg.optim.name)
        # batches ship as slot-sorted plans (the JAX trainer's single-device
        # rule); validates data.sorted_layout at construction
        self.sorted = sorted_layout_on(cfg)
        self._guarded = nonfinite_guard_on(cfg)  # validates train.nonfinite_guard
        self.dedup = HostDedup(cfg)  # row-major batches; validates data.dedup
        self.state: TrainState = init_state(self.model, self.optimizer, cfg, device)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)
        self.metrics = MetricsLogger(cfg.train.metrics_path,
                                     max_bytes=cfg.train.metrics_max_bytes)
        # liveness: {step} records, and start/checkpoint/eval/final events
        self.heartbeat = JsonlAppender(cfg.train.heartbeat_path, stamp={"kind": "heartbeat"})
        self._health = HealthMonitor(mode=health_mode(cfg),
                                     ema_decay=cfg.train.health_ema_decay,
                                     num_slots=cfg.num_slots)
        # the training stream's stage profiler (evaluation stays unprofiled)
        self.pipeline_prof = PipelineProfiler() if cfg.train.pipeline_metrics else None
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointWriter] = None  # started lazily
        # data-stream position pinned by the next checkpoint's data_state:
        # (epoch, batches consumed within it) of the one shard
        self._epoch_pos = (0, 0)
        self._examples_seen = 0
        self._examples_base = 0
        self._resume_data_state: Optional[dict] = None
        # the decayed eval window (BucketAUC, ll_sum, rows), from the
        # first pass under train.eval_window_decay
        self._eval_window: Optional[tuple] = None

    # ------------------------------------------------------------------ train
    def _install_signal_checkpoint(self):
        """SIGTERM/SIGINT (train.ckpt_on_signal, with a checkpoint dir)
        set a flag the fit loop reads after each step: it then commits the
        step reached and returns. The handler only writes the flag and
        puts the previous handlers back, so a second signal acts as it
        would have. Main thread only. Returns (flag dict or None, restore)."""
        cfg = self.cfg
        if not (cfg.train.ckpt_on_signal and cfg.train.checkpoint_dir) or (
                threading.current_thread() is not threading.main_thread()):
            return None, lambda: None
        flag: dict = {}
        prev: dict = {}

        def handler(signum, frame):
            flag["sig"] = signum
            for s, h in prev.items():
                signal.signal(s, h)

        for s in (signal.SIGTERM, signal.SIGINT):
            prev[s] = signal.signal(s, handler)

        def restore():
            if "sig" not in flag:
                for s, h in prev.items():
                    signal.signal(s, h)

        return flag, restore

    def fit(self, train_path: Optional[str] = None) -> TrainResult:
        try:
            return self._fit(train_path)
        finally:
            # the writer drains before the sink closes: its last ckpt
            # records land, and fit returning means the last save is on disk
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
                self._ckpt_writer = None
            self.metrics.close()
            self.heartbeat.close()
            if self.pipeline_prof is not None:
                self.pipeline_prof.close()

    def _fit(self, train_path: Optional[str] = None) -> TrainResult:
        cfg = self.cfg
        if cfg.data.stream not in ("off", "tail"):
            raise ValueError(f"data.stream={cfg.data.stream!r}: expected 'off' or 'tail'")
        if cfg.data.stream == "tail":
            return self._fit_tail(train_path)
        path = train_path or shard_path(cfg.data.train_path, 0)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        res = TrainResult()
        start = time.perf_counter()
        trace = TraceWindow(cfg.train.profile_dir, cfg.train.trace_start_step,
                            cfg.train.trace_num_steps)
        trace.maybe_start_run()
        prof = self.pipeline_prof
        if prof is not None:
            prof.start()
        log = _StepLog(self, res, start, prof)
        dump_restore = install_stack_dump_handler()
        hang = HangWatchdog(cfg.train.hang_timeout_s)
        hb_every = cfg.train.heartbeat_every
        if cfg.train.eval_every and not cfg.data.test_path:
            print("xflow: warning: train.eval_every is set but data.test_path is empty — "
                  "no streaming eval will run", file=sys.stderr)
        self.heartbeat.append({"event": "start", "step": 0})
        sig_flag, sig_restore = self._install_signal_checkpoint()
        start_epoch, skip = self._consume_resume_position()
        self._epoch_pos = (start_epoch, skip)
        stop_sig = 0
        halted = False
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                offset = skip if epoch == start_epoch else 0
                log.mark = None
                # closing: a halt or an error stops the reader thread at once
                with contextlib.closing(pipeline.prefetch(
                        self._feed(path, offset, quarantine=epoch == 0, profiler=prof),
                        profiler=prof)) as stream:
                    for batch, host in log.timer.batches(stream):
                        offset += 1
                        trace.before_step(res.steps + 1)
                        m = log.dispatch(batch, host)
                        hang.tick()
                        self._count_step(res, batch, (epoch, offset))
                        if hb_every and res.steps % hb_every == 0:
                            self.heartbeat.append({"step": res.steps})
                        if log.check_pending():
                            halted = True
                            break
                        log.stage(m, epoch)
                        if (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
                                and res.steps % cfg.train.checkpoint_every == 0):
                            self._cadence_save(log, hang, self.save_checkpoint)
                        stop_sig = self._signalled(sig_flag)
                        if stop_sig:
                            break
                if halted:
                    break
                if not stop_sig:  # an interrupted epoch keeps its mid-epoch position
                    self._epoch_pos = (epoch + 1, 0)
                res.epochs = epoch + (0 if stop_sig else 1)
                if not stop_sig:
                    if (epoch + 1) % 30 == 0:
                        print(f"epoch : {epoch}", file=sys.stderr)
                    if (cfg.train.eval_every and cfg.data.test_path
                            and (epoch + 1) % cfg.train.eval_every == 0):
                        self._eval_pass(res.steps, epoch, hang, gauges=True)
                    stop_sig = self._signalled(sig_flag)
                if stop_sig:
                    self._interrupted(res, stop_sig)
                    break
            # the last step's flag is still pending after the data ends
            if not halted and log.check_pending():
                halted = True
            if halted:
                log.emit()
                self._halt(res, log.bad_run)
        except BaseException:
            log.salvage()
            raise
        finally:
            sig_restore()
            dump_restore()
            hang.close()
            trace.close()
        log.finish()
        res.seconds = time.perf_counter() - start
        res.occupancy = self._occupancy()
        log.final_record()
        if cfg.train.checkpoint_dir:
            self.save_checkpoint(wait=True)
        return res

    def _count_step(self, res: TrainResult, batch, pos: tuple) -> None:
        """A dispatched step's accounting and the stream position `pos`
        (epoch, batches) it reaches."""
        rows = batch.num_rows
        res.steps += 1
        res.examples += rows
        self._examples_seen += rows
        self._epoch_pos = pos

    def _cadence_save(self, log: _StepLog, hang: HangWatchdog, save):
        """A checkpoint at its cadence, `save()`'s result returned: the
        record staged this step lands first, beats bracket the save, a
        tick follows it, and the profiler's tiling mark drops (a save is
        no step's host work)."""
        log.emit()
        self.heartbeat.append({"step": log.res.steps, "event": "checkpoint"})
        out = save()
        self.heartbeat.append({"step": log.res.steps})
        hang.tick()
        log.mark = None
        return out

    def _eval_pass(self, step: int, epoch: int, hang: HangWatchdog, gauges: bool = False) -> None:
        """One `eval_every` holdout pass, streaming (bucketed under auto),
        bracketed by ticks and beats; its eval_auc record (null for NaN),
        and with `gauges` the health.eval_* gauges."""
        hang.tick()
        self.heartbeat.append({"step": step, "event": "eval"})
        auc, ll = self.evaluate(dump=False, streaming=True)
        self.heartbeat.append({"step": step})
        hang.tick()
        self.metrics.log({"step": step, "epoch": epoch,
                          "eval_auc": auc if auc == auc else None,
                          "eval_logloss": ll if ll == ll else None})
        if gauges:
            reg = default_registry()
            if auc == auc:
                reg.gauge("health.eval_auc").set(auc)
            if ll == ll:
                reg.gauge("health.eval_logloss").set(ll)

    @staticmethod
    def _signalled(sig_flag: Optional[dict]) -> int:
        return int(sig_flag["sig"]) if sig_flag and "sig" in sig_flag else 0

    def _interrupted(self, res: TrainResult, sig: int) -> None:
        res.interrupted = sig
        self.metrics.log({"interrupted": sig, "step": res.steps})
        self.heartbeat.append({"event": "interrupted", "step": res.steps})
        # on disk before the save: a kill at the end of the grace period
        # keeps the records
        self.metrics.close()
        self.heartbeat.close()
        print(f"signal {sig}: checkpointing at step {res.steps} and exiting", file=sys.stderr)

    # ---------------------------------------------------------- streaming fit
    def _fit_tail(self, train_path: Optional[str] = None) -> TrainResult:
        """The online loop (`data.stream=tail`): train on the sealed
        segments a `TailFollower` spools off the growing input, read and
        planned in the prefetch thread as any shard is, and every
        `train.publish_every` steps commit a checkpoint with a
        publication sidecar stamped with the newest ingest trace whose
        rows a step consumed (`publish_every` 0: the plain
        `checkpoint_every` cadence); every `eval_every` publications a
        holdout pass. No epochs: the stream is one open-ended pass, ended
        by `data.stream_idle_s`, a signal or a halt. The epoch loop's
        records, heartbeat and hang watchdog come along, not its profiler
        or trace window, as in the JAX trainer. The stream's last state
        commits (and publishes) when the run ends. A resumed run restores
        the state and follows the input from its top."""
        cfg = self.cfg
        res = TrainResult()
        start = time.perf_counter()
        log = _StepLog(self, res, start)
        dump_restore = install_stack_dump_handler()
        hang = HangWatchdog(cfg.train.hang_timeout_s)
        hb_every = cfg.train.heartbeat_every
        sig_flag, sig_restore = self._install_signal_checkpoint()
        self.heartbeat.append({"event": "start", "step": 0})
        follower = pipeline.TailFollower(
            train_path or cfg.data.train_path, cfg.data,
            appender=self.metrics if self.metrics.enabled else None,
        )
        # the newest (trace, ingest_ts, consumed_ts) a completed step
        # trained on: what the next publication stamps
        newest: Optional[tuple] = None
        pub_seq = 0
        publish_every = cfg.train.publish_every
        stop_sig = 0
        halted = False
        # the follower polls inside the prefetch thread; the flag ends its
        # wait for input within a poll, so a signal never waits out
        # stream_idle_s
        stream = pipeline.prefetch(self._feed_segments(
            follower, lambda: bool(self._signalled(sig_flag))))
        try:
            consumed = -1
            for seg, batch, host in log.timer.batches(stream):
                m = log.dispatch(batch, host)
                hang.tick()
                self._count_step(res, batch, (0, res.steps + 1))
                if seg.seq != consumed:
                    # the first step over a segment: the ingest-to-train edge
                    # of the freshness
                    consumed = seg.seq
                    newest = (seg.trace, seg.ingest_ts, time.time())
                if hb_every and res.steps % hb_every == 0:
                    self.heartbeat.append({"step": res.steps})
                if log.check_pending():
                    halted = True
                    break
                log.stage(m, 0)
                if cfg.train.checkpoint_dir and publish_every:
                    if res.steps % publish_every == 0:
                        # the seq is spent only when the publication landed
                        # (an async skip retries with the same)
                        if self._cadence_save(log, hang, lambda: self._publish_checkpoint(
                                newest, pub_seq + 1)):
                            pub_seq += 1
                        if (cfg.train.eval_every and cfg.data.test_path
                                and pub_seq % cfg.train.eval_every == 0):
                            self._eval_pass(res.steps, 0, hang)
                elif (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
                      and res.steps % cfg.train.checkpoint_every == 0):
                    self._cadence_save(log, hang, self.save_checkpoint)
                stop_sig = self._signalled(sig_flag)
                if stop_sig:
                    break
            if not halted and log.check_pending():
                halted = True
            if halted:
                log.emit()
                self._halt(res, log.bad_run)
            stop_sig = stop_sig or self._signalled(sig_flag)
            if stop_sig:
                self._interrupted(res, stop_sig)
        except BaseException:
            log.salvage()
            raise
        finally:
            follower.close()  # before the stream: its reader thread may be polling
            stream.close()
            sig_restore()
            dump_restore()
            hang.close()
        log.finish()
        res.seconds = time.perf_counter() - start
        res.epochs = 1 if res.steps else 0
        res.occupancy = self._occupancy()
        log.final_record()
        if cfg.train.checkpoint_dir and res.steps:
            # the stream's last rows become servable even when the run
            # ends mid-cadence; wait=True drains any save in flight first
            if publish_every and newest is not None:
                self._publish_checkpoint(newest, pub_seq + 1, wait=True)
            else:
                self.save_checkpoint(wait=True)
        return res

    def _feed_segments(self, follower, stop):
        """(segment, batch, host arrays) of every sealed segment, in the
        prefetch thread; ends with the follower's stream."""
        for seg in follower.segments(stop):
            for batch, host in self._feed(seg.path, 0, quarantine=True):
                yield seg, batch, host

    def _publish_checkpoint(self, newest: tuple, seq: int, wait: bool = False) -> bool:
        """One publication: a committed save with the publication.json
        sidecar (written before COMMITTED, so the server's watcher never
        sees the step without it) binding this step to the newest ingest
        trace it trained on, one kind="publish" record and one `publish`
        span carrying that trace id. An async save that is skipped
        publishes nothing. Returns whether the publication landed."""
        trace, ingest_ts, consumed_ts = newest
        t0_wall, t0 = time.time(), time.perf_counter()
        step = int(self.state.step)
        pub = {
            "step": step,
            "seq": int(seq),
            "trace": trace,
            "span": new_id(),
            "ingest_ts": round(float(ingest_ts), 6),
            "consumed_ts": round(float(consumed_ts), 6),
            "published_ts": round(t0_wall, 6),
        }
        if not self.save_checkpoint(publication=pub, wait=wait):
            return False
        if self.metrics.enabled:
            self.metrics.log({"kind": "publish", "step": step, "seq": int(seq), "trace": trace,
                              "ingest_ts": pub["ingest_ts"],
                              "published_ts": pub["published_ts"]})
            emit_linked_span(self.metrics, "publish", t0_wall, time.perf_counter() - t0,
                             trace=trace, span=pub["span"], step=step, seq=int(seq))
        return True

    def _feed(self, path: str, skip: int, quarantine: bool, profiler=None):
        """(batch, host arrays) of one pass over `path` after its first
        `skip` batches: run in the prefetch thread, so the read, the
        parse and the plan overlap the device's step. Each batch's slots
        mark the health monitor's bitmap before the plan reorders them;
        `profiler` times the plan. A generator, so the consumer dropping
        the stream closes the reader."""
        for batch in pipeline.batch_iterator(path, self.cfg.data, skip=skip,
                                             quarantine=quarantine, profiler=profiler):
            self._health.observe_batch(batch.slots, batch.mask)
            if profiler is None:
                yield batch, batch_arrays(batch, self.cfg, self.dedup)
                continue
            with profiler.stage("plan"):
                arrays = batch_arrays(batch, self.cfg, self.dedup)
            yield batch, arrays

    def _halt(self, res: TrainResult, bad_run: int) -> None:
        """Abort the run on the guard's verdict; the bad updates were
        discarded, so the live state is the last good one: commit it,
        durably, before raising."""
        cfg = self.cfg
        self.metrics.log({"nonfinite_halt": True, "step": res.steps,
                          "bad_steps": res.bad_steps})
        if cfg.train.checkpoint_dir:
            self.save_checkpoint(wait=True)
        raise NonFiniteHalt(
            f"non-finite guard aborted at step {res.steps}: "
            f"{res.bad_steps} bad step(s), {bad_run} consecutive "
            f"(train.nonfinite_guard={cfg.train.nonfinite_guard}, "
            f"train.nonfinite_max_consecutive={cfg.train.nonfinite_max_consecutive})"
        )

    def _occupancy(self) -> dict:
        """Fraction of slots ever touched by a gradient per table, by the
        JAX trainer's rule: n > 0 under FTRL; under SGD, any column off
        v_init_sgd (0 for scalar tables). The fused table's column 0
        starts at 0, so under SGD it reads 1.0, as in the JAX trainer."""
        out = {}
        for name, t in self.state.tables.items():
            st = self.state.opt_state.get(name, {})
            if "n" in st:
                touched = st["n"] > 0
            else:
                touched = t != (self.cfg.optim.v_init_sgd if t.ndim > 1 else 0.0)
            if touched.ndim > 1:
                touched = touched.any(dim=-1)
            out[name] = float(touched.float().mean())
        return out

    # --------------------------------------------------------------- evaluate
    def evaluate(self, test_path: Optional[str] = None, dump: Optional[bool] = None,
                 block: int = 0, streaming: bool = False) -> tuple[float, float]:
        """(auc, logloss) of the live tables on `test_path` (by default the
        rank-0 shard of data.test_path); logloss keeps the reference's
        sign. Exact (rank-sum AUC) unless train.eval_buckets asks for
        buckets, or `streaming` (an `eval_every` pass) under auto, which
        takes 65,536. `dump` (default train.pred_dump) writes
        `pred_0_<block>.txt` in the working directory: one row a real
        example, `pctr\\t1-label\\tlabel`, in file order."""
        cfg = self.cfg
        path = test_path or shard_path(cfg.data.test_path, 0)
        dump = cfg.train.pred_dump if dump is None else dump
        buckets = resolve_eval_buckets(cfg.train.eval_buckets)
        if streaming and buckets == 0 and cfg.train.eval_buckets < 0:
            buckets = 65536
        if buckets:
            return self._evaluate_bucketed(path, buckets, dump, block)
        with self._pred_file(dump, block) as fout:
            return evaluate(cfg, self.state.tables, path, self.device, fout=fout)

    @staticmethod
    def _pred_file(dump: bool, block: int):
        return open(f"pred_0_{block}.txt", "w") if dump else contextlib.nullcontext()

    def _evaluate_bucketed(self, path: str, num_buckets: int, dump: bool = False,
                           block: int = 0) -> tuple[float, float]:
        """The streaming pass: score-bucket histograms and the summed
        log-likelihood, folded into the decayed window under
        train.eval_window_decay (a bucket-count change resets it)."""
        st = BucketAUC.init(num_buckets)
        ll_sum, n_rows = 0.0, 0.0
        with self._pred_file(dump, block) as fout:
            for batch, p in predict_batches(self.cfg, self.state.tables, path, self.device):
                rm = np.asarray(batch.row_mask) > 0
                y = np.asarray(batch.labels)[rm]
                p = np.asarray(p, np.float64)[rm]
                st = st.update(p, y)
                ll_sum += float(log_likelihood(p, y).sum())
                n_rows += float(rm.sum())
                dump_rows(fout, p, y)
        pos, neg = st.pos, st.neg
        decay = float(self.cfg.train.eval_window_decay)
        if decay > 0:
            prev = self._eval_window
            if prev is not None and prev[0].pos.shape[0] == num_buckets:
                pst = prev[0].decay(decay)
                pos = pos + pst.pos
                neg = neg + pst.neg
                ll_sum += prev[1] * decay
                n_rows += prev[2] * decay
            self._eval_window = (BucketAUC(pos=pos, neg=neg), ll_sum, n_rows)
        if n_rows == 0:
            return float("nan"), float("nan")
        return BucketAUC(pos=pos, neg=neg).compute(), ll_sum / n_rows

    # ------------------------------------------------------------- checkpoint
    def _data_state_record(self) -> dict:
        """The data-stream position saved with every checkpoint, in the
        JAX trainer's version-2 form for one shard and one process."""
        epoch, batches = self._epoch_pos
        return {
            "version": ckpt.DATA_STATE_VERSION,
            "epoch": int(epoch),
            "batches": int(batches),
            "completed": bool(epoch >= self.cfg.train.epochs),
            "examples": int(self._examples_base + self._examples_seen),
            "examples_per_rank": [int(self._examples_seen)],
            # a tail run's position is its segments, not a shard offset
            "shard_batches": {"0": int(batches if self.cfg.data.stream != "tail" else 0)},
            "num_shards": 1,
            "world_size": 1,
            "quarantined_rows": int(pipeline.COUNTERS["quarantined_rows"]),
        }

    def _consume_resume_position(self) -> tuple[int, int]:
        """(start_epoch, batches of shard 0 to skip) for this fit(), from
        the data_state maybe_restore read. Fresh runs, missing or
        malformed data_state and completed checkpoints (continuation
        training) start at (0, 0)."""
        ds = self._resume_data_state
        self._resume_data_state = None
        if not isinstance(ds, dict) or ds.get("completed"):
            return 0, 0
        try:
            epoch = max(int(ds.get("epoch", 0)), 0)
            shards = ds.get("shard_batches")
            if isinstance(shards, dict):
                skip = max(int(shards.get("0", 0)), 0)
            else:  # version 1: the global batch offset
                skip = max(int(ds.get("batches", 0)), 0)
            examples = max(int(ds.get("examples", 0)), 0)
        except (TypeError, ValueError):
            print(
                "xflow: warning: checkpoint data_state is malformed; "
                "resuming with a fresh data stream",
                file=sys.stderr,
            )
            return 0, 0
        self._examples_base, self._examples_seen = examples, 0
        if epoch or skip:
            print(f"resuming data stream at epoch {epoch}, shard offset {skip}", file=sys.stderr)
        return epoch, skip

    def _ckpt_async_on(self) -> bool:
        """train.ckpt_async (the port trains in one process, so the JAX
        package's multi-process gate has nothing to fall back from)."""
        return bool(self.cfg.train.ckpt_async)

    def _ensure_ckpt_writer(self) -> ckpt.AsyncCheckpointWriter:
        if self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointWriter(
                sink=self.metrics, ckpt_spans=self.cfg.train.ckpt_spans)
        return self._ckpt_writer

    def _state_nbytes(self) -> int:
        leaves = list(self.state.tables.values()) + [
            v for st in self.state.opt_state.values() for v in st.values()]
        return int(sum(t.numel() * t.element_size() for t in leaves))

    def _ckpt_span(self, name: str, t0_wall: float, t0: float, step: int) -> None:
        """One kind="span" record a synchronous save (train.ckpt_spans)."""
        if self.cfg.train.ckpt_spans and self.metrics.enabled:
            emit_op_span(self.metrics, name, t0_wall, time.perf_counter() - t0,
                         step=int(step), bytes=self._state_nbytes())

    def save_checkpoint(self, publication: Optional[dict] = None, wait: bool = False) -> bool:
        """Commit the live state with its data_state (and `publication`).
        Synchronous by default: write, prune, mirror into the replica
        tier, prune it; a mirror failure is logged and the primary commit
        stands. With train.ckpt_async the fit loop only snapshots and
        submits (`SaveSnapshot`), the data_state captured here; the busy
        check comes first, since the snapshot's pinned buffers belong to
        a save in flight. Returns False only when an async save was
        skipped; `wait=True` drains first and returns with the save on
        disk (the halt, signal and end-of-run saves)."""
        self._check_format()
        tc = self.cfg.train
        t0_wall, t0 = time.time(), time.perf_counter()
        step = int(self.state.step)
        data_state = self._data_state_record()
        if self._ckpt_async_on():
            w = self._ensure_ckpt_writer()
            if wait:
                w.drain()
            if w.busy():
                w.skip(step, self._state_nbytes(), t0_wall)
                return False
            # the queue instant of an accepted save: after the busy check,
            # so it never precedes the previous save's last record
            t0_wall = time.time()
            snap = ckpt.SaveSnapshot(self.state.tables, self.state.opt_state, step, w.staging)
            ok = w.submit(ckpt.SaveJob(
                snapshot=snap, ckpt_dir=tc.checkpoint_dir, replica_dir=tc.ckpt_replica_dir,
                keep=tc.keep_checkpoints, keep_replica=tc.keep_replica_checkpoints,
                data_state=data_state, publication=publication, queued_ts=t0_wall,
            ))
            if wait:
                w.drain()
            return ok
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()  # never interleave with an async write
        ckpt.save_state(tc.checkpoint_dir, self.state.tables, self.state.opt_state, step,
                        data_state=data_state, publication=publication)
        self._ckpt_span("checkpoint_save", t0_wall, t0, step)
        ckpt.prune_checkpoints(tc.checkpoint_dir, tc.keep_checkpoints)
        if tc.ckpt_replica_dir:
            try:
                ckpt.mirror_step(tc.checkpoint_dir, tc.ckpt_replica_dir, step)
                ckpt.prune_checkpoints(tc.ckpt_replica_dir, tc.keep_replica_checkpoints)
            except Exception as e:  # noqa: BLE001 — never harms the primary
                print(f"# checkpoint: replica mirror of step {step} failed "
                      f"({type(e).__name__}: {e}); the primary commit stands",
                      file=sys.stderr)
        return True

    def maybe_restore(self) -> bool:
        """Restore the newest loadable checkpoint across train.checkpoint_dir
        and train.ckpt_replica_dir (digest-verified, walking back past
        damaged steps) when train.resume is on: a primary step that is
        missing or damaged restores from the replica, and the data_state
        comes from the tier that restored. False when neither holds one."""
        cfg = self.cfg
        if not (cfg.train.checkpoint_dir and cfg.train.resume):
            return False
        self._check_format()
        leaves = tuple(sorted(next(iter(self.state.opt_state.values()), {})))
        try:
            tables, opt, step, src = ckpt.restore_state(
                cfg.train.checkpoint_dir, table_shapes(cfg), leaves,
                verify=cfg.train.checkpoint_verify,
                replica_dir=cfg.train.ckpt_replica_dir or None,
            )
        except FileNotFoundError:
            return False
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        self.state = TrainState(
            tables={n: put(a) for n, a in tables.items()},
            opt_state={n: {k: put(a) for k, a in st.items()} for n, st in opt.items()},
            step=int(step),
        )
        self._resume_data_state = ckpt.read_data_state(src, step)
        return True

    def _check_format(self) -> None:
        if self.cfg.train.checkpoint_format != "npz":
            raise ValueError(
                f"train.checkpoint_format={self.cfg.train.checkpoint_format!r}: "
                "the port reads and writes npz checkpoints"
            )
