"""Training on one device or a mesh (a subset of `xflow_tpu/train/trainer.py`).

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

Elastic resume: the checkpoint's data_state holds each shard's
consumed batches and the shard set in play (`num_shards`), so a run
that wrote it at N ranks resumes at M: the resume takes
``max(saved, world, XFLOW_ORIG_WORLD)`` shards, round-robin over the
data coordinates (`pipeline.assign_shards`), each from its own offset;
one device trains every shard in order. The tables restore onto any
world (rank 0 reads the single-device format and broadcasts it, each
rank keeps its range).

The multi-slice tier (`sync.mode`, `parallel/multislice.py`): every
`sync.every_steps` steps a `SliceSyncer` round exchanges table deltas
with the other slices (a kind="sync" record and a `slice_sync` span),
and a final round runs at the end of the data; a relaunched slice first
adopts the freshest snapshot. Off, the loop is what it was.

`evaluate` is the JAX one on one process: exact, or bucketed
(`train.eval_buckets`; a streaming pass takes 65,536 under auto) with
the decayed window, either writing `pred_0_<block>.txt` rows.

On a mesh (`Trainer(cfg, device, mesh)`, `parallel/`): each rank
drives one device; the engine follows the JAX trainer's choice
(`data.sorted_mesh`: the fully-sharded engine under auto when it
validates, the replicated one when asked, else the row-major sharded
step, which LR always takes). A data coordinate reads its shards
(`pipeline.assign_shards(prefix, d, D)`); one all_reduce(MAX) a pass
fixes the pass's step count, so ragged shards pad with empty batches
instead of deadlocking; one all_reduce(MAX) a batch agrees on the
fully-sharded engine's overflow fallback (and MVM's row side under
`mvm_exclusive=auto`), so every rank runs the same step. Checkpoints
gather the shards and rank 0 writes the single-device format; restore
is rank 0's walk, broadcast. `evaluate` runs on every rank and rank 0
reports and dumps; every rank writes its own records and heartbeat
(the launchers give each rank its own files), stamped with its rank
and world. A signal on any rank stops every rank at the same step: one
all_reduce(MAX) of the pending signal every `train.signal_sync_every`
steps (NCCL with a CUDA tensor, gloo with a CPU one), then a collective
save. The online loop is not taken over on a mesh.

The fit loop's drills (`testing/faults.py`): `XFLOW_FAULT_KILL_STEP`,
the step delay and stall, read once when the run starts.

Not taken over from the JAX trainer: compile accounting and its
roofline gauges (the torch step has no compile step).
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
from xflow_tpu_torch.metrics import (
    BucketAUC,
    auc_logloss,
    log_likelihood,
    resolve_eval_buckets,
)
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
        arrays = to_device(t._prepare(batch, host), t.device)
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
    def __init__(self, cfg: Config, device="cuda", mesh=None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.model = get_model(cfg.model.name)(cfg)
        self.optimizer = get_optimizer(cfg.optim.name)
        self._guarded = nonfinite_guard_on(cfg)  # validates train.nonfinite_guard
        self.dedup = HostDedup(cfg)  # row-major batches; validates data.dedup
        if mesh is None:
            # batches ship as slot-sorted plans (the JAX trainer's
            # single-device rule); validates data.sorted_layout
            self.sorted = sorted_layout_on(cfg)
            self._mesh_engine = None
            self._layout = None
            self.state: TrainState = init_state(self.model, self.optimizer, cfg, device)
            self.train_step = make_train_step(self.model, self.optimizer, cfg)
        else:
            self._init_mesh(cfg, mesh)
        # every rank its own stream, stamped at the first record (by then
        # the rank has joined its world: a flag-started rank stamps its
        # rank and world from it; a slice, XFLOW_PROCESS_ID = its index)
        self.metrics = MetricsLogger(cfg.train.metrics_path,
                                     max_bytes=cfg.train.metrics_max_bytes)
        # liveness: {step} records, and start/checkpoint/eval/sync/final events
        self.heartbeat = JsonlAppender(cfg.train.heartbeat_path, stamp={"kind": "heartbeat"})
        # the multi-slice sync tier (None when off: the loop is unchanged)
        self._syncer = None
        if cfg.sync.mode != "off":
            if mesh is not None:
                raise ValueError("sync.mode: the multi-slice tier runs slices of one device "
                                 "each; it is not taken over on a mesh")
            from xflow_tpu_torch.parallel.multislice import SliceSyncer
            from xflow_tpu_torch.telemetry import resolve_num_slices, resolve_slice

            self._syncer = SliceSyncer(cfg.sync, slice_id=resolve_slice() or 0,
                                       num_slices=resolve_num_slices())
        self._health = HealthMonitor(mode=health_mode(cfg),
                                     ema_decay=cfg.train.health_ema_decay,
                                     num_slots=cfg.num_slots)
        # the training stream's stage profiler (evaluation stays unprofiled)
        self.pipeline_prof = PipelineProfiler() if cfg.train.pipeline_metrics else None
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointWriter] = None  # started lazily
        # data-stream position pinned by the next checkpoint's data_state:
        # (epoch, the pass's step offset), each shard's batches consumed in
        # the epoch, the shard set in play, and the shard of the batch
        # being stepped (None: a padding batch)
        self._epoch_pos = (0, 0)
        self._shard_pos: dict = {}
        self._num_shards = 0
        self._last_shard: Optional[int] = None
        self._fs_overflow_warned = False
        self._examples_seen = 0
        self._examples_base = 0
        self._resume_data_state: Optional[dict] = None
        # the decayed eval window (BucketAUC, ll_sum, rows), from the
        # first pass under train.eval_window_decay
        self._eval_window: Optional[tuple] = None

    # ------------------------------------------------------------------- mesh
    def _init_mesh(self, cfg: Config, mesh) -> None:
        """The JAX trainer's engine selection on a mesh: `data.sorted_mesh`
        "fullshard" (under auto, whenever it validates) or "replicated"
        (only under sorted_layout=on), else the row-major sharded step;
        `optim.fused_scatter=on` raises at startup (the mesh engines run
        the two-pass form). The state is initialised whole from
        `train.seed`, as on one device, and each rank keeps its range."""
        from xflow_tpu_torch.parallel import train_step as ts
        from xflow_tpu_torch.parallel.mesh import check_divisible, shard_tensor
        from xflow_tpu_torch.parallel.sorted_fullshard import (
            make_fullshard_eval_step,
            make_fullshard_train_step,
            validate_sorted_fullshard,
        )
        from xflow_tpu_torch.parallel.sorted_sharded import (
            make_sorted_sharded_train_step,
            validate_sorted_sharded,
        )

        engine = cfg.data.sorted_mesh
        if engine not in ("fullshard", "replicated"):
            raise ValueError(
                f"data.sorted_mesh={engine!r}: expected 'fullshard' or 'replicated'")
        sl = cfg.data.sorted_layout
        if sl not in ("auto", "on", "off"):
            raise ValueError(f"data.sorted_layout={sl!r}: expected auto|on|off")
        self._mesh_engine = None
        if sl == "on":
            (validate_sorted_fullshard if engine == "fullshard" else validate_sorted_sharded)(
                cfg, mesh)
            self._mesh_engine = engine
        elif sl == "auto" and engine == "fullshard":
            try:
                validate_sorted_fullshard(cfg, mesh)
                self._mesh_engine = "fullshard"
            except ValueError:
                self._mesh_engine = None
        self.sorted = self._mesh_engine is not None
        if cfg.optim.fused_scatter not in ("auto", "on", "off"):
            raise ValueError(
                f"optim.fused_scatter={cfg.optim.fused_scatter!r}: expected auto|on|off")
        if cfg.optim.fused_scatter == "on":
            raise ValueError(
                "optim.fused_scatter=on requires the single-device "
                "step; mesh engines run the two-pass form — use auto "
                "(fuses where eligible) or off"
            )
        self._layout = "table" if self._mesh_engine == "replicated" else "full"
        check_divisible(cfg.num_slots, mesh)
        whole = init_state(self.model, self.optimizer, cfg, "cpu")

        def put(x):
            return shard_tensor(x, mesh, self._layout).to(self.device)

        self.state = TrainState({n: put(t) for n, t in whole.tables.items()},
                                {n: {k: put(v) for k, v in st.items()}
                                 for n, st in whole.opt_state.items()}, 0)
        del whole
        row_step = ts.make_sharded_train_step(self.model, self.optimizer, cfg, mesh,
                                              self._layout)
        row_eval = ts.make_sharded_eval_step(self.model, cfg, mesh, self._layout)
        if self._mesh_engine == "fullshard":
            fs_step = make_fullshard_train_step(self.optimizer, cfg, mesh)
            fs_eval = make_fullshard_eval_step(cfg, mesh)
            # a batch that overflowed the buffers arrives as a row share and
            # runs the row-major step: the same layout, so the two interleave
            self.train_step = lambda st, b: (fs_step if "fs_slots" in b else row_step)(st, b)
            self.eval_step = lambda tb, b: (fs_eval if "fs_slots" in b else row_eval)(tb, b)
        elif self._mesh_engine == "replicated":
            self.train_step = make_sorted_sharded_train_step(self.optimizer, cfg, mesh)
            self.eval_step = row_eval
        else:
            self.train_step = row_step
            self.eval_step = row_eval

    def _host_arrays(self, batch, train: bool = True) -> dict:
        """A batch's host arrays: on one device `evaluate.batch_arrays`; on
        a mesh this rank's buffers of the fully-sharded engine (with the
        overflow and MVM duplicate flags the main thread agrees on), the
        replicated engine's flat plan (training), or the rank's row share."""
        cfg, mesh = self.cfg, self.mesh
        if mesh is None:
            return batch_arrays(batch, cfg, self.dedup)
        from xflow_tpu_torch.models.mvm import has_field_duplicates, resolve_mvm_product
        from xflow_tpu_torch.parallel.train_step import row_share

        mvm, ffm = cfg.model.name == "mvm", cfg.model.name == "ffm"
        if (mvm or ffm) and batch.fields.size and int(batch.fields.max()) >= cfg.model.num_fields:
            raise ValueError(
                f"libffm field id {int(batch.fields.max())} >= model.num_fields="
                f"{cfg.model.num_fields}; raise model.num_fields")
        if self._mesh_engine == "fullshard":
            from xflow_tpu_torch.parallel.sorted_fullshard import (
                FullshardOverflowError,
                fullshard_arrays,
            )

            dup = None
            if mvm:
                excl = cfg.model.mvm_exclusive
                if excl == "auto":
                    # plan with fields; the ranks agree on the row side
                    want, dup = True, bool(has_field_duplicates(batch.fields, batch.mask))
                else:
                    has = excl != "off" and has_field_duplicates(batch.fields, batch.mask)
                    want = not resolve_mvm_product(excl, has, mesh.size)
            else:
                want = ffm
            try:
                out = fullshard_arrays(batch, cfg, mesh, want)
                if dup is not None:
                    out["_mvm_dup"] = dup
                return out
            except FullshardOverflowError:
                if not self._fs_overflow_warned:
                    self._fs_overflow_warned = True
                    print(f"fullshard: batch too skewed for data.fullshard_slack="
                          f"{cfg.data.fullshard_slack}; falling back to the row-major "
                          "sharded step for such batches (raise the slack to keep the "
                          "fast path)", file=sys.stderr)
                    self.metrics.log({"fullshard_overflow_fallback": True})
                out = row_share(_row_major(batch), mesh)
                out["_fs_overflow"] = True
                return out
        if self._mesh_engine == "replicated" and train:
            from xflow_tpu_torch.parallel.sorted_sharded import sorted_arrays

            return sorted_arrays(batch, cfg)
        return row_share(_row_major(batch), mesh)

    def _prepare(self, batch, host: dict) -> dict:
        """On the main thread, before the transfer: pop the mesh markers
        and agree on the fully-sharded engine's per-batch choices with
        one all_reduce(MAX) of [overflowed, MVM duplicate] over the world:
        any overflow sends every rank to the row-major step for this batch
        (a rank whose plan fit rebuilds its row share from the batch), and
        MVM's product row side runs only when no rank saw a duplicate
        field. The batch's `_shard` marker (None: padding) goes to
        `_last_shard`, for the per-shard position."""
        self._last_shard = host.pop("_shard", None)
        if self.mesh is None:
            return host
        over = bool(host.pop("_fs_overflow", False))
        dup = host.pop("_mvm_dup", None)
        if self._mesh_engine != "fullshard":
            return host
        from xflow_tpu_torch.parallel import collectives as C
        from xflow_tpu_torch.parallel.train_step import row_share

        any_over, any_dup = C.reduce_host([over, bool(dup)], "max", device=self.mesh.device)
        if any_over:
            default_registry().counter("fullshard.overflow_fallback").inc()
            if not over:
                host = row_share(_row_major(batch), self.mesh)
        elif dup is not None and not any_dup:
            host.pop("fs_fields", None)
        return host

    def _mesh_feed(self, shards: list, skips: dict, quarantine: bool, profiler=None,
                   train: bool = True):
        """The data coordinate's (batch, host arrays) for one pass over
        `shards` ([(index, path)]), each shard after its `skips` batches,
        exactly the pass's agreed step count long: one all_reduce(MAX) of
        the local batch counts (here, on the main thread), then the real
        batches (marked `_shard`) and empty padding batches. Raises when
        the parser yields another count than the counter (a file that
        changed under the pass)."""
        from xflow_tpu_torch.parallel import collectives as C

        local = 0
        for idx, p in shards:
            if os.path.exists(p):
                local += max(pipeline.count_batches(p, self.cfg.data)
                             - max(int(skips.get(idx, 0)), 0), 0)
        (steps,) = C.reduce_host([local], "max", device=self.mesh.device)
        cfg = self.cfg

        def feed():
            produced = 0
            for idx, p in shards:
                if not os.path.exists(p):
                    continue
                s = max(int(skips.get(idx, 0)), 0)
                for batch in pipeline.batch_iterator(
                        p, cfg.data, skip=s, quarantine=quarantine and train,
                        enforce_bad_rows=train, profiler=profiler):
                    if train:
                        self._health.observe_batch(batch.slots, batch.mask)
                    if profiler is None:
                        host = self._host_arrays(batch, train)
                    else:
                        with profiler.stage("plan"):
                            host = self._host_arrays(batch, train)
                    host["_shard"] = idx
                    produced += 1
                    yield batch, host
            if produced != local:
                raise RuntimeError(
                    f"batch count drift on {[p for _, p in shards]}: counted {local}, "
                    f"parser produced {produced}")
            for _ in range(steps - produced):
                empty = _empty_batch(cfg)
                yield empty, self._host_arrays(empty, train)

        return feed()

    def _shards(self, prefix: str) -> list:
        """This data coordinate's [(shard index, path)] of the shard set
        in play (one device: coordinate 0 of 1)."""
        d, D = (0, 1) if self.mesh is None else (self.mesh.d, self.mesh.data)
        return pipeline.assign_shards(prefix, d, D, max(self._num_shards, D))

    def _train_feed(self, shards: list, skips: dict, quarantine: bool, profiler=None):
        """The training stream of one epoch: (batch, host arrays) over
        `shards`, each after its `skips` batches, every real batch marked
        with its shard (the fault injectors wrap this seam)."""
        if self.mesh is not None:
            return self._mesh_feed(shards, skips, quarantine, profiler)

        def feed():
            for idx, p in shards:
                if os.path.exists(p):  # an elastic resume's missing shard idles
                    yield from self._feed(p, max(int(skips.get(idx, 0)), 0), quarantine,
                                          profiler, shard=idx)

        return feed()

    # ------------------------------------------------------------------ train
    def _install_signal_checkpoint(self):
        """SIGTERM/SIGINT (train.ckpt_on_signal, with a checkpoint dir)
        set a flag the fit loop reads at its coordination points: it then
        commits the step reached and returns. One device reads it after
        every step; a mesh agrees on it every `train.signal_sync_every`
        steps (`_coordinated_signal`), and with that cadence 0 installs
        nothing (the config is the same on every rank, so every rank
        skips the agreement). The handler only writes the flag and puts
        the previous handlers back, so a second signal acts as it would
        have. Off the main thread no handler is installed, but a mesh
        rank still takes part in the agreement (an empty flag). Returns
        (flag dict or None, restore)."""
        cfg = self.cfg
        multiproc_ok = self.mesh is None or cfg.train.signal_sync_every > 0
        if not (cfg.train.ckpt_on_signal and cfg.train.checkpoint_dir and multiproc_ok):
            return None, lambda: None
        if threading.current_thread() is not threading.main_thread():
            return {}, lambda: None
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

    def _coordinated_signal(self, sig_flag: Optional[dict]) -> int:
        """The stop decision, the same on every rank: the local flag on
        one device; on a mesh one all_reduce(MAX) of the pending signals
        over the world (a CUDA tensor on NCCL, a CPU one on gloo), so a
        signal on any rank stops every rank at the same step. A rank that
        adopts a peer's signal reports it."""
        if sig_flag is None:
            return 0
        mine = self._signalled(sig_flag)
        if self.mesh is None:
            return mine
        from xflow_tpu_torch.parallel import collectives as C

        (got,) = C.reduce_host([mine], "max", device=self.mesh.device)
        if got and not mine:
            sig_flag["sig"] = got
        return got

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

    def _epoch_shards(self, train_path: Optional[str], resume_skips: dict) -> list:
        """The shard set this rank trains, [(index, path)]: `train_path`
        alone when given, else its data coordinate's round-robin share of
        ``max(saved, data coordinates, XFLOW_ORIG_WORLD)`` shards (a fresh
        run: one shard a coordinate). Warns for a resumed shard whose
        file is missing: its remaining rows are lost."""
        cfg = self.cfg
        try:
            orig_world = int(os.environ.get("XFLOW_ORIG_WORLD", 0) or 0)
        except ValueError:
            orig_world = 0
        D = 1 if self.mesh is None else self.mesh.data
        self._num_shards = max(self._num_shards, D, orig_world)
        if train_path:
            shards = [(0 if self.mesh is None else self.mesh.d, train_path)]
        else:
            shards = self._shards(cfg.data.train_path)
        for idx, p in shards:
            if resume_skips.get(idx, 0) > 0 and not os.path.exists(p):
                print(f"xflow: warning: resumed shard {idx} ({p!r}) is missing from this "
                      "host — its remaining records will NOT be trained (per-host shard "
                      "files are not visible to the surviving ranks; keep shards on a "
                      "shared filesystem for elastic shrink)", file=sys.stderr)
        if self.mesh is None and not any(os.path.exists(p) for _, p in shards):
            raise FileNotFoundError(shards[0][1])
        return shards

    def _sync_round(self, log: "_StepLog", hang: HangWatchdog) -> None:
        """One multi-slice round at a sync boundary, bracketed as a
        checkpoint is: the staged record lands first (a peer may kill us
        believing the delta landed), beats around the bounded wait, the
        kind="sync" record and a `slice_sync` span stamped with the global
        step (its `split_ms` the round's parts, `SliceSyncer.last_split`),
        a tick after."""
        res = log.res
        log.emit()
        self.heartbeat.append({"step": res.steps, "event": "sync"})
        t0_wall, t0 = time.time(), time.perf_counter()
        self.state, rec = self._syncer.sync(self.state)
        if self.metrics.enabled:
            gstep = int(self.state.step)
            self.metrics.log({"step": gstep, **rec})
            emit_op_span(self.metrics, "slice_sync", t0_wall, time.perf_counter() - t0,
                         step=gstep, round=rec["round"],
                         bytes=rec["bytes_out"] + rec["bytes_in"],
                         split_ms={k: round(v, 3) for k, v in self._syncer.last_split.items()})
        self.heartbeat.append({"step": res.steps})
        hang.tick()
        log.mark = None

    def _fit(self, train_path: Optional[str] = None) -> TrainResult:
        cfg = self.cfg
        if cfg.data.stream not in ("off", "tail"):
            raise ValueError(f"data.stream={cfg.data.stream!r}: expected 'off' or 'tail'")
        if cfg.data.stream == "tail":
            if self.mesh is not None:
                raise ValueError("data.stream=tail: the online loop runs on one device; "
                                 "it is not taken over on a mesh")
            return self._fit_tail(train_path)
        from xflow_tpu_torch.telemetry import resolve_restart_gen
        from xflow_tpu_torch.testing.faults import fit_delays_from_env, hard_kill, \
            kill_step_from_env

        start_epoch, resume_skips = self._consume_resume_position()
        shards = self._epoch_shards(train_path, resume_skips)
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
        # the drills, read once (no cost a step when unset)
        step_delay_s, stall_step, stall_s = fit_delays_from_env(self.rank)
        kill_step = kill_step_from_env(self.rank)
        hb_every = cfg.train.heartbeat_every
        if cfg.train.eval_every and not cfg.data.test_path:
            print("xflow: warning: train.eval_every is set but data.test_path is empty — "
                  "no streaming eval will run", file=sys.stderr)
        self.heartbeat.append({"event": "start", "step": 0})
        sig_flag, sig_restore = self._install_signal_checkpoint()
        sync_every = cfg.train.signal_sync_every
        self._epoch_pos = (start_epoch, max(resume_skips.values(), default=0))
        if self._syncer is not None:
            # a relaunched slice catches up from the freshest snapshot (its
            # own checkpoint gave the step and the data position), then the
            # delta base is fixed at the state entering the loop
            if resolve_restart_gen() > 0:
                t0_wall, t0 = time.time(), time.perf_counter()
                self.state, adopted = self._syncer.adopt_latest_snapshot(self.state)
                if adopted is not None:
                    print(f"multislice: slice {self._syncer.slice_id} caught up from snapshot "
                          f"round {adopted[0]} (published by slice {adopted[1]})",
                          file=sys.stderr)
                    self._ckpt_span("sync_catchup", t0_wall, t0, int(self.state.step))
            self._syncer.attach(self.state)
        stop_sig = 0
        halted = False
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                # the resume offsets apply to the first (partly consumed) epoch
                skips = resume_skips if epoch == start_epoch else {}
                self._shard_pos = {idx: max(int(skips.get(idx, 0)), 0) for idx, _ in shards}
                offset = max(self._shard_pos.values(), default=0)
                log.mark = None
                feed = self._train_feed(shards, skips, quarantine=epoch == 0, profiler=prof)
                # closing: a halt or an error stops the reader thread at once
                with contextlib.closing(pipeline.prefetch(feed, profiler=prof)) as stream:
                    for batch, host in log.timer.batches(stream):
                        offset += 1
                        trace.before_step(res.steps + 1)
                        if step_delay_s:
                            time.sleep(step_delay_s)
                        m = log.dispatch(batch, host)
                        hang.tick()
                        self._count_step(res, batch, (epoch, offset))
                        if hb_every and res.steps % hb_every == 0:
                            self.heartbeat.append({"step": res.steps})
                        if stall_s and res.steps == stall_step:
                            time.sleep(stall_s)  # the one-shot straggler stall
                            stall_s = 0.0
                        if log.check_pending():
                            halted = True
                            break
                        log.stage(m, epoch)
                        if (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
                                and res.steps % cfg.train.checkpoint_every == 0):
                            self._cadence_save(log, hang, self.save_checkpoint)
                        if (self._syncer is not None and cfg.sync.every_steps
                                and res.steps % cfg.sync.every_steps == 0):
                            # after the checkpoint cadence: a kill in the round
                            # leaves the boundary's checkpoint committed
                            self._sync_round(log, hang)
                        if kill_step and res.steps == kill_step:
                            log.emit()
                            print(f"xflow: fault injector: hard-killing rank {self.rank} at "
                                  f"step {res.steps} (XFLOW_FAULT_KILL_STEP)",
                                  file=sys.stderr, flush=True)
                            hard_kill()
                        if self.mesh is None or (sync_every and res.steps % sync_every == 0):
                            stop_sig = self._coordinated_signal(sig_flag)
                            if stop_sig:
                                break
                if halted:
                    break
                if not stop_sig:  # an interrupted epoch keeps its mid-epoch position
                    self._epoch_pos = (epoch + 1, 0)
                    self._shard_pos = {}
                res.epochs = epoch + (0 if stop_sig else 1)
                if not stop_sig:
                    if (epoch + 1) % 30 == 0:
                        print(f"epoch : {epoch}", file=sys.stderr)
                    if (cfg.train.eval_every and cfg.data.test_path
                            and (epoch + 1) % cfg.train.eval_every == 0):
                        self._eval_pass(res.steps, epoch, hang, gauges=True)
                    # the epoch's end is a coordination point too
                    stop_sig = self._coordinated_signal(sig_flag)
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
        # the final round folds the tail block's delta and the peers' in
        # (not on a signal: the grace period funds no staleness wait)
        if self._syncer is not None and res.steps and not stop_sig:
            self._sync_round(log, hang)
        if self.mesh is not None:
            # every data coordinate's rows (its T ranks count the same ones)
            from xflow_tpu_torch.parallel import collectives as C

            share = res.examples if self.mesh.t == 0 else 0
            (res.examples,) = C.reduce_host([share], "sum", device=self.mesh.device)
        res.occupancy = self._occupancy()
        log.final_record()
        if cfg.train.checkpoint_dir:
            self.save_checkpoint(wait=True)
        return res

    def _count_step(self, res: TrainResult, batch, pos: tuple) -> None:
        """A dispatched step's accounting, the stream position `pos`
        (epoch, the pass's step offset) it reaches and its shard's."""
        rows = batch.num_rows
        res.steps += 1
        res.examples += rows
        self._examples_seen += rows
        self._epoch_pos = pos
        if self._last_shard is not None:
            idx = self._last_shard
            self._shard_pos[idx] = self._shard_pos.get(idx, 0) + 1

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

    def _feed(self, path: str, skip: int, quarantine: bool, profiler=None,
              shard: Optional[int] = None):
        """(batch, host arrays) of one pass over `path` after its first
        `skip` batches: run in the prefetch thread, so the read, the
        parse and the plan overlap the device's step. Each batch's slots
        mark the health monitor's bitmap before the plan reorders them;
        `profiler` times the plan; `shard` marks the arrays. A generator,
        so the consumer dropping the stream closes the reader."""
        for batch in pipeline.batch_iterator(path, self.cfg.data, skip=skip,
                                             quarantine=quarantine, profiler=profiler):
            self._health.observe_batch(batch.slots, batch.mask)
            if profiler is None:
                arrays = batch_arrays(batch, self.cfg, self.dedup)
            else:
                with profiler.stage("plan"):
                    arrays = batch_arrays(batch, self.cfg, self.dedup)
            if shard is not None:
                arrays["_shard"] = shard
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
            if self.mesh is None:
                out[name] = float(touched.float().mean())
            else:
                from xflow_tpu_torch.parallel import collectives as C

                n = C.reduce_sum_tensor(touched.sum(), self.mesh.owner_group(self._layout))
                out[name] = float(n) / self.cfg.num_slots
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
        dump = cfg.train.pred_dump if dump is None else dump
        buckets = resolve_eval_buckets(cfg.train.eval_buckets)
        if streaming and buckets == 0 and cfg.train.eval_buckets < 0:
            buckets = 65536
        if self.mesh is not None:
            return self._evaluate_mesh(test_path, buckets, dump, block)
        path = test_path or shard_path(cfg.data.test_path, 0)
        if buckets:
            return self._evaluate_bucketed(path, buckets, dump, block)
        with self._pred_file(dump, block) as fout:
            return evaluate(cfg, self.state.tables, path, self.device, fout=fout)

    def _pred_file(self, dump: bool, block: int):
        return (open(f"pred_0_{block}.txt", "w") if dump and self.rank == 0
                else contextlib.nullcontext())

    def _mesh_predictions(self, test_path: Optional[str]):
        """(pctr, label, row_mask) float64 [rows, 3] of every data
        coordinate's rows, batch by batch, the same on every rank: each
        coordinate predicts its test shards (`assign_shards`; an explicit
        `test_path` file is coordinate 0's alone) with the engine's eval
        step, and the rows are gathered over `data`."""
        from xflow_tpu_torch.parallel import collectives as C

        mesh = self.mesh
        if test_path:
            shards = [(0, test_path)] if mesh.d == 0 else []
        else:
            shards = self._shards(self.cfg.data.test_path)
        stream = pipeline.prefetch(self._mesh_feed(shards, {}, False, train=False))
        try:
            for batch, host in stream:
                arrays = to_device(self._prepare(batch, host), self.device)
                R = batch.labels.shape[0]
                p = self.eval_step(self.state.tables, arrays)[:R].float()
                y = torch.as_tensor(np.asarray(batch.labels, np.float32), device=p.device)
                rm = torch.as_tensor(np.asarray(batch.row_mask, np.float32), device=p.device)
                local = torch.stack([p, y, rm], dim=1)
                yield C.all_gather(local.contiguous(), mesh.data_group).cpu().numpy()
        finally:
            stream.close()

    def _evaluate_mesh(self, test_path: Optional[str], buckets: int, dump: bool,
                       block: int) -> tuple[float, float]:
        """`evaluate` on a mesh: every rank takes part and computes the
        same (auc, logloss); rank 0 dumps."""
        st = BucketAUC.init(buckets) if buckets else None
        pctrs, labels = [], []
        ll_sum, n_rows = 0.0, 0.0
        with self._pred_file(dump, block) as fout:
            for rows in self._mesh_predictions(test_path):
                rm = rows[:, 2] > 0
                p, y = rows[rm, 0].astype(np.float64), rows[rm, 1]
                dump_rows(fout if self.rank == 0 else None, p, y)
                if st is None:
                    pctrs.append(p)
                    labels.append(y)
                    continue
                st = st.update(p, y)
                ll_sum += float(log_likelihood(p, y).sum())
                n_rows += float(rm.sum())
        if st is None:
            if not pctrs:
                return float("nan"), float("nan")
            return auc_logloss(np.concatenate(pctrs), np.concatenate(labels))
        return self._fold_window(st, ll_sum, n_rows, buckets)

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
        return self._fold_window(st, ll_sum, n_rows, num_buckets)

    def _fold_window(self, st, ll_sum: float, n_rows: float,
                     num_buckets: int) -> tuple[float, float]:
        """A streaming pass's result, folded into the decayed window
        under train.eval_window_decay."""
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
        """The data-stream position saved with every checkpoint, the JAX
        trainer's topology-independent version-2 form: the epoch, the
        pass's step offset (informational), each shard's batches consumed
        in the epoch (`shard_batches`, what a resume at any world reads),
        the shard set in play (`num_shards`), the global examples and the
        quarantine count. On a mesh (a collective: every rank calls it at
        the same step) one all_reduce(SUM) gathers the data coordinates'
        shard positions and examples (the table axis's ranks count the
        same rows, so only t = 0 contributes)."""
        epoch, batches = self._epoch_pos
        tail = self.cfg.data.stream == "tail"
        D = 1 if self.mesh is None else self.mesh.data
        num_shards = max(self._num_shards, D, 1)
        local = [0] * num_shards
        if not tail:  # a tail run's position is its segments, not a shard offset
            for idx, n in self._shard_pos.items():
                if 0 <= int(idx) < num_shards:
                    local[int(idx)] = int(n)
        if self.mesh is None:
            shard_batches = local
            per_rank = [int(self._examples_seen)]
            world = 1
        else:
            from xflow_tpu_torch.parallel import collectives as C

            vec = [0] * (num_shards + D)
            if self.mesh.t == 0:
                vec[:num_shards] = local
                vec[num_shards + self.mesh.d] = self._examples_seen
            vec = C.reduce_host(vec, "sum", device=self.mesh.device)
            shard_batches = vec[:num_shards]
            per_rank = [int(v) for v in vec[num_shards:]]
            world = self.mesh.size
        return {
            "version": ckpt.DATA_STATE_VERSION,
            "epoch": int(epoch),
            "batches": int(batches),
            "completed": bool(epoch >= self.cfg.train.epochs),
            "examples": int(self._examples_base + sum(per_rank)),
            "examples_per_rank": per_rank,
            "shard_batches": {str(i): int(v) for i, v in enumerate(shard_batches)},
            "num_shards": int(num_shards),
            "world_size": int(world),
            "quarantined_rows": int(pipeline.COUNTERS["quarantined_rows"]),
        }

    def _consume_resume_position(self) -> tuple[int, dict]:
        """(start_epoch, {shard index: batches to skip}) for this fit(),
        from the data_state maybe_restore read, whatever world wrote it
        (`checkpoint.normalize_data_state`): the shard set it covered
        joins `_num_shards`, and its examples become the base. Fresh
        runs, a missing or malformed data_state and completed checkpoints
        (continuation training, which keeps the shard set) start at
        (0, {})."""
        ds_raw = self._resume_data_state
        self._resume_data_state = None
        if not isinstance(ds_raw, dict) or ds_raw.get("completed"):
            if isinstance(ds_raw, dict):
                try:
                    self._num_shards = max(self._num_shards,
                                           ckpt.normalize_data_state(ds_raw)["num_shards"])
                except (TypeError, ValueError):
                    pass
            return 0, {}
        try:
            ds = ckpt.normalize_data_state(ds_raw)
        except (TypeError, ValueError):
            print("xflow: warning: checkpoint data_state is malformed; "
                  "resuming with a fresh data stream", file=sys.stderr)
            return 0, {}
        self._examples_base, self._examples_seen = ds["examples"], 0
        self._num_shards = max(self._num_shards, ds["num_shards"])
        epoch, skips = ds["epoch"], ds["shard_batches"]
        world = 1 if self.mesh is None else self.mesh.size
        if epoch or any(skips.values()):
            from xflow_tpu_torch.telemetry import resolve_restart_gen

            note = (f"; resharding {ds['num_shards']} shard(s) from {ds['world_size']} rank(s) "
                    f"onto {world}" if ds["world_size"] != world else "")
            print(f"resuming data stream at epoch {epoch}, shard offsets "
                  f"{[skips.get(i, 0) for i in range(ds['num_shards'])]} "
                  f"(restart generation {resolve_restart_gen()}){note}", file=sys.stderr)
        return epoch, skips

    def _ckpt_async_on(self) -> bool:
        """train.ckpt_async (the port trains in one process, so the JAX
        package's multi-process gate has nothing to fall back from)."""
        return bool(self.cfg.train.ckpt_async)

    def _ensure_ckpt_writer(self) -> ckpt.AsyncCheckpointWriter:
        if self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointWriter(
                sink=self.metrics, ckpt_spans=self.cfg.train.ckpt_spans)
        return self._ckpt_writer

    def _state_nbytes(self, state: Optional[TrainState] = None) -> int:
        state = state or self.state
        leaves = list(state.tables.values()) + [
            v for st in state.opt_state.values() for v in st.values()]
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
        state = self.state
        if self.mesh is not None:
            # the shards gathered whole (a collective); rank 0 writes them
            from xflow_tpu_torch.parallel.train_step import gather_state

            state = gather_state(self.state, self.mesh, self._layout)
            if self.rank != 0:
                return True
        if self._ckpt_async_on():
            w = self._ensure_ckpt_writer()
            if wait:
                w.drain()
            if w.busy():
                w.skip(step, self._state_nbytes(state), t0_wall)
                return False
            # the queue instant of an accepted save: after the busy check,
            # so it never precedes the previous save's last record
            t0_wall = time.time()
            snap = ckpt.SaveSnapshot(state.tables, state.opt_state, step, w.staging)
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
        ckpt.save_state(tc.checkpoint_dir, state.tables, state.opt_state, step,
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
        if self.mesh is not None:
            try:
                tables, opt, step, ds = ckpt.restore_state_mesh(
                    cfg.train.checkpoint_dir, table_shapes(cfg), leaves, self.mesh,
                    self._layout, self.device, verify=cfg.train.checkpoint_verify,
                    replica_dir=cfg.train.ckpt_replica_dir or None)
            except FileNotFoundError:
                return False
            self.state = TrainState(tables, opt, int(step))
            self._resume_data_state = ds
            return True
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


def _row_major(batch) -> dict:
    return {"slots": batch.slots, "fields": batch.fields, "mask": batch.mask,
            "labels": batch.labels, "row_mask": batch.row_mask}


def _empty_batch(cfg: Config):
    """A fully masked batch: the padding step of a data coordinate whose
    shards ran out before the pass's agreed step count."""
    from xflow_tpu_torch.data.schema import SparseBatch

    B, F = cfg.data.batch_size, cfg.data.max_nnz
    return SparseBatch(
        slots=np.zeros((B, F), np.int32),
        fields=np.zeros((B, F), np.int32),
        mask=np.zeros((B, F), np.float32),
        labels=np.zeros((B,), np.float32),
        row_mask=np.zeros((B,), np.float32),
    )
