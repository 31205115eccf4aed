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

The online loop (`data.stream=tail`, `_fit_tail`): a `TailFollower`
spools the growing input into sealed segments inside the same prefetch
thread, each segment's batches take the same read, plan and step, and
every `train.publish_every` steps a checkpoint commits with a
publication sidecar naming the newest ingest trace a step consumed,
which the server reports as freshness.

Checkpoints: synchronous, or with `train.ckpt_async` a snapshot the fit
loop hands to one writer thread (`train/checkpoint.py`); either way
pruned (`keep_checkpoints`) and mirrored into `ckpt_replica_dir`.
SIGTERM/SIGINT (`ckpt_on_signal`) commit the step reached and end the
run with `interrupted`. The run's records (`train.metrics_path`):
`ingest`, `ckpt`, `publish`, `span` (`checkpoint_save`, `publish`),
`interrupted`, `nonfinite_skipped` and `nonfinite_halt`.

Not taken over from the JAX trainer: the per-step and `final` metrics
records with `StepTimer`, the heartbeat, the hang watchdog, health
norms, `eval_every`, the trace window and pipeline profiler, and
multi-process coordination.
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

import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data import pipeline
from xflow_tpu_torch.data.libffm import shard_path
from xflow_tpu_torch.evaluate import (
    HostDedup,
    batch_arrays,
    evaluate,
    sorted_layout_on,
    to_device,
)
from xflow_tpu_torch.jsonl import JsonlAppender
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.tracing import emit_linked_span, emit_op_span, new_id
from xflow_tpu_torch.train import checkpoint as ckpt
from xflow_tpu_torch.train.state import TrainState, init_state
from xflow_tpu_torch.train.step import make_train_step, nonfinite_guard_on
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


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.model = get_model(cfg.model.name)(cfg)
        self.optimizer = get_optimizer(cfg.optim.name)
        # batches ship as slot-sorted plans (the JAX trainer's single-device
        # rule); validates data.sorted_layout at construction
        self.sorted = sorted_layout_on(cfg)
        nonfinite_guard_on(cfg)  # validates train.nonfinite_guard
        self.dedup = HostDedup(cfg)  # row-major batches; validates data.dedup
        self.state: TrainState = init_state(self.model, self.optimizer, cfg, device)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)
        self.metrics = MetricsLogger(cfg.train.metrics_path)
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointWriter] = None  # started lazily
        # data-stream position pinned by the next checkpoint's data_state:
        # (epoch, batches consumed within it) of the one shard
        self._epoch_pos = (0, 0)
        self._examples_seen = 0
        self._examples_base = 0
        self._resume_data_state: Optional[dict] = None

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
        start_epoch, skip = self._consume_resume_position()
        sig_flag, sig_restore = self._install_signal_checkpoint()
        stop_sig = 0
        bad_run = 0
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                offset = skip if epoch == start_epoch else 0
                # closing: a halt or an error stops the reader thread at once
                with contextlib.closing(pipeline.prefetch(
                        self._feed(path, offset, quarantine=epoch == 0))) as stream:
                    for batch, host in stream:
                        offset += 1
                        bad_run = self._step(res, batch, host, bad_run, (epoch, offset))
                        if (
                            cfg.train.checkpoint_dir
                            and cfg.train.checkpoint_every
                            and res.steps % cfg.train.checkpoint_every == 0
                        ):
                            self.save_checkpoint()
                        stop_sig = self._signalled(sig_flag)
                        if stop_sig:
                            break
                if stop_sig:  # an interrupted epoch keeps its mid-epoch position
                    self._interrupted(res, stop_sig)
                    break
                self._epoch_pos = (epoch + 1, 0)
                res.epochs = epoch + 1
        finally:
            sig_restore()
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)
        res.seconds = time.perf_counter() - start
        res.occupancy = self._occupancy()
        if cfg.train.checkpoint_dir:
            self.save_checkpoint(wait=True)
        return res

    def _step(self, res: TrainResult, batch, host: dict, bad_run: int, pos: tuple) -> int:
        """One train step on a batch's host arrays, its accounting, the
        stream position `pos` (epoch, batches) it reaches, and the
        non-finite guard's verdict (a halt raises after committing the
        last good state). Returns the run of consecutive bad steps."""
        cfg = self.cfg
        arrays = to_device(host, self.device)
        self.state, m = self.train_step(self.state, arrays)
        rows = int(batch.row_mask.sum())
        res.steps += 1
        res.examples += rows
        self._examples_seen += rows
        self._epoch_pos = pos
        loss = float(m["loss"])
        if m.get("update_ok", True):
            bad_run = 0
            res.last_loss = loss
        else:
            res.bad_steps += 1
            bad_run += 1
            self.metrics.log({"step": res.steps, "nonfinite_skipped": True,
                              "bad_steps": res.bad_steps})
            print(
                f"nonfinite update at step {res.steps} discarded "
                f"(total {res.bad_steps}, {bad_run} consecutive)",
                file=sys.stderr,
            )
            if cfg.train.nonfinite_guard == "halt" or (
                    0 < cfg.train.nonfinite_max_consecutive <= bad_run):
                self._halt(res, bad_run)
        if cfg.train.log_every and res.steps % cfg.train.log_every == 0:
            print(f"step {self.state.step} epoch {pos[0]} loss {loss}", file=sys.stderr)
        return bad_run

    @staticmethod
    def _signalled(sig_flag: Optional[dict]) -> int:
        return int(sig_flag["sig"]) if sig_flag and "sig" in sig_flag else 0

    def _interrupted(self, res: TrainResult, sig: int) -> None:
        res.interrupted = sig
        self.metrics.log({"interrupted": sig, "step": res.steps})
        # on disk before the save: a kill at the end of the grace period
        # keeps the record
        self.metrics.close()
        print(f"signal {sig}: checkpointing at step {res.steps} and exiting", file=sys.stderr)

    # ---------------------------------------------------------- streaming fit
    def _fit_tail(self, train_path: Optional[str] = None) -> TrainResult:
        """The online loop (`data.stream=tail`): train on the sealed
        segments a `TailFollower` spools off the growing input, read and
        planned in the prefetch thread as any shard is, and every
        `train.publish_every` steps commit a checkpoint with a
        publication sidecar stamped with the newest ingest trace whose
        rows a step consumed (`publish_every` 0: the plain
        `checkpoint_every` cadence). No epochs: the stream is one
        open-ended pass, ended by `data.stream_idle_s`, a signal or a
        halt. The stream's last state commits (and publishes) when the
        run ends. A resumed run restores the state and follows the input
        from its top, as the JAX trainer does."""
        cfg = self.cfg
        res = TrainResult()
        start = time.perf_counter()
        sig_flag, sig_restore = self._install_signal_checkpoint()
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
        bad_run = 0
        # the follower polls inside the prefetch thread; the flag ends its
        # wait for input within a poll, so a signal never waits out
        # stream_idle_s
        stream = pipeline.prefetch(self._feed_segments(
            follower, lambda: bool(self._signalled(sig_flag))))
        try:
            consumed = -1
            for seg, batch, host in stream:
                bad_run = self._step(res, batch, host, bad_run, (0, res.steps + 1))
                if seg.seq != consumed:
                    # the first step over a segment: the ingest-to-train edge
                    # of the freshness
                    consumed = seg.seq
                    newest = (seg.trace, seg.ingest_ts, time.time())
                if cfg.train.checkpoint_dir and publish_every:
                    if res.steps % publish_every == 0:
                        # the seq is spent only when the publication landed
                        # (an async skip retries with the same)
                        if self._publish_checkpoint(newest, pub_seq + 1):
                            pub_seq += 1
                elif (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
                      and res.steps % cfg.train.checkpoint_every == 0):
                    self.save_checkpoint()
                stop_sig = self._signalled(sig_flag)
                if stop_sig:
                    break
        finally:
            follower.close()  # before the stream: its reader thread may be polling
            stream.close()
            sig_restore()
        stop_sig = stop_sig or self._signalled(sig_flag)
        if stop_sig:
            self._interrupted(res, stop_sig)
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)
        res.seconds = time.perf_counter() - start
        res.epochs = 1 if res.steps else 0
        res.occupancy = self._occupancy()
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

    def _feed(self, path: str, skip: int, quarantine: bool):
        """(batch, host arrays) of one pass over `path` after its first
        `skip` batches: run in the prefetch thread, so the read, the
        parse and the plan overlap the device's step. A generator, so the
        consumer dropping the stream closes the reader."""
        for batch in pipeline.batch_iterator(path, self.cfg.data, skip=skip,
                                             quarantine=quarantine):
            yield batch, batch_arrays(batch, self.cfg, self.dedup)

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
            f"non-finite guard aborted at step {self.state.step}: "
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
    def evaluate(self, test_path: Optional[str] = None) -> tuple[float, float]:
        """(auc, logloss) of the live tables on `test_path`, by default the
        rank-0 shard of data.test_path."""
        path = test_path or shard_path(self.cfg.data.test_path, 0)
        return evaluate(self.cfg, self.state.tables, path, device=self.device)

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
