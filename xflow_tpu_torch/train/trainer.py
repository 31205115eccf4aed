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

Not taken over from the JAX trainer: the metrics JSONL, heartbeat,
trace window, signal checkpoint, async and replica checkpoints,
checkpoint pruning, health norms, the stream tail, the pipeline
profiler and multi-process coordination.
"""

from __future__ import annotations

import contextlib
import os
import sys
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
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.train import checkpoint as ckpt
from xflow_tpu_torch.train.state import TrainState, init_state
from xflow_tpu_torch.train.step import make_train_step, nonfinite_guard_on
from xflow_tpu_torch.weights import table_shapes


class NonFiniteHalt(RuntimeError):
    """Raised by fit() when the non-finite guard aborts the run
    (train.nonfinite_guard=halt, or nonfinite_max_consecutive discarded
    steps in a row under skip), after committing the last good state
    when train.checkpoint_dir is set."""


@dataclass
class TrainResult:
    steps: int = 0
    epochs: int = 0
    examples: int = 0
    seconds: float = 0.0
    last_loss: float = float("nan")
    occupancy: dict = field(default_factory=dict)
    bad_steps: int = 0  # non-finite updates discarded by the guard

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
        # data-stream position pinned by the next checkpoint's data_state:
        # (epoch, batches consumed within it) of the one shard
        self._epoch_pos = (0, 0)
        self._examples_seen = 0
        self._examples_base = 0
        self._resume_data_state: Optional[dict] = None

    # ------------------------------------------------------------------ train
    def fit(self, train_path: Optional[str] = None) -> TrainResult:
        cfg = self.cfg
        path = train_path or shard_path(cfg.data.train_path, 0)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        res = TrainResult()
        start = time.perf_counter()
        start_epoch, skip = self._consume_resume_position()
        halt = cfg.train.nonfinite_guard == "halt"
        max_consec = cfg.train.nonfinite_max_consecutive
        bad_run = 0
        for epoch in range(start_epoch, cfg.train.epochs):
            offset = skip if epoch == start_epoch else 0
            # closing: a halt or an error stops the reader thread at once
            with contextlib.closing(pipeline.prefetch(
                    self._feed(path, offset, quarantine=epoch == 0))) as stream:
                for batch, host in stream:
                    arrays = to_device(host, self.device)
                    self.state, m = self.train_step(self.state, arrays)
                    rows = int(batch.row_mask.sum())
                    res.steps += 1
                    res.examples += rows
                    self._examples_seen += rows
                    offset += 1
                    self._epoch_pos = (epoch, offset)
                    loss = float(m["loss"])
                    if m.get("update_ok", True):
                        bad_run = 0
                        res.last_loss = loss
                    else:
                        res.bad_steps += 1
                        bad_run += 1
                        print(
                            f"nonfinite update at step {res.steps} discarded "
                            f"(total {res.bad_steps}, {bad_run} consecutive)",
                            file=sys.stderr,
                        )
                        if halt or 0 < max_consec <= bad_run:
                            self._halt(res, bad_run)
                    if cfg.train.log_every and res.steps % cfg.train.log_every == 0:
                        print(f"step {self.state.step} epoch {epoch} loss {loss}", file=sys.stderr)
                    if (
                        cfg.train.checkpoint_dir
                        and cfg.train.checkpoint_every
                        and res.steps % cfg.train.checkpoint_every == 0
                    ):
                        self.save_checkpoint()
            self._epoch_pos = (epoch + 1, 0)
            res.epochs = epoch + 1
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)
        res.seconds = time.perf_counter() - start
        res.occupancy = self._occupancy()
        if cfg.train.checkpoint_dir:
            self.save_checkpoint()
        return res

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
        discarded, so the live state is the last good one: commit it."""
        cfg = self.cfg
        if cfg.train.checkpoint_dir:
            self.save_checkpoint()
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
            "shard_batches": {"0": int(batches)},
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

    def save_checkpoint(self) -> str:
        """Commit the live state with its data_state (synchronous)."""
        self._check_format()
        return ckpt.save_state(
            self.cfg.train.checkpoint_dir, self.state.tables, self.state.opt_state,
            self.state.step, data_state=self._data_state_record(),
        )

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
