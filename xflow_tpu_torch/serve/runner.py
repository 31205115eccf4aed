"""The serve runner: checkpoint-backed online pCTR prediction with hot
reload (`xflow_tpu/serve/runner.py`), answered through the same
`predict_fn` as `evaluate`, so offline and online scores of a row agree.
Serving is row-major, as in the JAX package: request batches are small,
and a host plan would sit on the latency path.

- **Tiered walk-back on load.** `load()` restores the tables (never the
  optimizer state) of the newest committed step across the primary
  checkpoint dir and `train.ckpt_replica_dir`, digest-verified, skipping
  damaged candidates, and refuses to regress the served step.
- **Hot reload, double-buffered.** `CheckpointWatcher` polls for a newer
  committed step and loads it off the request path; the swap is one
  reference assignment (`self._gen = gen`). A batch in flight holds the
  Generation it started with and finishes on the old tables.
- **The copy to the card.** The new tables are allocated on the default
  stream, where the predicts read them (so the caching allocator frees
  them in that stream's order), and filled on the loader's own stream,
  which is created non-blocking: predicts queued on the default stream
  do not wait behind a 185 MB (FM) to 1.2 GB (FFM at K = 73) copy. The
  copy stream first waits for the work already queued on the default
  stream (a recycled block may still be read there), and the loader
  synchronizes it before the swap, so no batch reads a half-written
  table.
- **A bad checkpoint is not an outage.** A reload that fails is logged
  and the current generation keeps serving; the watcher never retries a
  step that failed.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data.libffm import parse_line
from xflow_tpu_torch.evaluate import to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models.predict import make_predict_fn
from xflow_tpu_torch.serve.autotune import parse_ladder
from xflow_tpu_torch.serve.coalescer import PendingRequest, assemble_batch
from xflow_tpu_torch.train import checkpoint as ckpt
from xflow_tpu_torch.tracing import emit_linked_span, emit_op_span
from xflow_tpu_torch.weights import table_shapes, tables_from_jax


class BadRequest(ValueError):
    """A request answered with 400: a malformed row, or one with no
    parseable features."""


def parse_rows(rows: list, dcfg) -> tuple[list, list]:
    """Request rows (libffm feature lists; a leading label is ignored) ->
    per-row (fields, slots) int32 arrays through the training hash path.
    Raises BadRequest on a non-string row or one with no features."""
    fields_rows, slots_rows = [], []
    for i, row in enumerate(rows):
        if not isinstance(row, str):
            raise BadRequest(f"row {i}: expected a string, got {type(row).__name__}")
        line = row if "\t" in row else "0\t" + row
        parsed = parse_line(line, dcfg.log2_slots, dcfg.hash_salt)
        if parsed is None or parsed[2].size == 0:
            raise BadRequest(f"row {i}: no parseable field:feature tokens in {row!r}")
        _, f, s = parsed
        fields_rows.append(f)
        slots_rows.append(s)
    return fields_rows, slots_rows


@dataclass
class Generation:
    """One loaded model generation: the device tables and provenance.
    `publication` is the step's publication sidecar (None when the
    trainer did not publish it); `reload_span` is the span id of the swap
    that installed it, when a span sink is bound."""

    tables: dict
    step: int
    gen: int
    publication: Optional[dict] = None
    reload_span: str = ""

    def freshness_s(self) -> Optional[float]:
        """Seconds from the served model's newest ingested row to now;
        None without a (well-formed) publication."""
        pub = self.publication
        ts = pub.get("ingest_ts") if isinstance(pub, dict) else None
        if not isinstance(ts, (int, float)) or not np.isfinite(ts):
            return None
        return max(time.time() - float(ts), 0.0)


class ServeRunner:
    """pCTR prediction from the newest loadable checkpoint under
    `cfg.train.checkpoint_dir` (and its replica dir), on `device`."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.train.checkpoint_format != "npz":
            raise ValueError(
                f"train.checkpoint_format={cfg.train.checkpoint_format!r}: "
                "the port reads npz checkpoints"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = get_model(cfg.model.name)(cfg)
        self._predict = make_predict_fn(self.model)
        # the batch-shape ladder: every batch is padded to one of these
        # row counts (`warmup` runs each before traffic arrives)
        self.rungs = parse_ladder(cfg.serve)
        self._gen: Optional[Generation] = None
        self._gen_counter = 0
        self._reload_lock = threading.Lock()  # one loader at a time
        self._copy_stream = None  # the loader's CUDA stream, made at the first load
        # a stamped appender (serve_main binds the serve stream when
        # tracing is on): every load then emits one span
        self.span_sink = None

    @property
    def generation(self) -> Optional[Generation]:
        return self._gen

    @property
    def step(self) -> int:
        return self._gen.step if self._gen else -1

    def latest_committed_step(self) -> Optional[int]:
        """The newest committed step across both checkpoint tiers."""
        t = self.cfg.train
        return max((s for d in {t.checkpoint_dir, t.ckpt_replica_dir} - {""}
                    for s in ckpt.committed_steps(d)), default=None)

    def _to_device(self, host: dict) -> dict:
        """Host tables -> logical tensors on the serving device; on a card
        by the copy design of the module docstring."""
        tables = tables_from_jax(host, self.cfg, "cpu")  # views of `host`, checked
        if self.device.type != "cuda":
            return {k: t.to(self.device) for k, t in tables.items()}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
               for k, t in tables.items()}
        side = self._copy_stream
        side.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.stream(side):
            for k, t in tables.items():
                out[k].copy_(t)
        side.synchronize()
        return out

    def load(self) -> Generation:
        """Load the newest loadable committed checkpoint of either tier and
        swap it in. Raises when none loads (fatal at startup; the watcher
        catches it on a reload) and when the walk-back lands on a step no
        newer than the one served (swapping would regress)."""
        with self._reload_lock:
            is_reload = self._gen is not None
            t0_wall, t0 = time.time(), time.perf_counter()
            t = self.cfg.train
            host, step, src = ckpt.restore_tiered(
                t.checkpoint_dir, table_shapes(self.cfg), verify=t.checkpoint_verify,
                replica_dir=t.ckpt_replica_dir,
            )
            if self._gen is not None and step <= self._gen.step:
                raise RuntimeError(
                    f"newest loadable checkpoint is step {step}, already serving step "
                    f"{self._gen.step}; keeping the current generation"
                )
            tables = self._to_device(host)
            del host
            pub = ckpt.read_publication(src, int(step))
            self._gen_counter += 1
            gen = Generation(tables=tables, step=int(step), gen=self._gen_counter,
                             publication=pub)
            self._gen = gen  # the swap
            if self.span_sink is not None:
                nbytes = int(sum(t.numel() * t.element_size() for t in tables.values()))
                name = "reload" if is_reload else "serve_load"
                attrs = dict(step=gen.step, generation=gen.gen, bytes=nbytes)
                trace = pub.get("trace") if pub else None
                if isinstance(trace, str) and trace:
                    # a published step's swap continues the ingest trace
                    rec = emit_linked_span(self.span_sink, name, t0_wall,
                                           time.perf_counter() - t0, trace=trace,
                                           parent=pub.get("span") or None, **attrs)
                    gen.reload_span = rec["span"]
                else:
                    emit_op_span(self.span_sink, name, t0_wall, time.perf_counter() - t0,
                                 **attrs)
            return gen

    def maybe_reload(self) -> Optional[Generation]:
        """Reload iff a committed step newer than the served one exists.
        Returns the new Generation, or None (nothing newer, or the reload
        failed: logged, and the current generation keeps serving)."""
        try:
            latest = self.latest_committed_step()
            if latest is None or (self._gen and latest <= self._gen.step):
                return None
            gen = self.load()
            print(f"serve: hot reload: now serving step {gen.step} (generation {gen.gen})",
                  file=sys.stderr)
            return gen
        except Exception as e:  # noqa: BLE001 — any reload failure keeps serving
            print(f"serve: reload failed ({type(e).__name__}: {e}); keeping generation "
                  f"{self._gen.gen if self._gen else '?'} (step {self.step})",
                  file=sys.stderr)
            return None

    def predict(self, arrays: dict) -> tuple[np.ndarray, Generation]:
        """One row-major batch {slots, fields, mask, row_mask} of host
        arrays -> (pctr [B] on the host, the generation that answered).
        The generation is read once, so a swap cannot split a batch. The
        readback is the device sync."""
        gen = self._gen
        if gen is None:
            raise RuntimeError("no checkpoint loaded; call load() first")
        p = self._predict(gen.tables, to_device(arrays, self.device))
        return p.cpu().numpy(), gen

    def warmup(self) -> int:
        """One all-padding batch through `predict` at every rung, so the
        first request at a rung pays no first-launch cost. Returns the
        number of rungs."""
        for r in self.rungs:
            arrays, _ = assemble_batch([], r, self.cfg.data.max_nnz)
            self.predict(arrays)
        return len(self.rungs)

    def predict_rows(self, rows: list) -> tuple[np.ndarray, Generation]:
        """Parse, pad and predict libffm feature rows in chunks of
        serve.max_batch rows. Returns (pctr [len(rows)], generation)."""
        fields_rows, slots_rows = parse_rows(rows, self.cfg.data)
        B = self.cfg.serve.max_batch
        out = np.empty((len(rows),), np.float32)
        gen = None
        for lo in range(0, len(rows), B):
            req = PendingRequest(fields=fields_rows[lo : lo + B], slots=slots_rows[lo : lo + B])
            arrays, _ = assemble_batch([req], B, self.cfg.data.max_nnz)
            p, gen = self.predict(arrays)
            out[lo : lo + req.num_rows] = p[: req.num_rows]
        return out, gen


class CheckpointWatcher(threading.Thread):
    """Polls every `poll_s` for a newer committed step and hot-reloads it
    off the request path; `on_reload(gen)` / `on_failed()` feed the serve
    stream. A step that failed to load is not retried until a different
    step commits (no disk thrash, no reload_failed spam)."""

    def __init__(self, runner: ServeRunner, poll_s: float = 2.0, on_reload=None,
                 on_failed=None):
        super().__init__(daemon=True, name="xflow-serve-watcher")
        self._runner = runner
        self._poll = max(float(poll_s), 0.05)
        self._stop_evt = threading.Event()
        self._on_reload = on_reload
        self._on_failed = on_failed
        self._failed_step = None
        self.reloads = 0
        self.failures = 0

    def run(self) -> None:
        while not self._stop_evt.wait(self._poll):
            try:
                latest = self._runner.latest_committed_step()
            except OSError:
                continue
            if latest is None or latest <= self._runner.step or latest == self._failed_step:
                continue
            gen = self._runner.maybe_reload()
            if gen is not None:
                self._failed_step = None
                self.reloads += 1
                if self._on_reload:
                    self._on_reload(gen)
            else:
                self._failed_step = latest
                self.failures += 1
                if self._on_failed:
                    self._on_failed()

    def close(self) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=10.0)
