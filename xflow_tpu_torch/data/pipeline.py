"""Batching pipeline: a libffm shard (or its `.xfc` cache) -> padded
SparseBatch stream, after `xflow_tpu/data/pipeline.py`.

`batch_iterator` reads a shard's verified `.xfc` cache where `data.cache`
finds one, else its text through the native parser (`data/native.py`): a
native build that fails raises. The Python parser
(`examples_to_batches(libffm.iter_examples(...))`) is the plain version
the native one is tested against, and no path here runs it. Every batch
passes the bad-record monitor. `prefetch` runs a stream in a background thread with a bounded
queue: the trainer puts parsing and planning there, so the host's work
overlaps the card's step (the ctypes calls release the GIL).

A cache that fails its digest is quarantined and the shard is read as
text: that is the cache's data contract (`data/shardcache.py`), not a
parser fall back.

Not taken over: the stream tail (`TailFollower`, `IngestSegment`), the
pipeline profiler and the telemetry registry; `COUNTERS` keeps the one
total a checkpoint's data_state records.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from xflow_tpu_torch.data.libffm import QuarantineWriter
from xflow_tpu_torch.data.schema import SparseBatch, make_batch
from xflow_tpu_torch.jsonl import JsonlAppender

# the process's run total of the JAX package's `data.quarantined_rows`
COUNTERS = {"quarantined_rows": 0}


class BadRecordError(RuntimeError):
    """A file pass produced more feature-less rows than data.max_bad_rows
    allows: the input is likely garbage (wrong format, truncated upload,
    corrupted shard). Raised before the epoch completes."""


def bad_row_indices(batch: SparseBatch) -> np.ndarray:
    """Rows that are real (row_mask on) but parsed to zero features.
    Both parsers keep such rows (a labeled line is an example), so the
    count, taken from the batches, is the same for either."""
    rm = np.asarray(batch.row_mask) > 0
    has_feature = np.asarray(batch.mask).max(axis=1) > 0 if batch.mask.size else rm
    return np.nonzero(rm & ~has_feature)[0]


def monitor_bad_rows(
    batches: Iterator[SparseBatch],
    cfg,
    path: str,
    enforce: bool = True,
    quarantine: bool = True,
) -> Iterator[SparseBatch]:
    """Count (and, with `quarantine`, record to data.quarantine_path) the
    feature-less rows of a batch stream; with `enforce`, raise
    BadRecordError the moment data.max_bad_rows is exceeded. Bad rows are
    kept, not dropped. A one-line stderr summary ends a stream that had
    any. Eval passes set `enforce=False`: count and warn, never raise."""
    budget = cfg.max_bad_rows
    qw = QuarantineWriter(cfg.quarantine_path if quarantine else "")
    total = 0
    try:
        for bi, batch in enumerate(batches):
            idx = bad_row_indices(batch)
            if idx.size:
                labels = np.asarray(batch.labels)
                for r in idx:
                    qw.write(path, bi, int(r), float(labels[r]))
                total += int(idx.size)
                if enforce and 0 <= budget < total:
                    raise BadRecordError(
                        f"{path!r}: {total} feature-less row(s) exceed "
                        f"data.max_bad_rows={budget}; the shard is likely malformed "
                        "(wrong format / truncation / corruption): inspect it "
                        "(data.quarantine_path records the bad rows) or raise the budget"
                    )
            yield batch
        if total:
            print(
                f"xflow: warning: {path}: {total} row(s) parsed to zero "
                f"features (budget data.max_bad_rows={budget})"
                + (f"; quarantined to {cfg.quarantine_path}" if qw.written else ""),
                file=sys.stderr,
            )
    finally:
        COUNTERS["quarantined_rows"] += qw.written
        qw.close()


def examples_to_batches(
    examples: Iterable[tuple[float, np.ndarray, np.ndarray]],
    batch_size: int,
    max_nnz: int,
) -> Iterator[SparseBatch]:
    """Padded batches of an example stream (the Python parser's, in the
    tests); a short last batch is padded and row-masked."""
    labels: list = []
    fields: list = []
    slots: list = []
    for label, f, s in examples:
        labels.append(label)
        fields.append(f)
        slots.append(s)
        if len(labels) == batch_size:
            yield make_batch(fields, slots, labels, batch_size, max_nnz)
            labels, fields, slots = [], [], []
    if labels:
        yield make_batch(fields, slots, labels, batch_size, max_nnz)


def skip_batches(batches: Iterator[SparseBatch], n: int) -> Iterator[SparseBatch]:
    """Pass over the first `n` batches of a stream (a resumed run's
    consumed prefix): they bypass everything downstream, the bad-record
    monitor, the plan and the transfer. A generator, so a prefetch
    consumer's close() cascades through it."""
    for i, batch in enumerate(batches):
        if i >= n:
            yield batch


def batch_iterator(
    path: str,
    cfg,
    batch_size: Optional[int] = None,
    enforce_bad_rows: bool = True,
    quarantine: bool = True,
    skip: int = 0,
) -> Iterator[SparseBatch]:
    """Padded batches of libffm shard `path` (`cfg` is a DataConfig), from
    its `.xfc` cache or its text, each through the bad-record monitor.
    `skip` passes over the first `skip` batches unmonitored (they were
    monitored in the run being resumed)."""
    raw = _raw_batch_iterator(path, cfg, batch_size)
    if skip > 0:
        raw = skip_batches(raw, skip)
    yield from monitor_bad_rows(raw, cfg, path, enforce=enforce_bad_rows,
                                quarantine=quarantine)


def _cache_batch_iterator(path: str, cfg, bs: int) -> Optional[Iterator[SparseBatch]]:
    """The verified cache's batch iterator for text shard `path`, or None
    to read the text. A cache that fails its digest, or cannot be opened,
    is recorded to data.quarantine_path, warned about on stderr, and the
    shard is read as text, even under data.cache=on. A missing or stale
    cache under "on" raises."""
    if cfg.cache not in ("auto", "on"):
        if cfg.cache != "off":
            raise ValueError(f"data.cache={cfg.cache!r}: expected auto|on|off")
        return None
    from xflow_tpu_torch.data.shardcache import (
        ShardCacheDigestError,
        ShardCacheError,
        ShardCacheStale,
        cache_path_for,
        resolve_cache,
    )

    try:
        sc = resolve_cache(path, cfg)
    except ShardCacheStale:
        raise  # only under cache=on: the operator asserted cached input
    except ShardCacheError as e:
        qw = JsonlAppender(cfg.quarantine_path)
        qw.append({
            "source": path,
            "cache": cache_path_for(path, cfg.cache_dir),
            "reason": ("cache_digest_mismatch" if isinstance(e, ShardCacheDigestError)
                       else "cache_unreadable"),
            "section": getattr(e, "section", "?"),
        })
        qw.close()
        print(f"xflow: warning: shard cache for {path!r} failed integrity ({e}); "
              "quarantined, falling back to the text path", file=sys.stderr)
        return None
    if sc is None:
        return None
    return sc.iter_batches(bs)


def _raw_batch_iterator(path: str, cfg, batch_size: Optional[int] = None
                        ) -> Iterator[SparseBatch]:
    from xflow_tpu_torch.data.native import native_batch_iterator

    bs = batch_size or cfg.batch_size
    cached = _cache_batch_iterator(path, cfg, bs)
    yield from cached if cached is not None else native_batch_iterator(path, cfg, bs)


def count_batches(path: str, cfg, batch_size: Optional[int] = None) -> int:
    """Batches `batch_iterator` yields for the text of `path`, from the
    native row counter."""
    from xflow_tpu_torch.data.native import native_count_rows

    bs = batch_size or cfg.batch_size
    return -(-native_count_rows(path) // bs)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a background thread with a bounded queue.

    Abandonment-safe: when the consumer drops the generator (an exception
    in its loop, an early break), its close() sets `stop` and drains the
    queue, so a worker blocked on a full queue wakes, sees the flag,
    closes the underlying iterator (releasing the native parser's handle
    and the quarantine file at once) and exits. An exception in the
    worker is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def worker() -> None:
        try:
            for item in iterator:
                q.put(item)
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as e:  # re-raised in the consumer
            q.put(e)
        finally:
            if stop.is_set():
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()

    t = threading.Thread(target=worker, daemon=True, name="xflow-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # after the drain a worker stuck in q.put completes it, sees the
        # flag and exits (putting at most one more item, which fits)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10.0)


def host_calls() -> dict:
    """The host input plane's call counts: batches of the native stream,
    native plans, batches read from `.xfc` caches, and rows of the
    Python parser (which no path runs)."""
    from xflow_tpu_torch.data import libffm, native, shardcache

    return {"native_stream": native.CALLS["stream"], "native_plan": native.CALLS["plan"],
            "cache_batches": shardcache.CALLS["batches"],
            "python_rows": libffm.CALLS["rows"]}


def reset_host_calls() -> None:
    from xflow_tpu_torch.data import libffm, native, shardcache

    native.reset_calls()
    shardcache.reset_calls()
    libffm.reset_calls()

