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

The stream tail (`data.stream=tail`): `TailFollower` cuts a growing
shard set's newly completed lines into sealed `IngestSegment`s, each
converted to `.xfc` on arrival, and the trainer reads each segment
through `batch_iterator` like any shard.

The pipeline profiler (train.pipeline_metrics, `telemetry.PipelineProfiler`)
threads through `batch_iterator` and `prefetch` when one is passed: the
native parser's batches as `parse`, `.xfc` slicing as `cache_read`, the
prefetch queue's blocked put as `producer_wait` and its depth. Without a
profiler the stream is the unprofiled one. The registry counts the
shards read from a cache (`data.cache_shards`) and the caches that failed
and fell back to the text (`data.cache_fallbacks`); `COUNTERS` keeps the
one total a checkpoint's data_state records.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
from typing import TYPE_CHECKING, Iterable, Iterator, Optional

import numpy as np

from xflow_tpu_torch.data.libffm import QuarantineWriter
from xflow_tpu_torch.data.schema import SparseBatch, make_batch
from xflow_tpu_torch.jsonl import JsonlAppender

if TYPE_CHECKING:  # the config type only
    from xflow_tpu_torch.config import DataConfig

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
    cfg: DataConfig,
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
    cfg: DataConfig,
    batch_size: Optional[int] = None,
    enforce_bad_rows: bool = True,
    quarantine: bool = True,
    skip: int = 0,
    profiler=None,
) -> Iterator[SparseBatch]:
    """Padded batches of libffm shard `path` (`cfg` is a DataConfig), from
    its `.xfc` cache or its text, each through the bad-record monitor.
    `skip` passes over the first `skip` batches unmonitored (they were
    monitored in the run being resumed). `profiler` times the parse or
    the cache read."""
    raw = _raw_batch_iterator(path, cfg, batch_size, profiler)
    if skip > 0:
        raw = skip_batches(raw, skip)
    yield from monitor_bad_rows(raw, cfg, path, enforce=enforce_bad_rows,
                                quarantine=quarantine)


def _cache_batch_iterator(path: str, cfg: DataConfig, bs: int,
                          profiler=None) -> Optional[Iterator[SparseBatch]]:
    """The verified cache's batch iterator for text shard `path`, or None
    to read the text. A cache that fails its digest, or cannot be opened,
    is recorded to data.quarantine_path, counted (`data.cache_fallbacks`),
    warned about on stderr, and the shard is read as text, even under
    data.cache=on. A missing or stale cache under "on" raises."""
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
    from xflow_tpu_torch.telemetry import default_registry

    reg = default_registry()
    try:
        sc = resolve_cache(path, cfg)
    except ShardCacheStale:
        raise  # only under cache=on: the operator asserted cached input
    except ShardCacheError as e:
        reg.counter("data.cache_fallbacks").inc()
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
    reg.counter("data.cache_shards").inc()
    return sc.iter_batches(bs, profiler=profiler)


def _raw_batch_iterator(path: str, cfg: DataConfig, batch_size: Optional[int] = None,
                        profiler=None) -> Iterator[SparseBatch]:
    from xflow_tpu_torch.data.native import native_batch_iterator

    bs = batch_size or cfg.batch_size
    cached = _cache_batch_iterator(path, cfg, bs, profiler)
    if cached is not None:
        yield from cached
        return
    native = native_batch_iterator(path, cfg, bs)
    if profiler is None:
        yield from native
        return
    # the C parser reads, parses, hashes and pads inside one call: its
    # whole batch is the `parse` stage
    while True:
        with profiler.stage("parse"):
            b = next(native, None)
        if b is None:
            return
        profiler.count_batch(b.num_rows)
        yield b


def count_batches(path: str, cfg: DataConfig, batch_size: Optional[int] = None) -> int:
    """Batches `batch_iterator` yields for the text of `path`, from the
    native row counter."""
    from xflow_tpu_torch.data.native import native_count_rows

    bs = batch_size or cfg.batch_size
    return -(-native_count_rows(path) // bs)


def assign_shards(prefix: str, rank: int, world: int,
                  num_shards: int = 0) -> list[tuple[int, str]]:
    """Round-robin shard ownership (`xflow_tpu/data/pipeline.py`):
    [(shard index, path)] for member `rank` of `world` (on a mesh, the
    data coordinate of D). `num_shards` is the shard set in play; for a
    fresh run it is the world, so member k owns shard k alone. A smaller
    world covers the whole set (k, k+M, k+2M, ...); a larger one gives
    members N..M-1 the shard of their own index. The paths need not
    exist: a missing shard counts as no batches."""
    from xflow_tpu_torch.data.libffm import shard_path

    n = max(int(num_shards), int(world), 1)
    return [(s, shard_path(prefix, s)) for s in range(int(rank), n, int(world))]


def prefetch(iterator: Iterator, depth: int = 2, profiler=None) -> Iterator:
    """Run `iterator` in a background thread with a bounded queue.

    Abandonment-safe: when the consumer drops the generator (an exception
    in its loop, an early break), its close() sets `stop` and drains the
    queue, so a worker blocked on a full queue wakes, sees the flag,
    closes the underlying iterator (releasing the native parser's handle
    and the quarantine file at once) and exits. An exception in the
    worker is raised in the consumer. `profiler` times the worker's
    blocked puts (`producer_wait`) and samples the queue's depth."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def worker() -> None:
        try:
            for item in iterator:
                if profiler is None:
                    q.put(item)
                else:
                    with profiler.stage("producer_wait"):
                        q.put(item)
                    profiler.observe_queue(q.qsize(), depth)
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
            if profiler is not None:
                profiler.observe_queue(q.qsize(), depth)
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



# --------------------------------------------------------------- the stream
@dataclasses.dataclass(frozen=True)
class IngestSegment:
    """One sealed unit of tail-followed input (data.stream=tail): the
    newly completed lines of a watched shard, spooled into an immutable
    segment file (and its `.xfc` cache where conversion is on), stamped
    with the ingest trace the freshness records follow from the trainer
    to the server."""

    trace: str        # 16-hex ingest trace id (tracing.new_id)
    seq: int          # segment number within this follower
    source: str       # the watched text shard the bytes came from
    offset: int       # byte offset of the segment's start in `source`
    rows: int         # labeled examples in the segment
    bytes: int        # segment length in bytes
    path: str         # the sealed spool file
    cache: str        # its .xfc cache ("" = read as text)
    ingest_ts: float  # wall anchor: when the segment sealed


def stream_dir_for(prefix: str, cfg: DataConfig) -> str:
    """Where a tail follower spools segments: data.stream_dir, or an
    `.xfstream` dir beside the watched shards."""
    if cfg.stream_dir:
        return cfg.stream_dir
    return os.path.join(os.path.dirname(prefix) or ".", ".xfstream")


class TailFollower:
    """Follow-the-tail source (data.stream=tail), after the JAX package's.

    Watches the `<prefix>-NNNNN` shard set (or `prefix` itself when it is
    a file) for new or growing libffm files. Each poll cuts every shard's
    newly completed lines into one sealed spool segment (temp, fsync,
    rename); a trailing row without its newline is deferred until the
    rest lands, never quarantined, since a writer mid-append is the
    normal case. Each segment converts on arrival into a `.xfc` cache
    (data.cache auto or on) and carries a fresh ingest trace id and wall
    anchor, recorded as one kind="ingest" record and in the
    `data.ingest_segments` / `data.ingest_rows` counters.

    A shard that shrank below the follower's offset was rotated: its
    offset resets to 0 and the new contents stream from the top.
    `data.stream_idle_s` without new complete rows ends the stream (0 =
    follow forever); `close()` ends it at once, from any thread.
    `clock`/`wall` are injectable for tests."""

    def __init__(self, prefix: str, cfg: DataConfig, appender=None, clock=time.monotonic,
                 wall=time.time):
        self._prefix = prefix
        self._cfg = cfg
        self._app = appender
        self._poll_s = max(float(cfg.stream_poll_s), 0.01)
        self._idle_s = max(float(cfg.stream_idle_s), 0.0)
        self._dir = stream_dir_for(prefix, cfg)
        self._clock = clock
        self._wall = wall
        self._offsets: dict = {}
        self._seq = 0
        self._stop = threading.Event()

    def _sources(self) -> list:
        from xflow_tpu_torch.data.libffm import available_shards

        if os.path.isfile(self._prefix):
            return [self._prefix]
        return available_shards(self._prefix)

    def poll(self) -> list:
        """One scan: seal and return every shard's newly completed lines
        (possibly none)."""
        segs = []
        for src in self._sources():
            try:
                size = os.path.getsize(src)
            except OSError:
                continue  # raced a rotation; the next poll sees it
            off = self._offsets.get(src, 0)
            if size < off:
                off = self._offsets[src] = 0  # rotated: from the top
            if size <= off:
                continue
            with open(src, "rb") as f:
                f.seek(off)
                data = f.read(size - off)
            nl = data.rfind(b"\n")
            if nl < 0:
                continue  # a row still being written: defer it
            chunk = data[: nl + 1]
            seg = self._seal(src, off, chunk)
            self._offsets[src] = off + len(chunk)
            if seg is not None:
                segs.append(seg)
        return segs

    def _seal(self, src: str, off: int, chunk: bytes) -> Optional[IngestSegment]:
        from xflow_tpu_torch.data.native import native_count_rows
        from xflow_tpu_torch.telemetry import default_registry
        from xflow_tpu_torch.tracing import new_id

        os.makedirs(self._dir, exist_ok=True)
        spool = os.path.join(self._dir, "segment-%06d" % self._seq)
        seq, self._seq = self._seq, self._seq + 1
        tmp = spool + ".tmp"
        with open(tmp, "wb") as f:
            f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, spool)
        rows = native_count_rows(spool)
        if rows == 0:
            return None  # blank or label-less lines: the offset still advances
        cache = ""
        if self._cfg.cache in ("auto", "on"):
            from xflow_tpu_torch.data.shardcache import cache_path_for, write_shard_cache

            try:
                write_shard_cache(spool, self._cfg)
                cache = cache_path_for(spool, self._cfg.cache_dir)
            except Exception as e:  # noqa: BLE001 — conversion is an
                # optimization: the segment trains from its text
                print(f"xflow: warning: convert-on-arrival failed for {spool!r} ({e}); "
                      "training the segment from text", file=sys.stderr)
        seg = IngestSegment(
            trace=new_id(), seq=seq, source=src, offset=off, rows=rows,
            bytes=len(chunk), path=spool, cache=cache, ingest_ts=round(self._wall(), 6),
        )
        reg = default_registry()
        reg.counter("data.ingest_segments").inc()
        reg.counter("data.ingest_rows").inc(rows)
        if self._app is not None:
            self._app.append({
                "kind": "ingest", "trace": seg.trace, "seq": seg.seq, "source": seg.source,
                "offset": seg.offset, "rows": seg.rows, "bytes": seg.bytes,
                "cache": seg.cache, "ingest_ts": seg.ingest_ts,
            })
        return seg

    def segments(self, stop=None) -> Iterator[IngestSegment]:
        """The blocking segment stream: polls every stream_poll_s, ends on
        close(), when `stop()` turns true (read at each poll), or after
        stream_idle_s without new complete rows."""
        last_new = self._clock()
        while not self._stop.is_set() and not (stop is not None and stop()):
            segs = self.poll()
            if segs:
                last_new = self._clock()
                yield from segs
                continue
            if self._idle_s and self._clock() - last_new >= self._idle_s:
                return
            self._stop.wait(self._poll_s)

    def close(self) -> None:
        self._stop.set()
