"""Lazy append-mode JSONL sink and truncation-tolerant reader, after
`xflow_tpu/jsonl.py`: the bad-record quarantine and the serve telemetry
stream write through it.

The file opens on the first record (creating its parent directory),
every record is flushed, and `close()` returns the sink to its lazy
state, so a later append reopens in append mode. An empty path disables
the sink. Every record is prefixed with `ts` (wall-clock seconds) and
the JAX package's stamp: `rank`, `run_id`, `gen` and `world`, resolved
from the launcher's environment at the first append
(`telemetry.resolve_*`), plus `replica` and `port` in a serving fleet's
replicas (absent keys elsewhere, not nulls). With none of the `XFLOW_*`
variables set the stamp is a one-process run's: rank 0, one random
run id a process, gen 0, world 1. A caller that knows its identity
passes `stamp=` (the fleet's router: rank -1); the keys it leaves out
are resolved as above.

Rotation: `max_bytes > 0` caps the live file. An append that would push
past the cap first rolls the file to a single `<path>.1` sibling
(replacing the previous roll) and reopens it fresh, under the append
lock, so a long-running server's stream stays under about twice the
cap. `read_jsonl(path)` reads `<path>.1` first, then `path`, so the
records keep their order across the roll.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from xflow_tpu_torch import telemetry


def _resolve_stamp(stamp: Optional[dict] = None) -> dict:
    """`stamp` completed from the environment: rank, run_id, gen, world,
    and replica / port inside a fleet."""
    out = dict(stamp or {})
    if "rank" not in out:
        out["rank"] = telemetry.resolve_rank()
    if "run_id" not in out:
        out["run_id"] = telemetry.resolve_run_id()
    if "gen" not in out:
        out["gen"] = telemetry.resolve_restart_gen()
    if "world" not in out:
        out["world"] = telemetry.resolve_world_size()
    if "replica" not in out:
        rep = telemetry.resolve_replica()
        if rep is not None:
            out["replica"] = rep
            port = telemetry.resolve_replica_port()
            if port is not None:
                out["port"] = port
    return out


class JsonlAppender:
    def __init__(self, path: str = "", stamp: Optional[dict] = None, max_bytes: int = 0):
        self._path = path
        self._f = None
        self._max_bytes = max(int(max_bytes), 0)
        self._size = 0  # bytes in the live file, read at open
        self._given = stamp
        self._stamp: Optional[dict] = None  # resolved at the first append
        # handler threads, the device worker and the watcher append to
        # one sink: an unlocked write can interleave two records
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    def _open_locked(self) -> None:
        parent = os.path.dirname(self._path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self._path, "a")
        self._size = self._f.tell()

    def append(self, record: dict) -> None:
        if not self._path:
            return
        with self._lock:
            if self._f is None:
                self._open_locked()
            if self._stamp is None:
                self._stamp = _resolve_stamp(self._given)
            line = json.dumps({"ts": round(time.time(), 6), **self._stamp, **record}) + "\n"
            if self._max_bytes and self._size and self._size + len(line) > self._max_bytes:
                self._f.close()
                try:
                    os.replace(self._path, self._path + ".1")
                except OSError:
                    pass  # rotation is best-effort; the append must not fail
                self._open_locked()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_jsonl_counted(path: str) -> tuple[list, int]:
    """(records, skipped) of a JSONL file, a `<path>.1` roll read first so
    the records keep file order. Unparseable lines (a record cut by a
    crash mid-append, or damage) are skipped and counted, with one
    warning a file on stderr."""
    old, old_skipped = _read_file(path + ".1") if os.path.exists(path + ".1") else ([], 0)
    live, skipped = _read_file(path)
    return old + live, old_skipped + skipped


def _read_file(path: str) -> tuple[list, int]:
    records, skipped, first_bad = [], 0, 0
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = None
            if not isinstance(rec, dict):
                skipped += 1
                first_bad = first_bad or i
                continue
            records.append(rec)
    if skipped:
        print(f"xflow: warning: {path}: skipped {skipped} unparseable JSONL line(s) "
              f"(first at line {first_bad}; truncated append or corruption)",
              file=sys.stderr)
    return records, skipped


def read_jsonl(path: str) -> list:
    """The records of a JSONL file (see `read_jsonl_counted`)."""
    return read_jsonl_counted(path)[0]
