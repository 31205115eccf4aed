"""Lazy append-mode JSONL sink, after `xflow_tpu/jsonl.py::JsonlAppender`:
the part the port's bad-record quarantine uses.

The file opens on the first record (creating its parent directory),
every record is flushed, and `close()` returns the sink to its lazy
state, so a later append reopens in append mode. An empty path disables
the sink. Every record is prefixed with the JAX package's stamp of a
one-process run: `ts` (wall-clock seconds), `rank` 0, `run_id` (one
random id a process), `gen` 0 and `world` 1; the port trains in one
process. Size-capped rotation and the serving fleet's stamps are not
taken over.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

STAMP = {"rank": 0, "run_id": uuid.uuid4().hex[:12], "gen": 0, "world": 1}


class JsonlAppender:
    def __init__(self, path: str = ""):
        self._path = path
        self._f = None
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    def append(self, record: dict) -> None:
        if not self._path:
            return
        with self._lock:
            if self._f is None:
                parent = os.path.dirname(self._path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._f = open(self._path, "a")
            rec = {"ts": round(time.time(), 6), **STAMP, **record}
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
