"""npz checkpoints in the JAX package's format (`xflow_tpu/train/checkpoint.py`,
meta.json version 3), read and written.

A step lives in ``<dir>/step_<N>/``:

- ``state.npz`` — ``tables/<name>`` and ``opt/<name>/<leaf>`` in the
  logical layout, and ``step`` (int32);
- ``meta.json`` — version 3: the stored layout and a crc32 digest of
  every array's raw bytes;
- ``data_state.json`` — the data-stream position (version 2, one shard),
  written by the trainer before the marker;
- ``COMMITTED`` — written last; a step dir without it is partial.

`restore_tiered` and `restore_tables` read the tables only (serving and
evaluation never read optimizer state); `restore_state` reads tables,
optimizer state and step for the trainer. `restore_tiered` and
`restore_state` walk the primary dir and a tier-2 replica dir. All
verify digests and walk back past a step that fails to load. `read_publication` reads a step's
publication sidecar (the trainer's write side of replicas and
publications is not ported).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import zlib
from typing import Optional

import numpy as np

_STEP_RE = re.compile(r"^step_(\d+)$")
CHECKPOINT_VERSION = 3
# data_state.json "version": 2 = the topology-independent form (global
# examples, per-shard offsets); the port writes it for one shard
DATA_STATE_VERSION = 2
DATA_STATE_FILE = "data_state.json"
PUBLICATION_FILE = "publication.json"
PACK = 8


class CheckpointDigestError(RuntimeError):
    """A stored array's bytes no longer match the digest meta.json
    recorded at save: silent corruption. Restore walks back past it."""


def array_digest(arr: np.ndarray) -> str:
    """crc32 of an array's raw bytes, as meta.json records it. The crc
    reads the array's buffer in place: zlib releases the GIL over it,
    where a `tobytes()` copy would hold it (about 0.1 s for FM's table,
    a pause of every other thread of a server reloading)."""
    arr = np.ascontiguousarray(arr)
    return "crc32:%08x" % (zlib.crc32(arr) & 0xFFFFFFFF)


def verify_digest(label: str, arr: np.ndarray, digests: Optional[dict], source: str) -> None:
    """Raise CheckpointDigestError when `arr` does not match its recorded
    digest; arrays without one (pre-v3 checkpoints) pass."""
    if not digests:
        return
    want = digests.get(label)
    if not want:
        return
    got = array_digest(np.asarray(arr))
    if got != want:
        raise CheckpointDigestError(
            f"checkpoint {source!r}: array {label!r} digest mismatch "
            f"(stored {want}, read {got})"
        )


def committed_steps(ckpt_dir: str) -> list[int]:
    """All committed npz checkpoint steps, newest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[0] if steps else None


def read_meta(ckpt_dir: str, step: int) -> Optional[dict]:
    """meta.json of checkpoint `step`, or None (with a note on stderr)
    when it is missing or unreadable: the restore then runs unverified."""
    path = os.path.join(ckpt_dir, f"step_{step}", "meta.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError(f"expected a JSON object, got {type(meta).__name__}")
    except (OSError, ValueError) as e:
        print(
            f"# checkpoint: step {step} meta unreadable ({type(e).__name__}: {e}); "
            "restoring without digest verification",
            file=sys.stderr,
        )
        return None
    return meta


def _logical(arr: np.ndarray, label: str, shape: tuple, source: str) -> np.ndarray:
    """`arr` in the expected logical `shape`; a packed [S/8, 8K] array is
    reshaped, anything else is a model/config mismatch."""
    if arr.shape == shape:
        return arr
    packed = len(shape) == 2 and arr.shape == (shape[0] // PACK, shape[1] * PACK)
    if not packed:
        raise RuntimeError(
            f"checkpoint {source!r}: {label} stored shape {arr.shape} does not "
            f"match the config's {shape} (did model dims or log2_slots change?)"
        )
    return arr.reshape(shape)


def restore_step_arrays(ckpt_dir: str, step: int, shapes: dict, verify: str = "auto") -> dict:
    """{label: float32 array in logical shape} for `shapes` ({label such as
    "tables/wv" or "opt/wv/n": logical shape}) of one committed step,
    digest-verified unless `verify` is "off"."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    meta = read_meta(ckpt_dir, step) if verify != "off" else None
    digests = meta.get("digests") if isinstance(meta, dict) else None
    out = {}
    with np.load(os.path.join(path, "state.npz")) as data:
        for label, shape in shapes.items():
            if label not in data.files:
                group = label.split("/", 1)[0] + "/"
                stored = sorted(k for k in data.files if k.startswith(group))
                raise RuntimeError(f"checkpoint {path!r} has no {label!r} (stored: {stored})")
            arr = data[label]
            verify_digest(label, arr, digests, path)
            out[label] = np.ascontiguousarray(_logical(arr, label, tuple(shape), path), np.float32)
    return out


def _walk_tiers(dirs: list, load) -> tuple:
    """(load(dir, step), step, dir) for the newest committed step that
    loads, walking the union of the committed steps of `dirs` (the
    primary tier first, then the replica) newest first, and within a
    step the tiers in order. A candidate that fails (digest mismatch,
    damaged or missing file, wrong shapes) is logged with its reason and
    skipped. Raises FileNotFoundError when no tier holds a committed
    step, RuntimeError listing every failure when none loads."""
    by_dir = {d: set(committed_steps(d)) for d in dirs}
    steps = sorted(set().union(*by_dir.values()), reverse=True)
    where = " or ".join(repr(d) for d in dirs)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {where}")
    errors = []
    for step in steps:
        for d in dirs:
            if step not in by_dir[d]:
                continue
            try:
                got = load(d, step)
            except Exception as e:  # noqa: BLE001 — every way a stored step can
                # be damaged (BadZipFile, zlib.error, OSError, ValueError,
                # digest or shape mismatch) takes the walk-back, logged here
                tier = "replica" if len(dirs) > 1 and d == dirs[-1] else "primary"
                print(f"# checkpoint: step {step} ({tier} tier) failed to load "
                      f"({type(e).__name__}: {e}); trying the next candidate",
                      file=sys.stderr)
                errors.append((d, step, e))
                continue
            if errors:
                print(f"# checkpoint: restored step {step} from {d!r} after skipping "
                      f"{len(errors)} unreadable candidate(s): "
                      + ", ".join(f"step {s} in {dd!r}" for dd, s, _ in errors),
                      file=sys.stderr)
            return got, step, d
    raise RuntimeError(
        f"no loadable checkpoint under {where}: all {len(errors)} candidates failed: "
        + "; ".join(f"step {s} ({d}): {type(e).__name__}: {e}" for d, s, e in errors)
    )


def restore_step_tables(ckpt_dir: str, step: int, shapes: dict, verify: str = "auto") -> dict:
    """Tables {name: float32 array in logical shape} of one committed
    step, digest-verified unless `verify` is "off"."""
    labels = {f"tables/{n}": shape for n, shape in shapes.items()}
    got = restore_step_arrays(ckpt_dir, step, labels, verify=verify)
    return {n: got[f"tables/{n}"] for n in shapes}


def restore_tiered(ckpt_dir: str, shapes: dict, verify: str = "auto",
                   replica_dir: Optional[str] = None) -> tuple[dict, int, str]:
    """Tables ({name: logical shape} -> {name: array}) of the newest
    committed step that loads across the primary `ckpt_dir` and the
    tier-2 `replica_dir` (`train.ckpt_replica_dir`; None or "" = none):
    a digest-poisoned primary step loads from the replica before the
    walk falls back to an older step. Returns (tables, step, the dir it
    loaded from), so sidecars are read from the same tier."""
    return _walk_tiers(_tiers(ckpt_dir, replica_dir),
                       lambda d, step: restore_step_tables(d, step, shapes, verify))


def _tiers(ckpt_dir: str, replica_dir: Optional[str]) -> list:
    """The dirs a restore walks: the primary, then the replica when set."""
    return [ckpt_dir] + ([replica_dir] if replica_dir and replica_dir != ckpt_dir else [])


def restore_tables(ckpt_dir: str, shapes: dict, verify: str = "auto") -> tuple[dict, int]:
    """Tables of the newest committed step under `ckpt_dir` that loads.
    Returns (tables, step)."""
    return restore_tiered(ckpt_dir, shapes, verify)[:2]


def restore_state(ckpt_dir: str, shapes: dict, opt_leaves: tuple, verify: str = "auto",
                  replica_dir: Optional[str] = None) -> tuple[dict, dict, int, str]:
    """Tables, optimizer state ({name: {leaf: array}}, `opt_leaves` per
    table, each of its table's shape) and step of the newest committed
    step that loads across the primary `ckpt_dir` and the tier-2
    `replica_dir`, walked as `restore_tiered` walks them. Returns
    (tables, opt_state, step, the dir it loaded from), so the trainer
    reads the step's data_state from the same tier."""

    def load(d, step):
        labels = {f"tables/{n}": shape for n, shape in shapes.items()}
        labels.update(
            {f"opt/{n}/{leaf}": shape for n, shape in shapes.items() for leaf in opt_leaves}
        )
        got = restore_step_arrays(d, step, labels, verify=verify)
        tables = {n: got[f"tables/{n}"] for n in shapes}
        opt = {n: {leaf: got[f"opt/{n}/{leaf}"] for leaf in opt_leaves} for n in shapes}
        return tables, opt

    (tables, opt), step, src = _walk_tiers(_tiers(ckpt_dir, replica_dir), load)
    return tables, opt, step, src


def read_publication(ckpt_dir: str, step: int) -> Optional[dict]:
    """The publication sidecar of checkpoint `step`
    (`step_<N>/publication.json`: {step, seq, trace, span, ingest_ts,
    consumed_ts, published_ts}, written by a publishing trainer), or
    None. Absence is the normal case and silent; an unreadable sidecar
    is logged and read as None: it never gates the reload that found it."""
    path = os.path.join(ckpt_dir, f"step_{step}", PUBLICATION_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            pub = json.load(f)
        if not isinstance(pub, dict):
            raise ValueError(f"expected a JSON object, got {type(pub).__name__}")
    except (OSError, ValueError) as e:
        print(f"# checkpoint: step {step} publication unreadable ({type(e).__name__}: "
              f"{e}); serving without a trace link", file=sys.stderr)
        return None
    return pub


def read_data_state(ckpt_dir: str, step: int) -> Optional[dict]:
    """The data-stream position saved with checkpoint `step`, or None with
    a logged note when it is missing or unreadable: the run then resumes
    with a fresh stream (the model state still restores)."""
    path = os.path.join(ckpt_dir, f"step_{step}", DATA_STATE_FILE)
    if not os.path.exists(path):
        print(
            f"# checkpoint: step {step} has no data_state; resuming with a fresh data stream",
            file=sys.stderr,
        )
        return None
    try:
        with open(path) as f:
            ds = json.load(f)
        if not isinstance(ds, dict):
            raise ValueError(f"expected a JSON object, got {type(ds).__name__}")
    except (OSError, ValueError) as e:
        print(
            f"# checkpoint: step {step} data_state unreadable ({type(e).__name__}: {e}); "
            "resuming with a fresh data stream",
            file=sys.stderr,
        )
        return None
    return ds


def _write_atomic(path: str, writer) -> None:
    """Write through a temp name, fsync, rename, fsync the directory."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        writer(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_flat(ckpt_dir: str, flat: dict, step: int, data_state: Optional[dict] = None) -> str:
    """Write host arrays `flat` ({"tables/wv": ..., "step": ...}) as
    committed step `step`: state.npz, meta.json v3 with digests,
    data_state.json when given, then the COMMITTED marker. A leftover
    uncommitted dir of the same step is removed first. Returns the step
    dir."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, "COMMITTED")):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)

    def write_npz(p):
        with open(p, "wb") as f:
            np.savez(f, **flat)

    _write_atomic(os.path.join(path, "state.npz"), write_npz)
    meta = {
        "step": step,
        "tables": sorted(k.split("/", 1)[1] for k in flat if k.startswith("tables/")),
        "format": "npz",
        "version": CHECKPOINT_VERSION,
        "world_size": 1,
        "layout": {k: list(np.asarray(v).shape) for k, v in flat.items()},
        "digests": {k: array_digest(v) for k, v in flat.items()},
    }

    def write_json(p):
        with open(p, "w") as f:
            json.dump(meta, f)

    _write_atomic(os.path.join(path, "meta.json"), write_json)
    if data_state is not None:

        def write_ds(p):
            with open(p, "w") as f:
                json.dump(data_state, f)

        _write_atomic(os.path.join(path, DATA_STATE_FILE), write_ds)

    def write_marker(p):
        with open(p, "w") as f:
            f.write("ok\n")

    _write_atomic(os.path.join(path, "COMMITTED"), write_marker)
    return path


def _host(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, np.float32)


def save_tables(ckpt_dir: str, tables: dict, step: int) -> str:
    """Commit `tables` ({name: host array}, logical layout) as a
    tables-only checkpoint at `step`."""
    flat = {f"tables/{n}": _host(t) for n, t in tables.items()}
    flat["step"] = np.asarray(step, np.int32)
    return write_flat(ckpt_dir, flat, step)


def save_state(ckpt_dir: str, tables: dict, opt_state: dict, step: int,
               data_state: Optional[dict] = None) -> str:
    """Commit a full training state: ``tables/<n>``, ``opt/<n>/<leaf>``
    and ``step``, as the JAX package's `_flatten` lays them out (logical
    [S, K] tensors or host arrays), with `data_state` written before the
    COMMITTED marker."""
    flat = {f"tables/{n}": _host(t) for n, t in tables.items()}
    for n, st in opt_state.items():
        for leaf, v in st.items():
            flat[f"opt/{n}/{leaf}"] = _host(v)
    flat["step"] = np.asarray(step, np.int32)
    return write_flat(ckpt_dir, flat, step, data_state=data_state)
