"""npz checkpoints in the JAX package's format (`xflow_tpu/train/checkpoint.py`,
meta.json version 3), read and written.

A step lives in ``<dir>/step_<N>/``:

- ``state.npz`` — ``tables/<name>`` and ``opt/<name>/<leaf>`` in the
  logical layout, and ``step`` (int32);
- ``meta.json`` — version 3: the stored layout and a crc32 digest of
  every array's raw bytes;
- ``data_state.json`` — the data-stream position (version 2, one shard);
- ``publication.json`` — a publishing trainer's freshness sidecar;
- ``COMMITTED`` — written last; a step dir without it is partial.

Each file lands through a temp name, fsync, rename and a directory
fsync (`write_flat`), with the disk-fault seam of
`testing/faults.ckpt_write_fault` on every staged file.

`restore_tiered` and `restore_tables` read the tables only (serving and
evaluation never read optimizer state); `restore_state` reads tables,
optimizer state and step for the trainer. `restore_tiered` and
`restore_state` walk the primary dir and a tier-2 replica dir
(`restore_state_mesh` on a mesh: rank 0 walks, the step and the whole
leaves are broadcast, each rank keeps its range). All
verify digests and walk back past a step that fails to load; a fused
FM ``wv`` and the two-table ``w`` / ``v`` restore into each other
(`_fused_alias`).

The write side: `prune_checkpoints` (retention and the sweep of
uncommitted debris), `mirror_step` (the tier-2 replica, digest
re-verified, its own COMMITTED last) and the async writer
(`SaveSnapshot`, `SaveJob`, `AsyncCheckpointWriter`). `export_sparse_array`
writes a table's nonzero rows as text (`python -m xflow_tpu_torch
export`). Orbax checkpoints are not taken over.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from xflow_tpu_torch.testing.faults import ckpt_write_fault

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
    tables = {lb.split("/", 1)[1]: tuple(sh) for lb, sh in shapes.items()
              if lb.startswith("tables/")}
    with np.load(os.path.join(path, "state.npz")) as data:

        def stored(label):
            if label not in data.files:
                return None
            arr = data[label]
            verify_digest(label, arr, digests, path)
            return arr

        for label, shape in shapes.items():
            arr = stored(label)
            if arr is None:
                group, tbl, *leaf = label.split("/")
                suffix = "".join("/" + x for x in leaf)
                arr = _fused_alias(lambda name: stored(f"{group}/{name}{suffix}"), tbl, tables)
            if arr is None:
                group = label.split("/", 1)[0] + "/"
                have = sorted(k for k in data.files if k.startswith(group))
                raise RuntimeError(f"checkpoint {path!r} has no {label!r} (stored: {have}), "
                                   "and the fused <-> two-table FM bridge does not apply")
            out[label] = np.ascontiguousarray(_logical(arr, label, tuple(shape), path), np.float32)
    return out


def _fused_alias(lookup, tbl: str, tables: dict) -> Optional[np.ndarray]:
    """Table (or one optimizer leaf of it) `tbl` derived from the other FM
    layout, for a checkpoint written under the other `model.fm_fused`:
    a stored fused ``wv [S, 1+k]`` splits into ``w = wv[:, 0]`` and
    ``v = wv[:, 1:]``; stored ``w`` and ``v`` concatenate into ``wv``.
    FTRL's n and z split and merge the same way (the update is
    elementwise). `lookup(name)` returns the stored array of the same
    group and leaf, or None; `tables` is {name: logical shape} of the
    configured model. Sizes decide, so a packed stored ``v`` bridges as
    well. None when the bridge does not apply (another model, other
    dims): a fused checkpoint never restores into LR or MVM."""
    if tbl in ("w", "v"):
        wv = lookup("wv")
        if wv is None or "w" not in tables or "v" not in tables:
            return None
        S = int(np.prod(tables["w"]))
        k = int(np.prod(tables["v"])) // S
        wv = np.asarray(wv)
        if wv.size != S * (1 + k):
            return None
        wv = wv.reshape(S, 1 + k)
        return np.ascontiguousarray(wv[:, 0] if tbl == "w" else wv[:, 1:])
    if tbl == "wv":
        w, v = lookup("w"), lookup("v")
        if w is None or v is None or "wv" not in tables:
            return None
        w = np.asarray(w).reshape(-1, 1)
        S = w.shape[0]
        v = np.asarray(v)
        if v.size % S or int(np.prod(tables["wv"])) != S + v.size:
            return None
        return np.concatenate([w, v.reshape(S, -1)], axis=1)
    return None


def _walk_tiers(dirs: list, load, only_step: Optional[int] = None) -> tuple:
    """(load(dir, step), step, dir) for the newest committed step that
    loads, walking the union of the committed steps of `dirs` (the
    primary tier first, then the replica) newest first, and within a
    step the tiers in order; `only_step` walks that one step's tiers. A
    candidate that fails (digest mismatch, damaged or missing file, wrong
    shapes) is logged with its reason and skipped. Raises
    FileNotFoundError when no tier holds a committed step (the step),
    RuntimeError listing every failure when none loads."""
    by_dir = {d: set(committed_steps(d)) for d in dirs}
    steps = sorted(set().union(*by_dir.values()), reverse=True)
    if only_step is not None:
        steps = [s for s in steps if s == only_step]
    where = " or ".join(repr(d) for d in dirs)
    if not steps:
        what = "checkpoint" if only_step is None else f"step {only_step}"
        raise FileNotFoundError(f"no committed {what} under {where}")
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
                   replica_dir: Optional[str] = None,
                   step: Optional[int] = None) -> tuple[dict, int, str]:
    """Tables ({name: logical shape} -> {name: array}) of the newest
    committed step that loads across the primary `ckpt_dir` and the
    tier-2 `replica_dir` (`train.ckpt_replica_dir`; None or "" = none):
    a digest-poisoned primary step loads from the replica before the
    walk falls back to an older step. `step` restores that step alone
    (from either tier). Returns (tables, step, the dir it loaded from),
    so sidecars are read from the same tier."""
    return _walk_tiers(_tiers(ckpt_dir, replica_dir),
                       lambda d, s: restore_step_tables(d, s, shapes, verify),
                       only_step=step)


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


def restore_state_mesh(ckpt_dir: str, shapes: dict, opt_leaves: tuple, mesh, layout: str,
                       device, verify: str = "auto", replica_dir: Optional[str] = None):
    """`restore_state` on a mesh: rank 0 walks the tiers, broadcasts the
    step it loaded (-1: none, FileNotFoundError on every rank) and every
    leaf whole, and each rank keeps its own range of the `layout`
    (`parallel/mesh.shard_tensor`). Returns (tables, opt_state, step,
    data_state) as tensors on `device`; the data_state is the tier's
    that restored, read by rank 0."""
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.parallel.mesh import shard_tensor

    got = None
    if mesh.rank == 0:
        try:
            tables, opt, step, src = restore_state(ckpt_dir, shapes, opt_leaves, verify=verify,
                                                   replica_dir=replica_dir)
            got = (tables, opt, step, read_data_state(src, step))
        except FileNotFoundError:
            got = None
    head = torch.tensor([got[2] if got else -1], dtype=torch.int64, device=device)
    dist.broadcast(head, src=0)
    step = int(head.item())
    if step < 0:
        raise FileNotFoundError(f"no loadable checkpoint under {ckpt_dir}")
    box = [got[3] if got else None]
    dist.broadcast_object_list(box, src=0, device=device if torch.device(device).type == "cuda"
                               else None)

    def leaf(arr, shape):
        t = (torch.from_numpy(np.ascontiguousarray(arr)).to(device) if arr is not None
             else torch.empty(shape, dtype=torch.float32, device=device))
        dist.broadcast(t, src=0)
        return shard_tensor(t, mesh, layout)

    tables, opt = {}, {}
    for n in sorted(shapes):
        shape = tuple(shapes[n])
        tables[n] = leaf(got[0][n] if got else None, shape)
        opt[n] = {k: leaf(got[1][n][k] if got else None, shape) for k in opt_leaves}
    return tables, opt, step, box[0]


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




def normalize_data_state(ds: dict) -> dict:
    """A stored data_state of either version in the topology-independent
    form an elastic resume reads (`xflow_tpu/train/checkpoint.py`):
    `examples` the global total, `shard_batches` {shard index: batches
    consumed in the epoch}, `num_shards` the shard set in play and
    `world_size` the writer's. A version-1 record (one offset, the ranks
    in lockstep, one shard each) folds exactly. Raises TypeError or
    ValueError on a malformed record."""
    out = {
        "version": DATA_STATE_VERSION,
        "epoch": max(int(ds.get("epoch", 0)), 0),
        "batches": max(int(ds.get("batches", 0)), 0),
        "completed": bool(ds.get("completed", False)),
        "examples": max(int(ds.get("examples", 0)), 0),
        "quarantined_rows": max(int(ds.get("quarantined_rows", 0)), 0),
    }
    sb = ds.get("shard_batches")
    if isinstance(sb, dict):
        out["shard_batches"] = {int(k): max(int(v), 0) for k, v in sb.items()}
        out["num_shards"] = max(int(ds.get("num_shards", 0)),
                                max(out["shard_batches"], default=-1) + 1, 1)
        out["world_size"] = max(int(ds.get("world_size", 1)), 1)
        return out
    per_rank = ds.get("examples_per_rank")
    n = len(per_rank) if isinstance(per_rank, list) and per_rank else 1
    out["world_size"] = n
    out["num_shards"] = n
    out["shard_batches"] = {i: out["batches"] for i in range(n)}
    if isinstance(per_rank, list) and per_rank:
        out["examples"] = sum(max(int(x), 0) for x in per_rank)
    if out["epoch"] or out["batches"]:
        print(f"# checkpoint: v1 data_state (per-rank keyed, {n} rank(s)) folded into the "
              f"topology-independent form: global examples {out['examples']}, per-shard "
              f"offset {out['batches']}", file=sys.stderr)
    return out


def fsync_dir(path: str) -> None:
    """fsync a directory, so a rename that landed in it survives a power
    or kernel loss (a rename alone may be journaled out of order)."""
    dfd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _write_atomic(path: str, writer, fault=None) -> None:
    """Write a file through a temp name, fsync, rename, and fsync the
    directory, so a crash never leaves a half-written file under the
    final name. `fault` (`testing/faults.ckpt_write_fault`) is called
    with the temp path after `writer` lands it and before the rename,
    where a real ENOSPC or slow disk strikes; the temp is swept either
    way."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        writer(tmp)
        if fault is not None:
            fault(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(path))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _json_writer(obj):
    def write(p):
        with open(p, "w") as f:
            json.dump(obj, f)

    return write


def _write_marker(p):
    with open(p, "w") as f:
        f.write("ok\n")


def write_flat(ckpt_dir: str, flat: dict, step: int, data_state: Optional[dict] = None,
               publication: Optional[dict] = None, tier: str = "primary") -> str:
    """Write host arrays `flat` ({"tables/wv": ..., "step": ...}) as
    committed step `step`: state.npz, meta.json v3 with digests, then
    data_state.json and publication.json when given, then the COMMITTED
    marker, so a reader that sees the marker sees every sidecar. A
    leftover uncommitted dir of the same step is removed first. No
    device access: it runs on the caller's thread or the async writer's
    alike. `tier` names the destination for the disk-fault seam,
    resolved once a call. Returns the step dir."""
    fault = ckpt_write_fault(tier)
    path = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, "COMMITTED")):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)

    def write_npz(p):
        # a file object: np.savez appends ".npz" to a bare path
        with open(p, "wb") as f:
            np.savez(f, **flat)

    _write_atomic(os.path.join(path, "state.npz"), write_npz, fault)
    meta = {
        "step": step,
        "tables": sorted(k.split("/", 1)[1] for k in flat if k.startswith("tables/")),
        "format": "npz",
        "version": CHECKPOINT_VERSION,
        "world_size": 1,
        "layout": {k: list(np.asarray(v).shape) for k, v in flat.items()},
        "digests": {k: array_digest(v) for k, v in flat.items()},
    }
    _write_atomic(os.path.join(path, "meta.json"), _json_writer(meta), fault)
    if data_state is not None:
        _write_atomic(os.path.join(path, DATA_STATE_FILE), _json_writer(data_state), fault)
    if publication is not None:
        _write_atomic(os.path.join(path, PUBLICATION_FILE), _json_writer(publication), fault)
    _write_atomic(os.path.join(path, "COMMITTED"), _write_marker, fault)
    return path


def _host(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, np.float32)


def flatten_state(tables: dict, opt_state: dict, step: int) -> dict:
    """The npz layout of a training state, as the JAX package's
    `_flatten` lays it out: ``tables/<n>``, ``opt/<n>/<leaf>`` and
    ``step``, each leaf a float32 host array in the logical layout."""
    flat = {f"tables/{n}": _host(t) for n, t in tables.items()}
    for n, st in opt_state.items():
        for leaf, v in st.items():
            flat[f"opt/{n}/{leaf}"] = _host(v)
    flat["step"] = np.asarray(step, np.int32)
    return flat


def save_tables(ckpt_dir: str, tables: dict, step: int) -> str:
    """Commit `tables` ({name: host array}, logical layout) as a
    tables-only checkpoint at `step`."""
    return write_flat(ckpt_dir, flatten_state(tables, {}, step), step)


def save_state(ckpt_dir: str, tables: dict, opt_state: dict, step: int,
               data_state: Optional[dict] = None, publication: Optional[dict] = None) -> str:
    """Commit a full training state (logical [S, K] tensors or host
    arrays) with `data_state` and `publication` written before the
    COMMITTED marker."""
    return write_flat(ckpt_dir, flatten_state(tables, opt_state, step), step,
                      data_state=data_state, publication=publication)


def prune_checkpoints(ckpt_dir: str, keep: int) -> list[str]:
    """The retention sweep after a save (`train.keep_checkpoints`):
    removes committed steps beyond the `keep` newest (keep <= 0 keeps
    them all) and, whatever `keep`, every uncommitted step dir (a
    crashed save's debris: the save that just committed proves no
    writer holds it). Returns the removed paths."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    steps = committed_steps(ckpt_dir)
    live = set(steps[:keep] if keep > 0 else steps)
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if not m or int(m.group(1)) in live:
            continue
        p = os.path.join(ckpt_dir, name)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed


def tier_steps(ckpt_dir: str) -> list[int]:
    """Committed steps of one tier dir, newest first."""
    return committed_steps(ckpt_dir)


def _copier(src: str):
    """A `_write_atomic` writer that lands a copy of `src`."""

    def write(p):
        shutil.copyfile(src, p)

    return write


def mirror_step(primary_dir: str, replica_dir: str, step: int) -> str:
    """Mirror committed step `step` into the tier-2 replica dir
    (`train.ckpt_replica_dir`); returns the replica's step dir.
    Idempotent: a committed replica step is left as it is. Every file
    copies through the temp, fsync and rename of a save (the replica
    tier's disk-fault seam on each), the replica's own state.npz bytes
    are verified against the mirrored digests, and its COMMITTED lands
    last, so the replica obeys the primary's reader contract."""
    fault = ckpt_write_fault("replica")
    os.makedirs(replica_dir, exist_ok=True)
    src = os.path.join(primary_dir, f"step_{step}")
    dst = os.path.join(replica_dir, f"step_{step}")
    if os.path.exists(os.path.join(dst, "COMMITTED")):
        return dst
    if os.path.isdir(dst):
        shutil.rmtree(dst)  # a crashed mirror's debris
    os.makedirs(dst, exist_ok=True)
    for name in ("state.npz", "meta.json", DATA_STATE_FILE, PUBLICATION_FILE):
        sp = os.path.join(src, name)
        if os.path.exists(sp):
            _write_atomic(os.path.join(dst, name), _copier(sp), fault)
    meta = read_meta(replica_dir, step)
    digests = meta.get("digests") if isinstance(meta, dict) else None
    if digests:
        with np.load(os.path.join(dst, "state.npz")) as data:
            for name in data.files:
                verify_digest(name, data[name], digests, dst)
    _write_atomic(os.path.join(dst, "COMMITTED"), _write_marker, fault)
    return dst


# ------------------------------------------------------------ async saves
#
# train.ckpt_async: the fit loop snapshots and goes on; one writer thread
# owns every byte that leaves for disk (serialize, digest, sidecars,
# COMMITTED last: `write_flat`, the synchronous contract), then the
# replica mirror and the retention of both tiers.


class PinnedStaging:
    """The pinned host buffers and the side CUDA stream of the async
    snapshots of one writer, allocated at the first snapshot and reused:
    a fresh pinned allocation of the whole state every save would stall
    the fit loop. Reuse is safe only while no save is in flight, so the
    trainer checks the writer's `busy()` before it snapshots."""

    def __init__(self):
        self.buffers: dict = {}
        self.stream = None


class SaveSnapshot:
    """The state of one async save, captured on the fit loop's thread.

    The JAX snapshot blocks on `jax.device_get` because every JAX train
    step donates its input state. The port's steps never write a state
    leaf in place (the kernels and the optimizer return fresh tensors;
    the non-finite guard hands the pre-step leaves through; restore
    builds new ones), so the snapshot keeps references to the cadence
    step's leaves and issues their device-to-host copies on a side
    stream, ordered after the current stream's work, into the pinned
    buffers of `staging`, and records an event. The fit loop goes on at
    once; the writer thread waits on the event (`materialize`) before it
    serializes, and only then drops the references, so the caching
    allocator cannot hand the leaves' memory to a later step while a
    copy reads it. A copy that fails raises; it never turns into a
    synchronous save. On CPU tensors the snapshot is a plain copy."""

    def __init__(self, tables: dict, opt_state: dict, step: int,
                 staging: Optional[PinnedStaging] = None):
        import torch

        self.step = int(step)
        leaves = {f"tables/{n}": t for n, t in tables.items()}
        for n, st in opt_state.items():
            for leaf, v in st.items():
                leaves[f"opt/{n}/{leaf}"] = v
        self.nbytes = int(sum(t.numel() * t.element_size() for t in leaves.values()))
        self.alloc_ms = 0.0  # pinned allocations this snapshot made
        self._event = None
        self._leaves = None
        self.flat = {label: np.array(_host(t)) for label, t in leaves.items()
                     if not t.is_cuda}
        cuda = {label: t for label, t in leaves.items() if t.is_cuda}
        if cuda:
            staging = staging or PinnedStaging()
            device = next(iter(cuda.values())).device
            t0 = time.perf_counter()
            for label, t in cuda.items():
                buf = staging.buffers.get(label)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    staging.buffers[label] = torch.empty(t.shape, dtype=t.dtype,
                                                         pin_memory=True)
            self.alloc_ms = (time.perf_counter() - t0) * 1e3
            if staging.stream is None or staging.stream.device != device:
                staging.stream = torch.cuda.Stream(device)
            side = staging.stream
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for label, t in cuda.items():
                    staging.buffers[label].copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(side)
            self._leaves = cuda  # alive until the event fires
            self.flat.update({label: staging.buffers[label].numpy() for label in cuda})
        self.flat["step"] = np.asarray(self.step, np.int32)

    def materialize(self) -> dict:
        """{label: host array} in the npz layout, once the copies landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        self._leaves = None
        return self.flat


@dataclass
class SaveJob:
    """One submitted async save: the snapshot and what the writer needs
    to write it as a synchronous save would, captured at submit on the
    fit loop's thread (data_state keeps moving after it)."""

    snapshot: SaveSnapshot
    ckpt_dir: str
    replica_dir: str = ""
    keep: int = 0
    keep_replica: int = 0
    data_state: Optional[dict] = None
    publication: Optional[dict] = None
    queued_ts: float = 0.0


class AsyncCheckpointWriter:
    """The one background checkpoint writer (`train.ckpt_async`).

    At most one save in flight: a submit while one is pending is a
    logged, counted skip, never a queue (a queue under a slow disk would
    pile up host copies of the whole state). `drain()` blocks until
    idle (the halt, signal and end-of-fit saves use it, so the run's
    last state is durable when fit returns); `close()` drains and stops
    the thread.

    Failure policy, the JAX package's: an OSError on the primary tier
    latches `degraded`, and this and every later save is a full save
    into the replica alone; a primary failure of another kind tries the
    replica for that save only; a replica failure never harms the
    primary. Each outcome appends one kind="ckpt" record per tier to
    `sink` (a thread-safe JSONL appender), and with `ckpt_spans` one
    `checkpoint_save` span a committed write."""

    def __init__(self, sink=None, ckpt_spans: bool = False):
        self._sink = sink
        self._ckpt_spans = ckpt_spans
        self._lock = threading.Lock()
        self._job: Optional[SaveJob] = None
        self._idle = threading.Event()
        self._idle.set()
        self._wake = threading.Event()
        self._stop = False
        self.staging = PinnedStaging()
        self.skips = 0
        self.failures = 0
        self.degraded = False
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- control
    def busy(self) -> bool:
        """Whether a save is in flight (the pinned buffers are in use)."""
        with self._lock:
            return self._job is not None or not self._idle.is_set()

    def skip(self, step: int, nbytes: int, queued_ts: float) -> None:
        """Count and record a cadence save lost to the one in flight."""
        with self._lock:
            self._skip_locked(step, nbytes, queued_ts)

    def _skip_locked(self, step: int, nbytes: int, queued_ts: float) -> None:
        # every caller (`skip`, `submit`) holds self._lock
        self.skips += 1  # xflowlint: disable=XF301
        now = time.time()
        print(f"# checkpoint: async save of step {step} skipped — previous save still "
              f"in flight ({self.skips} skip(s) so far)", file=sys.stderr)
        self._record(step, nbytes, "primary", "skipped", queued_ts, now, now)

    def submit(self, job: SaveJob) -> bool:
        """Hand one save to the writer; False = a save is already in
        flight, and this one is skipped (the next cadence tries again)."""
        with self._lock:
            if self._stop:
                return False
            if self._job is not None or not self._idle.is_set():
                self._skip_locked(job.snapshot.step, job.snapshot.nbytes, job.queued_ts)
                return False
            self._job = job
            self._idle.clear()
            self._wake.set()
        return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no save is in flight. True = idle."""
        return self._idle.wait(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain and stop the thread (idempotent)."""
        self.drain(timeout)
        with self._lock:
            self._stop = True
            self._wake.set()
        self._thread.join(timeout)

    # -------------------------------------------------------------- thread
    def _run(self):
        while True:
            self._wake.wait()
            with self._lock:
                if self._stop:
                    return
                job, self._job = self._job, None
                self._wake.clear()
            if job is None:
                continue
            try:
                self._save(job)
            except BaseException as e:  # noqa: BLE001 — the writer never
                # dies: an unforeseen failure is counted and the next
                # cadence goes on
                self.failures += 1
                self.last_error = e
                print(f"# checkpoint: async save of step {job.snapshot.step} failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
            finally:
                self._idle.set()

    def _failed(self, job: SaveJob, tier: str, e: BaseException, start: float,
                note: str) -> None:
        self.failures += 1
        self.last_error = e
        print(f"# checkpoint: {note} ({type(e).__name__}: {e})", file=sys.stderr)
        self._rec(job, tier, "failed", start)

    def _committed(self, job: SaveJob, tier: str, t0: float, start: float) -> None:
        self._rec(job, tier, "committed", start)
        self._span(job, start, time.perf_counter() - t0)

    def _save(self, job: SaveJob) -> None:
        step = job.snapshot.step
        primary_ok = False
        if not self.degraded:
            t0, start = time.perf_counter(), time.time()
            try:
                write_flat(job.ckpt_dir, job.snapshot.materialize(), step,
                           data_state=job.data_state, publication=job.publication,
                           tier="primary")
                primary_ok = True
            except OSError as e:
                with self._lock:
                    self.degraded = True
                self._failed(job, "primary", e, start,
                             f"primary tier write failed at step {step}; degrading to "
                             "replica-only saves" + ("" if job.replica_dir else
                                                     " — NO replica dir is configured: "
                                                     "checkpointing is now best-effort only"))
            except Exception as e:  # noqa: BLE001 — a failure of another
                # kind still tries the replica for this save, unlatched
                self._failed(job, "primary", e, start,
                             f"primary save of step {step} failed; trying the replica tier")
        if primary_ok:
            self._committed(job, "primary", t0, start)
            prune_checkpoints(job.ckpt_dir, job.keep)
            if job.replica_dir:
                t0, start = time.perf_counter(), time.time()
                try:
                    mirror_step(job.ckpt_dir, job.replica_dir, step)
                    prune_checkpoints(job.replica_dir, job.keep_replica)
                    self._committed(job, "replica", t0, start)
                except Exception as e:  # noqa: BLE001 — never harms the primary
                    self._failed(job, "replica", e, start,
                                 f"replica mirror of step {step} failed; the primary "
                                 "commit stands")
        elif job.replica_dir:
            # degraded, or the primary just failed: a full save, not a mirror
            t0, start = time.perf_counter(), time.time()
            try:
                write_flat(job.replica_dir, job.snapshot.materialize(), step,
                           data_state=job.data_state, publication=job.publication,
                           tier="replica")
                prune_checkpoints(job.replica_dir, job.keep_replica)
                self._committed(job, "replica", t0, start)
            except Exception as e:  # noqa: BLE001 — both tiers failed: counted
                self._failed(job, "replica", e, start,
                             f"replica-tier save of step {step} failed too; step not "
                             "checkpointed")

    # ------------------------------------------------------------ telemetry
    def _rec(self, job: SaveJob, tier: str, event: str, start: float) -> None:
        self._record(job.snapshot.step, job.snapshot.nbytes, tier, event,
                            job.queued_ts, start, time.time())

    def _record(self, step, nbytes, tier, event, queued_ts, start, end) -> None:
        """One kind="ckpt" record, with the JAX package's keys; the
        replica's queue_ms includes the primary write it mirrors."""
        sink = self._sink
        if sink is None or not getattr(sink, "enabled", False):
            return
        sink.append({
            "kind": "ckpt",
            "step": int(step),
            "tier": tier,
            "event": event,
            "queued_ts": round(float(queued_ts), 6),
            "committed_ts": round(float(end), 6),
            "queue_ms": round(max(start - queued_ts, 0.0) * 1000.0, 3),
            "write_ms": round(max(end - start, 0.0) * 1000.0, 3),
            "bytes": int(nbytes),
            "skips": int(self.skips),
            "degraded": bool(self.degraded),
        })

    def _span(self, job: SaveJob, t0_wall: float, dur_s: float) -> None:
        sink = self._sink
        if not self._ckpt_spans or sink is None or not getattr(sink, "enabled", False):
            return
        from xflow_tpu_torch.tracing import emit_op_span

        emit_op_span(sink, "checkpoint_save", t0_wall, dur_s,
                     step=int(job.snapshot.step), bytes=int(job.snapshot.nbytes))


def export_sparse_array(w: np.ndarray, out_path: str) -> int:
    """Write the nonzero rows of a weight array as `slot\\tweight...`
    text (`%.8g`); returns their count."""
    w = np.asarray(w)
    if w.ndim == 1:
        nz = np.nonzero(w)[0]
    else:
        nz = np.nonzero(np.abs(w).sum(axis=tuple(range(1, w.ndim))))[0]
    with open(out_path, "w") as f:
        for i in nz:
            vals = ("%.8g" % w[i] if w.ndim == 1
                    else "\t".join("%.8g" % x for x in np.ravel(w[i])))
            f.write(f"{int(i)}\t{vals}\n")
    return int(nz.size)
