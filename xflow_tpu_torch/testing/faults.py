"""Fault injectors, after `xflow_tpu/testing/faults.py`: the serving
chaos injectors (`serve_faults_from_env`, `hard_kill`), the checkpoint
write fault (`ckpt_write_fault`), the fit loop's kill and pacing drills
(`kill_step_from_env`, `fit_delays_from_env`, `abort_after_step`) and
the multi-slice tier's (`sync_faults_from_env`). Each environment
injector is read once, when the run or the syncer starts; unset, none
costs anything a step.

The corruption helpers, whose bytes equal the JAX ones' from the same
seed: `truncate_file` and `bitflip_file` (byte-level), `bitflip_npz_array`
(flips inside one array member's payload and rewrites the zip with fresh
CRCs: silent but for the checkpoint's per-array digests),
`corrupt_npz_checkpoint` (applies them to a committed step's `state.npz`
or `data_state.json`, leaving the commit marker), `poison_nan_batches`
(NaN labels on chosen training steps: the non-finite guard's trigger)
and `write_malformed_libffm` (a shard mixing good rows with malformed
ones: the bad-record monitor's input). The JAX package's
`corrupt_orbax_checkpoint` has no counterpart: the port writes npz
checkpoints only."""

from __future__ import annotations

import errno
import os
import random
import signal
import struct
import time
import zipfile
from typing import Iterable, Optional

import numpy as np

from xflow_tpu_torch.telemetry import resolve_replica, resolve_restart_gen, resolve_slice


def _num(name: str, cast, default):
    try:
        return cast(os.environ.get(name, default) or default)
    except ValueError:
        return cast(default)


def kill_step_from_env(rank: int) -> int:
    """The 1-based step after which this rank SIGKILLs itself (0 = off),
    the supervised-restart drill:

    - XFLOW_FAULT_KILL_STEP: kill once that step completed, after its
      heartbeat and checkpoint cadence (a kill on a checkpoint step
      leaves that step committed);
    - XFLOW_FAULT_KILL_RANK: only this rank (default every rank);
    - XFLOW_FAULT_KILL_GEN (default 0): only in this restart generation,
      so the relaunch, which inherits the environment, survives.
    """
    try:
        step = int(os.environ.get("XFLOW_FAULT_KILL_STEP", 0) or 0)
    except ValueError:
        return 0
    if step <= 0:
        return 0
    r = os.environ.get("XFLOW_FAULT_KILL_RANK")
    if r is not None:
        try:
            if int(r) != rank:
                return 0
        except ValueError:
            return 0
    try:
        want_gen = int(os.environ.get("XFLOW_FAULT_KILL_GEN", 0) or 0)
    except ValueError:
        want_gen = 0
    return step if resolve_restart_gen() == want_gen else 0


def abort_after_step(trainer, step: int) -> None:
    """Make `trainer`'s training stream raise RuntimeError right after
    the batch of the 1-based step `step` (counted across epochs and
    fits) was taken, the in-process crash: checkpoints committed before
    it survive, so a resume runs the data_state path."""
    orig = trainer._train_feed
    counter = [0]

    def wrapped(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            counter[0] += 1
            if counter[0] >= step:
                raise RuntimeError(f"injected abort after step {counter[0]} "
                                   "(testing/faults.abort_after_step)")

    trainer._train_feed = wrapped


def fit_delays_from_env(rank: int) -> tuple[float, int, float]:
    """(per_step_sleep_s, stall_step, stall_s) for this rank, the
    straggler drill:

    - XFLOW_FAULT_STEP_DELAY_S: sleep this long before every step;
    - XFLOW_FAULT_STALL_S (+ XFLOW_FAULT_STALL_STEP, default 1): sleep
      once, after that 1-based step;
    - XFLOW_FAULT_DELAY_RANK: only this rank (default every rank).
    """
    r = os.environ.get("XFLOW_FAULT_DELAY_RANK")
    if r is not None:
        try:
            if int(r) != rank:
                return 0.0, 0, 0.0
        except ValueError:
            return 0.0, 0, 0.0
    delay = float(os.environ.get("XFLOW_FAULT_STEP_DELAY_S", 0) or 0)
    stall = float(os.environ.get("XFLOW_FAULT_STALL_S", 0) or 0)
    stall_step = int(os.environ.get("XFLOW_FAULT_STALL_STEP", 1) or 1)
    return delay, stall_step, stall


def sync_faults_from_env() -> tuple[int, float]:
    """(kill_round, sync_delay_s) of this slice's sync tier, read once
    when its `SliceSyncer` is built:

    - XFLOW_FAULT_SLICE_KILL_ROUND: SIGKILL the slice as it enters that
      1-based round, before its delta publishes (the slice-loss drill);
    - XFLOW_FAULT_SYNC_DELAY_S: sleep this long in every round (a
      straggling slice);
    - XFLOW_FAULT_SLICE: only the slice of this index (XFLOW_SLICE);
      XFLOW_FAULT_SLICE_KILL_SLICE / XFLOW_FAULT_SYNC_DELAY_SLICE
      override it for one injector;
    - XFLOW_FAULT_SLICE_KILL_GEN (default 0): kill only in this restart
      generation, so the relaunched slice rejoins.
    """

    def targeted(var: str) -> bool:
        target = os.environ.get(var, os.environ.get("XFLOW_FAULT_SLICE"))
        if target is None:
            return True
        try:
            return int(target) == resolve_slice()
        except (ValueError, TypeError):
            return False

    kill = (_num("XFLOW_FAULT_SLICE_KILL_ROUND", int, 0)
            if targeted("XFLOW_FAULT_SLICE_KILL_SLICE") else 0)
    delay = (_num("XFLOW_FAULT_SYNC_DELAY_S", float, 0.0)
             if targeted("XFLOW_FAULT_SYNC_DELAY_SLICE") else 0.0)
    if kill > 0 and resolve_restart_gen() != _num("XFLOW_FAULT_SLICE_KILL_GEN", int, 0):
        kill = 0
    return max(kill, 0), max(delay, 0.0)


def hard_kill() -> None:
    """SIGKILL this process: no atexit, no finally, no flush beyond what
    is on disk, as a host that is preempted or killed for memory."""
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except OSError:
        pass
    os._exit(137)


def serve_faults_from_env() -> tuple[float, int]:
    """(per_batch_delay_s, kill_after_batches) for this serve process,
    read once when the `ServeApp` is built (no cost a batch when unset):

    - XFLOW_FAULT_SERVE_DELAY_S: sleep this long before every device
      batch (a persistently slow replica);
    - XFLOW_FAULT_SERVE_KILL_BATCHES: SIGKILL the process right after the
      Nth answered batch (a replica dying under load);
    - XFLOW_FAULT_SERVE_REPLICA: only the fleet replica of this index
      (XFLOW_REPLICA) injects; unset = every process;
    - XFLOW_FAULT_SERVE_KILL_GEN (default 0): kill only in this restart
      generation, so the supervised relaunch, which inherits the
      environment, survives and rejoins.
    """

    target = os.environ.get("XFLOW_FAULT_SERVE_REPLICA")
    if target is not None:
        try:
            if int(target) != resolve_replica():
                return 0.0, 0
        except ValueError:
            return 0.0, 0
    delay = _num("XFLOW_FAULT_SERVE_DELAY_S", float, 0.0)
    kill = _num("XFLOW_FAULT_SERVE_KILL_BATCHES", int, 0)
    if kill > 0 and resolve_restart_gen() != _num("XFLOW_FAULT_SERVE_KILL_GEN", int, 0):
        kill = 0
    return max(delay, 0.0), max(kill, 0)


def ckpt_write_fault(tier: str):
    """The disk-fault seam of checkpoint writes, for the async tiered
    drills: a callback `fault(tmp_path)` the writer calls on each staged
    temp file just before its commit rename, or None when no fault is
    armed. Resolved once a save a tier, so the ENOSPC budget is a
    save's, not the run's.

    - XFLOW_FAULT_CKPT_ENOSPC_BYTES: once the save's staged bytes pass
      this budget, raise OSError(ENOSPC), a volume filling mid-write;
    - XFLOW_FAULT_CKPT_SLOW_S_PER_MB: sleep size/1e6 * this a staged
      file, a slow disk that holds a save in flight;
    - XFLOW_FAULT_CKPT_TIER: only "primary" or "replica" (default both).
    """
    target = os.environ.get("XFLOW_FAULT_CKPT_TIER")
    if target is not None and target != tier:
        return None

    enospc = _num("XFLOW_FAULT_CKPT_ENOSPC_BYTES", int, 0)
    slow = _num("XFLOW_FAULT_CKPT_SLOW_S_PER_MB", float, 0.0)
    if enospc <= 0 and slow <= 0:
        return None
    written = {"bytes": 0}

    def fault(tmp_path: str) -> None:
        size = os.path.getsize(tmp_path)
        if slow > 0:
            time.sleep(size / 1e6 * slow)
        written["bytes"] += size
        if 0 < enospc < written["bytes"]:
            raise OSError(errno.ENOSPC, "injected ENOSPC (XFLOW_FAULT_CKPT_ENOSPC_BYTES)",
                          tmp_path)

    return fault


# ------------------------------------------------------------- byte faults
def truncate_file(path: str, keep_frac: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Truncate `path` to `keep_bytes` (or `keep_frac` of its size): a
    torn write. Returns the new size."""
    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else int(size * keep_frac)
    keep = max(0, min(size, keep))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def bitflip_file(path: str, offset: Optional[int] = None, count: int = 8,
                 seed: int = 0) -> list:
    """Flip one bit in each of `count` bytes (offsets drawn from `seed`;
    `offset` pins the first): silent media corruption. Returns the
    offsets touched."""
    size = os.path.getsize(path)
    if size == 0:
        return []
    rng = random.Random(seed)
    offsets = sorted({offset if offset is not None and i == 0 else rng.randrange(size)
                      for i in range(count)})
    with open(path, "rb+") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << rng.randrange(8))]))
    return offsets


def bitflip_npz_array(path: str, member: Optional[str] = None, count: int = 8,
                      seed: int = 0, offset: Optional[int] = None) -> list:
    """Flip bits inside one array member's payload of an .npz (default
    the largest) past its .npy header, and rewrite the container
    uncompressed with CRCs over the flipped bytes: the zip layer reads it
    clean, and only the per-array digests catch it. `offset` pins the
    first flipped byte relative to the payload (outside it: ValueError).
    Returns the flipped offsets within the member's bytes."""
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        target = member or max(names, key=lambda n: z.getinfo(n).file_size)
        blobs = {n: z.read(n) for n in names}
    data = bytearray(blobs[target])
    # .npy: magic, version, header length (2 bytes in v1, 4 in v2+), header
    if len(data) < 12 or data[:6] != b"\x93NUMPY":
        raise ValueError(f"{target!r} in {path!r} is not an .npy member")
    if data[6] >= 2:
        start = 12 + struct.unpack("<I", data[8:12])[0]
    else:
        start = 10 + struct.unpack("<H", data[8:10])[0]
    if start >= len(data):
        raise ValueError(f"{target!r} has no array payload to corrupt")
    first = None
    if offset is not None:
        first = start + int(offset)
        if not start <= first < len(data):
            raise ValueError(f"offset {offset} is outside {target!r}'s array payload "
                             f"(0..{len(data) - start - 1})")
    rng = random.Random(seed)
    offsets = sorted({first if first is not None and i == 0 else rng.randrange(start, len(data))
                      for i in range(count)})
    for off in offsets:
        data[off] ^= 1 << rng.randrange(8)
    blobs[target] = bytes(data)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for n in names:
            z.writestr(n, blobs[n])
    return offsets


def corrupt_npz_checkpoint(ckpt_dir: str, step: Optional[int] = None, mode: str = "truncate",
                           target: str = "state", **kw) -> str:
    """Corrupt a file of the newest (or given) committed checkpoint, the
    commit marker left intact. `target` "state": `state.npz`, truncated
    (`truncate_file`) or, under mode "bitflip", flipped inside an array
    payload (`bitflip_npz_array`); "data_state": `data_state.json`,
    truncated or flipped (`bitflip_file`). Returns the file's path."""
    from xflow_tpu_torch.train.checkpoint import DATA_STATE_FILE, committed_steps

    if step is None:
        steps = committed_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir!r}")
        step = steps[0]
    if target == "data_state":
        victim = os.path.join(ckpt_dir, f"step_{step}", DATA_STATE_FILE)
        if not os.path.exists(victim):
            raise FileNotFoundError(f"checkpoint step {step} has no data_state (pre-v2 "
                                    f"checkpoint?) under {ckpt_dir!r}")
    elif target == "state":
        victim = os.path.join(ckpt_dir, f"step_{step}", "state.npz")
        if mode == "bitflip":
            bitflip_npz_array(victim, **{k: v for k, v in kw.items()
                                         if k in ("member", "offset", "count", "seed")})
            return victim
    else:
        raise ValueError(f"target={target!r}: expected state|data_state")
    if mode == "truncate":
        truncate_file(victim, **{k: v for k, v in kw.items() if k in ("keep_frac", "keep_bytes")})
    elif mode == "bitflip":
        bitflip_file(victim, **{k: v for k, v in kw.items() if k in ("offset", "count", "seed")})
    else:
        raise ValueError(f"mode={mode!r}: expected truncate|bitflip")
    return victim


# ------------------------------------------------------------- data faults
def poison_nan_batches(trainer, steps: Iterable[int], value: float = float("nan")) -> None:
    """Make `trainer`'s training stream deliver `value` as every label of
    the 1-based steps in `steps` (counted across epochs and fits), after
    parsing and before the copy to the device: libffm labels cannot be
    non-finite, so this models an upstream feature-store fault, the
    non-finite guard's trigger. Eval passes do not count."""
    bad = {int(s) for s in steps}
    orig = trainer._train_feed
    counter = [0]

    def wrapped(*args, **kwargs):
        for batch, arrays in orig(*args, **kwargs):
            counter[0] += 1
            if counter[0] in bad:
                arrays = dict(arrays)
                arrays["labels"] = np.full_like(np.asarray(arrays["labels"]), value)
            yield batch, arrays

    trainer._train_feed = wrapped


def write_malformed_libffm(path: str, n_good: int = 40, n_bad: int = 6,
                           n_junk_label: int = 4, n_nonrows: int = 5, seed: int = 0,
                           truncated_tail: bool = False) -> dict:
    """Write a libffm shard mixing, shuffled from `seed`: `n_good` good
    rows; `n_bad` labeled rows whose every token lacks ':' (rows of no
    feature: the monitor's bad rows); `n_junk_label` rows with junk
    labels and valid features (label 0); `n_nonrows` lines no parser
    takes as a row (empty, blank, a lone tab, label only); and with
    `truncated_tail` a last line torn mid-token without a newline (still
    a row). Returns {"rows", "bad", "lines"}: the rows every counter and
    parser must report, the zero-feature ones among them, the lines."""
    rng = random.Random(seed)
    lines = []
    for _ in range(n_good):
        toks = " ".join(f"{f}:{rng.randrange(1000)}:1" for f in range(rng.randrange(1, 5)))
        lines.append((f"{rng.randrange(2)}\t{toks}", "good"))
    for _ in range(n_bad):
        junk = " ".join(rng.choice(["garbage", "??", "novalue", "a_b"])
                        for _ in range(rng.randrange(1, 3)))
        lines.append((f"{rng.randrange(2)}\t{junk}", "bad"))
    for i in range(n_junk_label):
        lines.append((f"abc{i}\t0:{rng.randrange(1000)}:1", "junk_label"))
    lines.extend((line, "nonrow") for line in ["", "   ", "\t", "1", "justalabel"][:n_nonrows])
    rng.shuffle(lines)
    tail = "1\t3:12345" if truncated_tail else None
    rows = sum(1 for _, kind in lines if kind != "nonrow")
    bad = sum(1 for _, kind in lines if kind == "bad")
    with open(path, "w") as f:
        for text, _ in lines:
            f.write(text + "\n")
        if tail is not None:
            f.write(tail)  # no trailing newline
    if tail is not None:
        rows += 1
    return {"rows": rows, "bad": bad, "lines": len(lines) + (1 if tail else 0)}
