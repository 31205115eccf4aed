"""The multi-slice sync tier, after `xflow_tpu/parallel/multislice.py`:
slices that train apart, each one `python -m xflow_tpu_torch train`
process with its own data shards and checkpoints, exchange additive
table deltas through a shared directory under a staleness bound, the
asynchronous parameter-server tier over slices that each train
synchronously.

Delta model: every slice keeps `base`, its state at the last sync. At a
sync boundary it publishes ``delta = local - base``, applies every peer
delta it has not applied yet, in (round, slice) order and each once,
and rebases. All slices start from the same seeded state, so once caught
up they hold ``init + sum(all deltas)``, however stale each exchange
ran. When no peer delta applies (one slice, or nothing landed), the live
state passes through untouched: the same tensors, no float round trip,
so a single slice's run is bitwise a run without the tier.

Failure semantics: every wait is bounded by `sync.timeout_s` with
`sync.retries` backoff-spaced re-checks; a missed bound follows
`sync.on_stale` and is counted in the kind="sync" record; a slice that
dies is dropped from `membership.json` by the launcher and its peers
stop waiting on it, but still apply the deltas it committed; a
relaunched slice resumes its own checkpoint and adopts the freshest
published full-state snapshot.

The files are the JAX tier's: `delta_s<slice>_r<round>.npz` and
`snap_s<slice>_r<round>.npz`, each written to a temporary name, renamed,
then witnessed by its `.ok` marker, with the JAX checkpoint's flat key
names (`tables/<n>`, `opt/<n>/<leaf>`; never `step`, which is each
slice's own, except in a snapshot). The port keeps tables in their
logical `[S, K]` layout, so a fused FM table's arrays are the logical
rows where the JAX package writes its packed storage.

Two choices of the port: the arithmetic (`local - base`, the applied
sums) runs on the host in numpy float32, which rounds as the card's
elementwise float32 `-` and `+` do; and a round's copy off the card goes
through pinned buffers reused across rounds (the checkpoint's
`PinnedStaging`, on a side stream after the step's work), then into
private host arrays, since the next round reuses the buffers.

A slice may be a world of ranks (an in-slice mesh, `mesh` and its table
`layout`; the JAX syncer flattens a sharded state to the host and puts
each merged leaf back on its sharding). The slice's rank 0 alone touches
the sync dir: every rank takes part in gathering the whole state
(`parallel/train_step.gather_state`), rank 0 writes and reads the same
npz members, and the merged leaves go back to each rank's block by a
broadcast from rank 0. Every decision of a round (the peers applied, the
wait's outcome, a snapshot adopted) is made on rank 0 and broadcast with
its record, so the ranks of a slice cannot diverge.

`launch_multislice` runs the slices: each under its own supervision
loop (a dead slice relaunches alone with `train.resume=true`, no
fail-fast: slices share no collective), the watchdog's dead verdict
killing a wedged slice so its loop acts, and the launcher owning
`membership.json`.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import TYPE_CHECKING, Optional

import numpy as np

from xflow_tpu_torch.train.checkpoint import PinnedStaging, SaveSnapshot, _write_atomic

if TYPE_CHECKING:  # the config type only
    from xflow_tpu_torch.config import SyncConfig

MEMBERSHIP_FILE = "membership.json"
_DELTA_RE = re.compile(r"^delta_s(\d+)_r(\d+)\.ok$")
_SNAP_RE = re.compile(r"^snap_s(\d+)_r(\d+)\.ok$")
_POLL_S = 0.05  # the staleness wait's poll: one readdir


# ----------------------------------------------------------- membership
def write_membership(sync_dir: str, live, run_id: str = "", note: str = "") -> None:
    """Publish the live slice set atomically (the launcher alone writes
    it; every syncer rereads it on each wait poll)."""
    payload = {"live": sorted(int(s) for s in live), "run_id": run_id, "note": note,
               "ts": round(time.time(), 6)}

    def write_json(p):
        with open(p, "w") as f:
            json.dump(payload, f)

    _write_atomic(os.path.join(sync_dir, MEMBERSHIP_FILE), write_json)


def read_membership(sync_dir: str, num_slices: int) -> set:
    """The live slice set; a missing or damaged file, or one naming no
    slice in range, means every slice is live (the timeouts bound a wrong
    live answer; a wrong dead one would drop a slice's deltas)."""
    try:
        with open(os.path.join(sync_dir, MEMBERSHIP_FILE)) as f:
            data = json.load(f)
        live = {int(s) for s in data["live"]}
    except (OSError, ValueError, TypeError, KeyError):
        return set(range(num_slices))
    return {s for s in live if 0 <= s < num_slices} or set(range(num_slices))


# ------------------------------------------------------------ the syncer
class SliceSyncer:
    """One slice's side of the tier: publish my delta, gather my peers'
    under the staleness bound, apply, rebase. It writes only the sync
    dir; `sync` returns the new state and the kind="sync" record body,
    which the trainer appends. Rounds are 1-based; ``_applied[p]`` is the
    last round of peer p folded in (0: none). `clock` and `sleep` are
    the waits' (a test injects both)."""

    def __init__(self, sync_cfg: SyncConfig, slice_id: int, num_slices: int, clock=time.monotonic,
                 sleep=time.sleep, mesh=None, layout: str = "full"):
        mode = str(sync_cfg.mode)
        if mode not in ("sync", "bounded", "async"):
            raise ValueError(f"sync.mode={mode!r}: expected sync|bounded|async "
                             "(off never constructs a syncer)")
        if not sync_cfg.dir:
            raise ValueError("sync.dir is empty: the sync tier needs a shared "
                             "directory (launch-multislice wires <run_dir>/sync)")
        from xflow_tpu_torch.testing.faults import sync_faults_from_env

        self.cfg = sync_cfg
        self.mode = mode
        self.k = 0 if mode == "sync" else max(int(sync_cfg.staleness_k), 0)
        self.slice_id = int(slice_id)
        self.num_slices = max(int(num_slices), 1)
        self.dir = sync_cfg.dir
        self.round = 0
        self._base: Optional[dict] = None
        self._applied = {p: 0 for p in range(self.num_slices) if p != self.slice_id}
        self._last_live = set(range(self.num_slices))
        self._adopted = False
        self._clock = clock
        self._sleep = sleep
        self._staging = None  # pinned buffers of the copy off the card
        self._kill_round, self._delay_s = sync_faults_from_env()
        self.last_split: dict = {}  # the last round's parts, ms
        self.mesh, self.layout = mesh, layout  # an in-slice mesh (None: one device)
        self._lead = mesh is None or mesh.rank == 0  # the rank that touches the dir
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------- state <-> host
    def _flatten(self, state) -> dict:
        """Private host copies of the syncable leaves, tables and
        optimizer state, never the step. On a mesh every rank gathers the
        whole leaves (a collective) and rank 0 alone keeps them ({} on
        the others)."""
        if self.mesh is not None:
            from xflow_tpu_torch.parallel.train_step import gather_state

            state = gather_state(state, self.mesh, self.layout)
            if not self._lead:
                return {}
        if self._staging is None:
            self._staging = PinnedStaging()
        flat = SaveSnapshot(state.tables, state.opt_state, 0, self._staging).materialize()
        flat.pop("step", None)
        return {k: np.array(v) for k, v in flat.items()}

    def _rebuild(self, state, flat: Optional[dict]):
        """The state with the merged host arrays placed on each leaf's
        device and dtype (the step untouched). On a mesh rank 0's arrays
        (`flat`; None on the others) are broadcast and each rank keeps its
        block."""
        import torch

        def put(arr, like):
            return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
                device=like.device, dtype=like.dtype)

        def place(key, like):
            if self.mesh is None:
                return put(flat[key], like)
            return self._broadcast_leaf(flat[key] if self._lead else None, like)

        tables = {n: place(f"tables/{n}", t) for n, t in state.tables.items()}
        opt = {n: {k: place(f"opt/{n}/{k}", v) for k, v in st.items()}
               for n, st in state.opt_state.items()}
        return state._replace(tables=tables, opt_state=opt)

    def _broadcast_leaf(self, arr: Optional[np.ndarray], like):
        """Rank 0's whole leaf `arr`, broadcast over the slice, as this
        rank's block in the layout of `like` (its live block)."""
        import torch
        import torch.distributed as dist

        from xflow_tpu_torch.parallel.mesh import shard_tensor

        shape = tuple(like.shape)
        if like.ndim:
            shape = (shape[0] * self.mesh.owners(self.layout),) + shape[1:]
        whole = (torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.mesh.device)
                 if self._lead else torch.empty(shape, dtype=torch.float32,
                                                device=self.mesh.device))
        dist.broadcast(whole, src=0)
        return shard_tensor(whole, self.mesh, self.layout).to(device=like.device,
                                                               dtype=like.dtype)

    def _agree(self, obj):
        """Rank 0's `obj`, on every rank of the slice (as is without a mesh)."""
        if self.mesh is None:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self.mesh.device)
        return box[0]

    def attach(self, state) -> None:
        """Fix the delta base at the state entering the fit loop (after
        any restore and snapshot adoption); before the first `sync`. A
        relaunched slice numbers its rounds past its last published one;
        one that adopted no snapshot skips every peer round already
        published (its checkpoint folded in an unknown prefix of them:
        re-applying would count them twice)."""
        from xflow_tpu_torch.telemetry import resolve_restart_gen

        self._base = self._flatten(state)
        latest = self._scan(_DELTA_RE) if self._lead else {}
        self.round = self._agree(max(self.round, latest.get(self.slice_id, 0)))
        if resolve_restart_gen() > 0 and not self._adopted:
            for p in self._applied:
                self._applied[p] = max(self._applied[p], latest.get(p, 0))

    # ------------------------------------------------------ dir scans
    def _scan(self, rx: re.Pattern) -> dict:
        """{slice: newest committed round} of one marker family."""
        latest: dict = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return latest
        for name in names:
            m = rx.match(name)
            if m:
                s, r = int(m.group(1)), int(m.group(2))
                if r > latest.get(s, 0):
                    latest[s] = r
        return latest

    def _live(self) -> set:
        return read_membership(self.dir, self.num_slices)

    def _delta_path(self, s: int, r: int) -> str:
        return os.path.join(self.dir, f"delta_s{s}_r{r}.npz")

    def _snap_path(self, s: int, r: int) -> str:
        return os.path.join(self.dir, f"snap_s{s}_r{r}.npz")

    def _publish(self, kind: str, path: str, marker: str, arrays: dict,
                 extra: Optional[dict] = None) -> int:
        """The npz through a temporary name and a rename, then its JSON
        `.ok` marker; returns the npz's bytes."""

        def write_npz(p):
            with open(p, "wb") as f:
                np.savez(f, **arrays)

        _write_atomic(path, write_npz)
        size = os.path.getsize(path)
        meta = {"kind": kind, "slice": self.slice_id, "bytes": size,
                "ts": round(time.time(), 6), **(extra or {})}

        def write_marker(p):
            with open(p, "w") as f:
                json.dump(meta, f)

        _write_atomic(marker, write_marker)
        return size

    # ------------------------------------------------ snapshot catch-up
    def adopt_latest_snapshot(self, state):
        """A relaunched slice's catch-up: the syncable leaves become the
        freshest snapshot's (the highest round, ties to the lowest
        slice), the step and the data position stay the slice's own.
        Returns (state, (round, source slice) or None). Peer rounds the
        snapshot folded in are skipped from then on. On a mesh rank 0
        reads it and the ranks adopt it together."""
        flat, got = None, None
        if self._lead:
            flat, got = self._read_latest_snapshot()
        got = self._agree(got)
        if got is None:
            return state, None
        r, src = got
        state = self._rebuild(state, flat)
        self._base = flat
        for p in self._applied:
            self._applied[p] = max(self._applied[p], r)
        self.round = max(self.round, r)
        self._adopted = True
        return state, (r, src)

    def _read_latest_snapshot(self) -> tuple:
        """(leaves, (round, source slice)) of the freshest snapshot, or
        (None, None) when there is none or it does not read."""
        snaps = self._scan(_SNAP_RE)
        if not snaps:
            return None, None
        r = max(snaps.values())
        src = min(s for s, rr in snaps.items() if rr == r)
        try:
            with np.load(self._snap_path(src, r)) as z:
                return {k: z[k] for k in z.files if k != "step"}, (r, src)
        except (OSError, ValueError) as e:
            print(f"# multislice: snapshot s{src} r{r} unreadable ({type(e).__name__}: {e}); "
                  "rejoining without catch-up", file=sys.stderr)
            return None, None

    # ------------------------------------------------------- the round
    def _wait_for_bound(self, want: int, peers_of) -> tuple:
        """Wait until every live peer published round >= `want`, the
        membership dropped the laggard, or the timeout and retries ran
        out. Returns (satisfied, timeouts, live)."""
        from xflow_tpu_torch.launch.supervise import backoff_delay

        timeouts = 0
        retries = max(int(self.cfg.retries), 0)
        timeout_s = max(float(self.cfg.timeout_s), 0.0)
        for attempt in range(retries + 1):
            deadline = self._clock() + timeout_s
            while True:
                live = self._live()
                latest = self._scan(_DELTA_RE)
                if all(latest.get(p, 0) >= want for p in peers_of(live)):
                    return True, timeouts, live
                if self._clock() >= deadline:
                    break
                self._sleep(_POLL_S)
            timeouts += 1
            if attempt < retries:
                self._sleep(backoff_delay(attempt, float(self.cfg.backoff_s)))
        return False, timeouts, self._live()

    def sync(self, state) -> tuple:
        """One round: publish my delta, wait under the staleness policy,
        apply the peers' unapplied rounds up to mine in (round, slice)
        order, rebase. Returns (state, the kind="sync" record body).
        `last_split` holds the round's parts in ms: `copy_off` (the
        state to the host), `write` (the delta's npz), `wait`, `apply`
        (the peers' npz read and added), `copy_back` (the merged state
        to the device) and `snapshot`. On a mesh every rank calls it;
        rank 0 runs the round and broadcasts its outcome and record."""
        t0 = time.perf_counter()
        self.round += 1
        r = self.round
        if self._kill_round and r == self._kill_round:
            # the slice-loss drill: die entering the round, before publishing
            from xflow_tpu_torch.testing.faults import hard_kill

            hard_kill()
        if self._delay_s:
            self._sleep(self._delay_s)  # the straggler drill
        if self._base is None:
            raise RuntimeError("SliceSyncer.sync before attach()")
        t_copy = time.perf_counter()
        local = self._flatten(state)
        t_files = time.perf_counter()
        merged, record = self._round_files(state, r, local) if self._lead else (None, None)
        changed, record = self._agree((merged is not None, record))
        t_back = time.perf_counter()
        if changed:
            state = self._rebuild(state, merged)
        t_end = time.perf_counter()
        self.last_split.update(copy_off=(t_files - t_copy) * 1e3,
                               copy_back=(t_end - t_back) * 1e3)
        return state, dict(record, dur_ms=round((t_end - t0) * 1e3, 3))

    def _round_files(self, state, r: int, local: dict) -> tuple:
        """The dir's side of round `r` from the host leaves `local`:
        publish the delta, wait, apply the peers' rounds, rebase, and
        publish a snapshot on its cadence. Returns (the merged leaves, or
        None when no peer delta applied, the kind="sync" record body)."""
        pc = time.perf_counter
        t_write = pc()
        delta = {k: local[k] - self._base[k] for k in local}
        bytes_out = self._publish("delta", self._delta_path(self.slice_id, r),
                                  os.path.join(self.dir, f"delta_s{self.slice_id}_r{r}.ok"),
                                  delta, extra={"round": r})
        del delta
        t_wait = pc()

        def peers_of(live):
            return [p for p in sorted(live) if p != self.slice_id and p in self._applied]

        timeouts = 0
        if self.mode != "async":
            want = r - self.k
            latest = self._scan(_DELTA_RE)
            satisfied = all(latest.get(p, 0) >= want for p in peers_of(self._live()))
            if not satisfied and want > 0 and not (
                    self.mode == "bounded" and str(self.cfg.on_stale) == "proceed"):
                _, timeouts, _ = self._wait_for_bound(want, peers_of)
        t_apply = pc()
        # every peer's rounds up to mine, live or not: a dead slice's
        # committed deltas are trained examples
        latest = self._scan(_DELTA_RE)
        merged: Optional[dict] = None
        bytes_in = 0
        applied = 0
        for p in sorted(self._applied):
            top = min(latest.get(p, 0), r)
            for rr in range(self._applied[p] + 1, top + 1):
                path = self._delta_path(p, rr)
                if not os.path.exists(os.path.join(self.dir, f"delta_s{p}_r{rr}.ok")):
                    continue  # a gap a crashed generation left
                try:
                    with np.load(path) as z:
                        if merged is None:
                            merged = {k: local[k].copy() for k in local}
                        for k in merged:
                            merged[k] += z[k]
                except (OSError, ValueError, KeyError) as e:
                    print(f"# multislice: delta s{p} r{rr} unreadable "
                          f"({type(e).__name__}: {e}); skipped", file=sys.stderr)
                    continue
                bytes_in += os.path.getsize(path)
                applied += 1
            self._applied[p] = max(self._applied[p], top)
        # the passthrough keeps the same tensors (the caller rebuilds only
        # from a merge)
        self._base = local if merged is None else merged
        t_snap = pc()
        live = self._live()
        lags = {str(p): r - self._applied[p] for p in peers_of(live)}
        lag_max = max(lags.values(), default=0)
        stale = sum(1 for v in lags.values() if v > self.k)
        joined = sorted(live - self._last_live)
        left = sorted(self._last_live - live)
        self._last_live = live
        if self.cfg.snapshot_every > 0 and r % int(self.cfg.snapshot_every) == 0:
            snap = dict(self._base)
            snap["step"] = np.asarray(state.step, np.int32)
            self._publish("snapshot", self._snap_path(self.slice_id, r),
                          os.path.join(self.dir, f"snap_s{self.slice_id}_r{r}.ok"), snap,
                          extra={"round": r, "step": int(state.step)})
        t_end = pc()
        self.last_split = {
            "write": (t_wait - t_write) * 1e3, "wait": (t_apply - t_wait) * 1e3,
            "apply": (t_snap - t_apply) * 1e3, "snapshot": (t_end - t_snap) * 1e3,
        }
        record = {
            "kind": "sync", "round": r, "k": self.k, "mode": self.mode, "live": sorted(live),
            "joined": joined, "left": left, "bytes_out": int(bytes_out),
            "bytes_in": int(bytes_in), "applied": int(applied), "stale": int(stale),
            "timeouts": int(timeouts), "lag_max": int(lag_max), "lags": lags,
        }
        return merged, record


# ----------------------------------------------------------- the launcher
def slice_forward_args(forward_args: list, j: int) -> list:
    """Slice j's argv: the literal ``{slice}`` becomes j, so one command
    line gives every slice its own shards and checkpoint dir."""
    return [a.replace("{slice}", str(j)) for a in forward_args]


def _spawn_slice(j: int, num_slices: int, forward_args: list, run_dir: str, sync_dir: str,
                 run_id: str, gen: int) -> subprocess.Popen:
    """Slice j: one `python -m xflow_tpu_torch train` process, a world of
    its own (no coordinator: `maybe_initialize` joins no world, so two
    slices never form one, even on one card). XFLOW_PROCESS_ID doubles
    as the rank stamp, so the watchdog sees slice j as rank j. The
    device is the forwarded `--device` (cuda by default): slices share
    the host's card."""
    from xflow_tpu_torch.launch.local import rank_metrics_args

    env = dict(os.environ)
    env.pop("XFLOW_COORDINATOR", None)
    env.pop("XFLOW_NUM_PROCESSES", None)
    env.update(XFLOW_SLICE=str(j), XFLOW_NUM_SLICES=str(num_slices), XFLOW_PROCESS_ID=str(j),
               XFLOW_RUN_ID=run_id, XFLOW_RESTART_GEN=str(gen))
    cmd = [sys.executable, "-m", "xflow_tpu_torch", "train",
           *slice_forward_args(forward_args, j), *rank_metrics_args(run_dir, j),
           "--set", f"sync.dir={sync_dir}"]
    return subprocess.Popen(cmd, env=env)


def launch_multislice(num_slices: int, forward_args: list, run_dir: str,
                      straggler_factor: float = 0.0, dead_after_s: float = 0.0,
                      watchdog_poll_s: float = 0.0, max_restarts: int = 0,
                      restart_backoff: float = 1.0, min_uptime_s: float = 0.0) -> int:
    """N slices, each under its own supervision loop. A dead slice does
    not tear the job down: its loop relaunches it alone with
    `train.resume=true` while the others train on. The launcher owns
    `membership.json`: a slice leaves the live set when it exits (or
    finishes) or on the watchdog's dead verdict (which kills a wedged
    slice so its loop acts), and rejoins when its relaunch spawns.
    Returns 0 when every slice's loop ended clean."""
    from xflow_tpu_torch.launch.local import resolve_launch_run_id
    from xflow_tpu_torch.launch.supervise import (
        DeadHostTracker,
        resume_forward_args,
        supervise,
        terminate_procs,
    )
    from xflow_tpu_torch.launch.watchdog import RunWatchdog

    if forward_args and forward_args[0] == "--":
        forward_args = forward_args[1:]
    if num_slices < 1:
        print("launch-multislice: --slices must be >= 1", file=sys.stderr)
        return 2
    if not run_dir:
        print("launch-multislice: --run-dir is required (the sync tier lives in "
              "<run-dir>/sync)", file=sys.stderr)
        return 2
    os.makedirs(run_dir, exist_ok=True)
    sync_dir = os.path.join(run_dir, "sync")
    os.makedirs(sync_dir, exist_ok=True)
    run_id = resolve_launch_run_id()
    live = set(range(num_slices))
    lock = threading.Lock()
    write_membership(sync_dir, live, run_id=run_id, note="launch")
    procs: dict = {}
    tracker = DeadHostTracker(allow_shrink=True)  # slices always shrink: no collectives

    def set_live(j: int, alive: bool, note: str) -> None:
        with lock:
            changed = (j in live) != alive
            if alive:
                live.add(j)
            else:
                live.discard(j)
            if changed:
                write_membership(sync_dir, live, run_id=run_id, note=note)
        if changed:
            print(f"launch-multislice: slice {j} {'rejoined' if alive else 'left'} the sync "
                  f"group ({note}); live = {sorted(live)}", file=sys.stderr)

    def on_dead(row: dict) -> None:
        j = row.get("rank")
        if not isinstance(j, int) or not 0 <= j < num_slices:
            return
        tracker.record(("slice", j))
        set_live(j, False, "watchdog-dead")
        p = procs.get(j)
        if p is not None and p.poll() is None:
            p.kill()

    watchdog = RunWatchdog(run_dir, num_ranks=num_slices, straggler_factor=straggler_factor,
                           dead_after_s=dead_after_s, poll_s=watchdog_poll_s, run_id=run_id,
                           on_dead=on_dead, gen=0)
    watchdog.start()
    results: dict = {}

    def slice_main(j: int) -> None:
        def attempt(gen: int) -> int:
            args = forward_args if gen == 0 else resume_forward_args(forward_args)
            if gen > 0:
                set_live(j, True, f"relaunch gen {gen}")
            p = _spawn_slice(j, num_slices, args, run_dir, sync_dir, run_id, gen)
            procs[j] = p
            rc = p.wait()
            if rc != 0:
                tracker.record(("slice", j))
                set_live(j, False, f"exit rc={rc}")
            else:
                # a finished slice publishes no more rounds: its peers stop waiting
                set_live(j, False, "finished")
            return rc

        results[j] = supervise(attempt, max_restarts=max_restarts,
                               restart_backoff=restart_backoff, min_uptime_s=min_uptime_s,
                               label=f"launch-multislice[slice{j}]")

    threads = [threading.Thread(target=slice_main, args=(j,), name=f"xflow-slice{j}")
               for j in range(num_slices)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    except BaseException:
        terminate_procs([p for p in procs.values() if p is not None])
        raise
    finally:
        watchdog.stop()
    if tracker.lost:
        print(f"launch-multislice: {len(tracker.lost)} slice-loss event(s) recorded this run "
              f"(see {os.path.join(run_dir, 'watchdog.jsonl')} and the kind=sync membership "
              "trail)", file=sys.stderr)
    return next((rc for rc in results.values() if rc), 0)
