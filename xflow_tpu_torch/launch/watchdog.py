"""The run directory's liveness watchdog, after
`xflow_tpu/launch/watchdog.py`: dead ranks and stragglers, read from the
heartbeat files the trainer writes.

Each rank appends {ts, rank, run_id, gen, kind: "heartbeat", step} every
`train.heartbeat_every` steps, with start, checkpoint, eval, sync,
interrupted and final events, to ``<run_dir>/heartbeat_rank<k>.jsonl``
(the launchers wire the path a rank, `launch/local.rank_metrics_args`).
One watchdog in the launcher polls the directory and flags, while the
job runs:

- dead ranks: no heartbeat for `dead_after_s`. Once one rank stops, its
  peers block in the next collective and go stale about two steps later,
  so on a world gone stale the lowest step is the culprit: `classify`
  orders by step;
- stragglers: a rank whose step trails the leader's by more than
  `straggler_factor` x (``max_step > factor * max(step, 1)``).

It needs no channel into the ranks, only the shared files.
"""

from __future__ import annotations

import glob
import os
import sys
import threading
import time
from typing import Optional

DEFAULT_STRAGGLER_FACTOR = 2.0
DEFAULT_DEAD_AFTER_S = 60.0
DEFAULT_POLL_S = 2.0


def fold_heartbeats(records, beats: Optional[dict] = None, run_id: Optional[str] = None,
                    gen: Optional[int] = None) -> dict:
    """Fold heartbeat records into {rank: {"step", "ts", "event", "gen"}},
    the newest record a rank winning (an event without a step keeps the
    rank's last step). `run_id` keeps one launch (a reused run dir holds
    an older run's beats) and `gen` one restart generation (a relaunch
    keeps the run id, and the previous attempt's stale beats would fire
    the new watchdog's dead policy before the relaunched ranks beat). A
    damaged `gen` skips its record (or folds as gen 0 unfiltered)."""
    beats = {} if beats is None else beats
    for rec in records:
        rank = rec.get("rank")
        ts = rec.get("ts")
        if run_id is not None and rec.get("run_id") != run_id:
            continue
        g = rec.get("gen", 0)
        try:
            g = int(g) if isinstance(g, (int, float)) else None
        except (ValueError, OverflowError):  # NaN or inf
            g = None
        if gen is not None and g != gen:
            continue
        if not isinstance(rank, int) or not isinstance(ts, (int, float)):
            continue
        cur = beats.get(rank)
        if cur is None or ts >= cur["ts"]:
            step = rec.get("step")
            beats[rank] = {
                "step": (int(step) if isinstance(step, (int, float))
                         else (cur["step"] if cur else 0)),
                "ts": float(ts),
                "event": rec.get("event"),
                "gen": g if g is not None else 0,
            }
    return beats


def read_heartbeats(run_dir: str, run_id: Optional[str] = None,
                    gen: Optional[int] = None) -> dict:
    """The newest heartbeat a rank across ``heartbeat_rank*.jsonl`` in
    `run_dir` (`fold_heartbeats`); a line cut by a killed rank is
    skipped without a warning."""
    from xflow_tpu_torch.jsonl import read_jsonl

    beats: dict = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "heartbeat_rank*.jsonl"))):
        fold_heartbeats(read_jsonl(path, warn=False), beats, run_id=run_id, gen=gen)
    return beats


def classify(beats: dict, now: float, straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
             dead_after_s: float = DEFAULT_DEAD_AFTER_S,
             expected_ranks: Optional[int] = None) -> list[dict]:
    """One status row a rank, lowest step first (the culprit ordering):
    ``finished`` (its last event is final or interrupted), ``starting``
    (its last event is start), ``dead`` (no beat for `dead_after_s`),
    ``straggler`` (the step lags past the factor), ``ok``; and
    ``missing`` for an expected rank that never beat. Dead wins over
    straggler."""
    finished = {r for r, b in beats.items() if b.get("event") in ("final", "interrupted")}
    starting = {r for r, b in beats.items() if b.get("event") == "start"}
    max_step = max((b["step"] for b in beats.values()), default=0)
    rows = []
    for rank in sorted(beats, key=lambda r: (beats[r]["step"], r)):
        b = beats[rank]
        age = max(0.0, now - b["ts"])
        lagging = max_step > straggler_factor * max(b["step"], 1)
        if rank in finished:
            status = "finished"
        elif rank in starting:
            status = "starting"
        elif age > dead_after_s:
            status = "dead"
        elif lagging:
            status = "straggler"
        else:
            status = "ok"
        rows.append({"rank": rank, "step": b["step"], "max_step": max_step,
                     "age_s": round(age, 3), "status": status})
    if expected_ranks is not None:
        for rank in range(expected_ranks):
            if rank not in beats:
                # None, not inf: the rows go into watchdog.jsonl as strict JSON
                rows.append({"rank": rank, "step": 0, "max_step": max_step,
                             "age_s": None, "status": "missing"})
    return rows


class RunWatchdog:
    """The launcher's poller: a warning on stderr and an event in
    ``<run_dir>/watchdog.jsonl`` whenever a rank turns straggler, dead or
    missing, and when it recovers. `on_dead(row)` is called once a
    transition into dead or missing, after the event is logged: the
    supervised launchers pass a policy that sets their teardown flag (a
    wedged rank never exits on its own). A failing policy does not stop
    the poller. The events carry the launcher's stamp: rank -1, the run
    id, `gen` and the attempt's world (`num_ranks`)."""

    def __init__(self, run_dir: str, num_ranks: int, straggler_factor: float = 0.0,
                 dead_after_s: float = 0.0, poll_s: float = 0.0, run_id: str = "", out=None,
                 on_dead=None, gen: int = 0):
        from xflow_tpu_torch.jsonl import JsonlAppender

        self._run_dir = run_dir
        self._on_dead = on_dead
        self._n = num_ranks
        # <= 0: the module default (the launchers pass their flags' 0 through)
        self._factor = (float(straggler_factor) if straggler_factor > 0
                        else DEFAULT_STRAGGLER_FACTOR)
        self._dead_after = float(dead_after_s) if dead_after_s > 0 else DEFAULT_DEAD_AFTER_S
        self._poll = max(float(poll_s), 0.05) if poll_s > 0 else DEFAULT_POLL_S
        self._out = out
        self._run_id = run_id
        self._gen = int(gen)
        self._events = JsonlAppender(
            os.path.join(run_dir, "watchdog.jsonl"),
            stamp={"rank": -1, "run_id": run_id or "?", "kind": "watchdog",
                   "gen": int(gen), "world": int(num_ranks)},
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = time.time()
        # the whole scan holds the lock: two polls applying their reads in
        # reverse order would report a stale backwards transition
        self._poll_lock = threading.Lock()
        self._reported: dict = {}  # rank -> last reported status
        self.flagged: dict = {}  # rank -> worst status reported

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="xflow-run-watchdog")
        self._thread.start()

    def poll_once(self, now: Optional[float] = None) -> list[dict]:
        """One scan: classify every rank of this generation and report
        the transitions."""
        with self._poll_lock:
            beats = read_heartbeats(self._run_dir, run_id=self._run_id or None, gen=self._gen)
            t = time.time() if now is None else now
            # "missing" only once the run has beats and has outlived the
            # dead threshold: ranks open their streams at different times
            expect = (self._n if beats and (t - self._started) > min(self._dead_after, 30.0)
                      else None)
            rows = classify(beats, t, straggler_factor=self._factor,
                            dead_after_s=self._dead_after, expected_ranks=expect)
            err = self._out or sys.stderr
            for row in rows:
                status = row["status"]
                prev = self._reported.get(row["rank"], "ok")
                # no "rank" / "step" keys: they would collide with the stamp
                payload = {"flagged_rank": row["rank"], "at_step": row["step"],
                           "max_step": row["max_step"], "age_s": row["age_s"]}
                if status in ("straggler", "dead", "missing") and status != prev:
                    self.flagged[row["rank"]] = status
                    self._events.append({"event": status, **payload})
                    beat = (f"last heartbeat {row['age_s']:.1f}s ago"
                            if isinstance(row["age_s"], float) else "no heartbeat ever")
                    print(f"launch watchdog: rank {row['rank']} is a {status.upper()} "
                          f"(step {row['step']} vs leader {row['max_step']}, {beat})", file=err)
                    if status in ("dead", "missing") and self._on_dead is not None:
                        try:
                            self._on_dead(dict(row))
                        except Exception as e:  # noqa: BLE001 — the flagging goes on
                            print(f"launch watchdog: on_dead policy failed: {e}", file=err)
                elif status in ("ok", "finished") and prev in ("straggler", "dead", "missing"):
                    self._events.append({"event": "recovered", **payload})
                    print(f"launch watchdog: rank {row['rank']} recovered (step {row['step']})",
                          file=err)
                self._reported[row["rank"]] = status
        return rows

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — a torn read must not stop the poller
                print(f"launch watchdog: scan failed: {e}", file=sys.stderr)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._events.close()
