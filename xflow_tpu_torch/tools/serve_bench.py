#!/usr/bin/env python3
"""Load generator for `python -m xflow_tpu_torch serve`, after the JAX
package's `tools/serve_bench.py` (standard library only).

Closed loop (default): `--concurrency` workers each keep one request in
flight; the rate is what the server sustains. Open loop (`--rate R`):
the workers hold a fixed aggregate arrival rate whatever the answers
(a closed loop slows down with the server and hides queueing delay).

Rows come from a libffm file (`--data`; labels are stripped) or a
synthesized pool; `--rows-per-request` is a count or a range "LO-HI"
drawn uniformly per request (seeded per worker). Every answer's
`generation` is tracked, so a hot reload mid-run shows as a flip in the
report. `--trace` sends a fresh X-Trace-Id with every request and counts
answers that do not echo it.

The client's resilience knobs, for the fleet's drills: `--retries N`
resends after a transport failure or a 503 (the server's "retry later"),
`--retry-backoff-ms` apart; `--deadline-ms` bounds a request's whole
budget (a request past it is a `deadline_exceeded` error); `--hedge-ms`
sends a duplicate on a second connection when a request is outstanding
that long, and the first 200 wins. A failure a retry absorbed is not an
error: the report counts it under `retried` / `retry_attempts`, and the
hedges under `hedged` / `hedge_wins`.

    python -m xflow_tpu_torch.tools.serve_bench --url http://127.0.0.1:8000 --duration 10
    python -m xflow_tpu_torch.tools.serve_bench --unix /tmp/serve.sock --rate 500 \\
        --data test-00000 --rows-per-request 1-8

Prints one JSON line {"metric": "serve_qps", "value", "requests",
"errors", "rows", "rows_per_s", "p50_ms", "p90_ms", "p99_ms",
"duration_s", "retried", "retry_attempts", "hedged", "hedge_wins",
"deadline_exceeded", "generations", "gen_flips", "steps", ...}; exits 1
when a request failed or lost its trace echo.
"""

from __future__ import annotations

import argparse
import http.client
import json
import queue
import random
import socket
import sys
import threading
import time
import uuid


class UnixHTTPConnection(http.client.HTTPConnection):
    """http.client over an AF_UNIX path."""

    def __init__(self, path: str, timeout: float = 30.0):
        super().__init__("localhost", timeout=timeout)
        self._path = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self._path)


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    """TCP_NODELAY: a send split over two segments would otherwise wait
    for the server's delayed ACK (~40 ms on loopback), charged to the
    server's tail."""

    def connect(self):
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


def connect(url: str = "", unix: str = "", timeout: float = 30.0):
    """An HTTP connection to the server at `unix` (an AF_UNIX path) or
    `url` (http://host:port)."""
    if unix:
        return UnixHTTPConnection(unix, timeout=timeout)
    host, _, port = url.rpartition("//")[2].partition(":")
    return _NoDelayHTTPConnection(host or "127.0.0.1", int(port or 80), timeout=timeout)


def load_rows(path: str, limit: int = 100000) -> list:
    """Feature rows of a libffm file: the label stripped, the features
    verbatim (they hash to the same slots on the server)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t", 1)
            if len(parts) == 1:
                parts = line.split(" ", 1)
            rows.append(parts[1] if len(parts) > 1 else parts[0])
            if len(rows) >= limit:
                break
    if not rows:
        raise SystemExit(f"serve_bench: no rows in {path!r}")
    return rows


def synth_rows(n: int = 1024, num_fields: int = 18) -> list:
    """A deterministic pool of rows, for runs without a data file."""
    return [" ".join(f"{f}:synth{(i * 31 + f * 7) % 997}" for f in range(num_fields))
            for i in range(n)]


def parse_row_range(text: str) -> tuple[int, int]:
    """"N" -> (N, N); "LO-HI" -> (LO, HI). Raises ValueError unless
    1 <= LO <= HI."""
    lo, _, hi = str(text).partition("-")
    lo, hi = int(lo), int(hi or lo)
    if not 1 <= lo <= hi:
        raise ValueError(f"--rows-per-request {text!r}: need 1 <= LO <= HI")
    return lo, hi


class Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list = []
        self.requests = 0
        self.rows = 0
        self.errors = 0
        self.first_error = ""
        self.retried = 0  # requests that succeeded only after a retry
        self.retry_attempts = 0  # the extra sends the retries cost
        self.hedged = 0  # hedge legs sent
        self.hedge_wins = 0  # hedge legs that answered first
        self.deadline_exceeded = 0  # requests abandoned at --deadline-ms
        self.trace_echo_miss = 0
        self.generations: list = []  # (t, gen) at each change, in order
        self.steps: set = set()

    def ok(self, t: float, lat_s: float, n_rows: int, gen: int, step: int,
           retries: int = 0) -> None:
        with self.lock:
            self.requests += 1
            self.rows += n_rows
            self.latencies.append(lat_s)
            if retries:
                self.retried += 1
                self.retry_attempts += retries
            if not self.generations or self.generations[-1][1] != gen:
                self.generations.append((t, gen))
            self.steps.add(step)

    def err(self, what: str, retries: int = 0, deadline: bool = False) -> None:
        with self.lock:
            self.requests += 1
            self.errors += 1
            self.retry_attempts += retries
            self.deadline_exceeded += int(deadline)
            self.first_error = self.first_error or what

    def hedge(self, won: bool) -> None:
        with self.lock:
            self.hedged += 1
            self.hedge_wins += int(won)


class Client:
    """One worker's connection and the retries, deadline and hedging."""

    def __init__(self, args):
        self._args = args
        self._conn = self._connect()
        self._hedge_conn = None

    def _connect(self):
        return connect(self._args.url, self._args.unix, self._args.timeout)

    def close(self) -> None:
        for c in (self._conn, self._hedge_conn):
            if c is not None:
                c.close()

    def _send_once(self, conn, body: bytes, timeout_s: float, trace_id: str):
        """(status, payload, echoed trace id) over `conn`; raises on a
        transport failure. `timeout_s` bounds the socket wait, so a
        wedged server costs the request's budget, not --timeout."""
        conn.timeout = timeout_s
        if conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        headers = {"Content-Type": "application/json"}
        if trace_id:
            headers["X-Trace-Id"] = trace_id
        conn.request("POST", "/predict", body, headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), resp.getheader("X-Trace-Id") or ""

    def _send_hedged(self, body: bytes, stats: Stats, timeout_s: float, trace_id: str):
        """The request on the main connection; after --hedge-ms without an
        answer, a duplicate on the hedge connection (its own trace id,
        its echo checked and reported as the caller's). The first 200
        wins; a transport failure reads as status 599. Returns (answer,
        hedged)."""
        results: queue.Queue = queue.Queue()
        t_end = time.perf_counter() + timeout_s

        def leg(conn, tag):
            tid = uuid.uuid4().hex[:16] if (trace_id and tag == "hedge") else trace_id
            try:
                status, payload, echo = self._send_once(conn, body, timeout_s, tid)
                results.put((tag, (status, payload, trace_id if tid and echo == tid else echo)))
            except (OSError, http.client.HTTPException, ValueError) as e:
                conn.close()
                results.put((tag, (599, {"error": f"{type(e).__name__}: {e}"}, "")))

        threading.Thread(target=leg, args=(self._conn, "primary"), daemon=True).start()
        try:
            return results.get(timeout=min(self._args.hedge_ms / 1e3, timeout_s))[1], False
        except queue.Empty:
            pass
        if self._hedge_conn is None:
            self._hedge_conn = self._connect()
        threading.Thread(target=leg, args=(self._hedge_conn, "hedge"), daemon=True).start()
        first = None
        for _ in range(2):
            left = t_end - time.perf_counter()
            if left <= 0:
                break
            try:
                tag, got = results.get(timeout=left)
            except queue.Empty:
                break
            if got[0] == 200:
                stats.hedge(won=tag == "hedge")
                return got, True
            first = first or got
        stats.hedge(won=False)
        return first or (599, {"error": "hedged request timed out"}, ""), True

    def send(self, rows: list, stats: Stats) -> bool:
        """One request through the retries, deadline and hedging, recorded
        in `stats`; True when it finally succeeded. Every send carries a
        fresh trace id under --trace (a retry is a new request)."""
        a = self._args
        body = json.dumps({"rows": rows}).encode("utf-8")  # bytes: one send
        t0 = time.perf_counter()
        budget = a.deadline_ms / 1e3 if a.deadline_ms > 0 else float("inf")
        retries = 0
        while True:
            left = budget - (time.perf_counter() - t0)
            if left <= 0:
                stats.err(f"deadline of {a.deadline_ms} ms exceeded", retries, deadline=True)
                return False
            tid = uuid.uuid4().hex[:16] if a.trace else ""
            try:
                if a.hedge_ms > 0:
                    (status, payload, echo), hedged = self._send_hedged(
                        body, stats, min(left, a.timeout), tid)
                    if hedged:  # a losing leg may still own its connection
                        self.close()
                        self._conn, self._hedge_conn = self._connect(), None
                else:
                    status, payload, echo = self._send_once(self._conn, body,
                                                            min(left, a.timeout), tid)
            except (OSError, http.client.HTTPException, ValueError) as e:
                status, payload, echo = 599, {"error": f"{type(e).__name__}: {e}"}, ""
                self._conn.close()
                self._conn = self._connect()
            if status == 200 and len(payload.get("pctr", [])) == len(rows):
                if tid and echo != tid:
                    with stats.lock:
                        stats.trace_echo_miss += 1
                t1 = time.perf_counter()
                stats.ok(t1, t1 - t0, len(rows), payload.get("generation", 0),
                         payload.get("step", -1), retries=retries)
                return True
            if status in (503, 599) and retries < a.retries:
                # "retry later", honored after a pause: a zero-delay loop
                # would hammer a shedding server
                retries += 1
                time.sleep(min(a.retry_backoff_ms / 1e3,
                               max(budget - (time.perf_counter() - t0), 0)))
                continue
            stats.err(f"HTTP {status}: {payload.get('error', payload)}", retries)
            return False


def worker(args, rows: list, stats: Stats, deadline: float, interval_s: float, seed: int,
           stop: threading.Event) -> None:
    lo, hi = parse_row_range(args.rows_per_request)
    rng = random.Random(seed)
    client = Client(args)
    i = 0
    next_at = time.perf_counter()
    while not stop.is_set():
        now = time.perf_counter()
        if now >= deadline:
            break
        if interval_s > 0:  # open loop: hold the schedule
            if now < next_at:
                time.sleep(min(next_at - now, deadline - now))
                continue
            next_at += interval_s
        n = rng.randint(lo, hi)
        client.send([rows[(i * 13 + j) % len(rows)] for j in range(n)], stats)
        i += 1
    client.close()


def percentile(xs: list, q: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    return xs[min(int(len(xs) * q / 100.0), len(xs) - 1)]


def run(args, stop: threading.Event = None) -> dict:
    """Drive the server for `args.duration` seconds and return the
    report. `stop` (set by the caller) ends the run early."""
    rows = load_rows(args.data) if args.data else synth_rows(num_fields=args.num_fields)
    stats = Stats()
    stop = stop or threading.Event()
    interval = args.concurrency / args.rate if args.rate > 0 else 0.0
    t0 = time.perf_counter()
    deadline = t0 + args.duration
    threads = [threading.Thread(target=worker, daemon=True,
                                args=(args, rows, stats, deadline, interval, k, stop))
               for k in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=args.duration + args.timeout + 10)
    stop.set()
    elapsed = time.perf_counter() - t0
    lat = stats.latencies
    gens = [g for _, g in stats.generations]
    return {
        "metric": "serve_qps",
        "value": round((stats.requests - stats.errors) / max(elapsed, 1e-9), 2),
        "unit": "requests/sec",
        "mode": f"open@{args.rate}/s" if args.rate > 0 else f"closed@{args.concurrency}",
        "requests": stats.requests,
        "errors": stats.errors,
        "first_error": stats.first_error,
        "rows": stats.rows,
        "rows_per_s": round(stats.rows / max(elapsed, 1e-9), 1),
        "p50_ms": round(percentile(lat, 50) * 1e3, 3),
        "p90_ms": round(percentile(lat, 90) * 1e3, 3),
        "p99_ms": round(percentile(lat, 99) * 1e3, 3),
        "duration_s": round(elapsed, 3),
        "rows_per_request": args.rows_per_request,
        "retried": stats.retried,
        "retry_attempts": stats.retry_attempts,
        "hedged": stats.hedged,
        "hedge_wins": stats.hedge_wins,
        "deadline_exceeded": stats.deadline_exceeded,
        "traced": bool(args.trace),
        "trace_echo_miss": stats.trace_echo_miss,
        # the generations answered, in arrival order: > 1 = a reload flipped
        "generations": gens,
        "gen_flips": max(len(gens) - 1, 0),
        "gen_flip_t": [round(t - t0, 3) for t, _ in stats.generations[1:]],
        "steps": sorted(stats.steps),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="load generator for the port's server")
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--unix", default="", help="AF_UNIX socket path (overrides --url)")
    ap.add_argument("--data", default="", help="libffm file to draw rows from "
                                               "(default: a synthesized pool)")
    ap.add_argument("--duration", type=float, default=10.0, help="seconds")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop aggregate requests/s (0 = closed loop)")
    ap.add_argument("--rows-per-request", default="1",
                    help="rows a request: N, or LO-HI drawn uniformly per request")
    ap.add_argument("--num-fields", type=int, default=18,
                    help="fields of synthesized rows (ignored with --data)")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--retries", type=int, default=0,
                    help="resends after a transport failure or 503; an absorbed retry is "
                         "not an error")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="a request's budget, retries included (0 = none); past it the "
                         "request is a deadline_exceeded error")
    ap.add_argument("--retry-backoff-ms", type=float, default=50.0,
                    help="pause before each retry (default 50)")
    ap.add_argument("--hedge-ms", type=float, default=0.0,
                    help="duplicate a request outstanding this long on a second "
                         "connection; the first 200 wins (0 = off)")
    ap.add_argument("--trace", action="store_true",
                    help="send a fresh X-Trace-Id on every request and count missing echoes")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    parse_row_range(args.rows_per_request)
    rec = run(args)
    print(json.dumps(rec))
    return 1 if (rec["errors"] or rec["trace_echo_miss"]) else 0


if __name__ == "__main__":
    sys.exit(main())
