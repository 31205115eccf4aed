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

    python -m xflow_tpu_torch.tools.serve_bench --url http://127.0.0.1:8000 --duration 10
    python -m xflow_tpu_torch.tools.serve_bench --unix /tmp/serve.sock --rate 500 \\
        --data test-00000 --rows-per-request 1-8

Prints one JSON line {"metric": "serve_qps", "value", "requests",
"errors", "rows", "rows_per_s", "p50_ms", "p90_ms", "p99_ms",
"duration_s", "generations", "gen_flips", "steps", ...}; exits 1 when a
request failed or lost its trace echo. The fleet's client knobs
(retries, deadline, hedging) come with the fleet.
"""

from __future__ import annotations

import argparse
import http.client
import json
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
        self.trace_echo_miss = 0
        self.generations: list = []  # (t, gen) at each change, in order
        self.steps: set = set()

    def ok(self, t: float, lat_s: float, n_rows: int, gen: int, step: int) -> None:
        with self.lock:
            self.requests += 1
            self.rows += n_rows
            self.latencies.append(lat_s)
            if not self.generations or self.generations[-1][1] != gen:
                self.generations.append((t, gen))
            self.steps.add(step)

    def err(self, what: str) -> None:
        with self.lock:
            self.requests += 1
            self.errors += 1
            self.first_error = self.first_error or what


def send(conn, rows: list, stats: Stats, trace: bool):
    """POST one request on `conn` and record it; returns the connection
    to use next (a new one after a transport failure)."""
    headers = {"Content-Type": "application/json"}
    tid = uuid.uuid4().hex[:16] if trace else ""
    if tid:
        headers["X-Trace-Id"] = tid
    # bytes: headers and body leave in one send
    body = json.dumps({"rows": rows}).encode("utf-8")
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/predict", body, headers)
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        status, echo = resp.status, resp.getheader("X-Trace-Id") or ""
    except (OSError, http.client.HTTPException, ValueError) as e:
        stats.err(f"{type(e).__name__}: {e}")
        conn.close()
        return None
    t1 = time.perf_counter()
    if status != 200 or len(payload.get("pctr", [])) != len(rows):
        stats.err(f"HTTP {status}: {payload.get('error', payload)}")
        return conn
    if tid and echo != tid:
        with stats.lock:
            stats.trace_echo_miss += 1
    stats.ok(t1, t1 - t0, len(rows), payload.get("generation", 0), payload.get("step", -1))
    return conn


def worker(args, rows: list, stats: Stats, deadline: float, interval_s: float, seed: int,
           stop: threading.Event) -> None:
    lo, hi = parse_row_range(args.rows_per_request)
    rng = random.Random(seed)
    conn = None
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
        batch = [rows[(i * 13 + j) % len(rows)] for j in range(n)]
        i += 1
        conn = send(conn or connect(args.url, args.unix, args.timeout), batch, stats,
                    args.trace)
    if conn is not None:
        conn.close()


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
