"""The fleet's failover router, after `xflow_tpu/serve/router.py`.

The router speaks the replicas' HTTP protocol (POST /predict, GET
/healthz, /stats), so a client cannot tell a fleet from one server, and
it owns four jobs:

- **Health-checked membership.** A poll loop GETs every replica's
  /healthz; requests round-robin over the healthy replicas only.
- **Circuit breaking.** `eject_failures` consecutive failures (failed
  forwards or health checks) open a replica's circuit: no traffic. After
  `circuit_open_s` the next health poll is the half-open probe, one at a
  time: success closes the circuit, failure opens it again.
- **Retries and a deadline.** A connect failure or a 503 (the replica's
  "retry later") is retried on another replica while the request's
  `route_deadline_ms` lasts; a spent budget is an honest 503.
- **Hedging** (`route_hedge_ms` > 0): a request outstanding that long is
  sent to one more healthy replica, and the first answer wins.

Standard library only (`http.client`, `ThreadingHTTPServer`); it imports
no torch, so the fleet process never touches the card. Clocks are
injectable: the tests drive the breaker and the routing against fake
replicas. Events (circuit_open, circuit_close, hedge, drain,
fleet_start, fleet_final) go to the router's own kind="serve" stream,
stamped rank -1.
"""

from __future__ import annotations

import http.client
import json
import queue
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from xflow_tpu_torch.jsonl import JsonlAppender
from xflow_tpu_torch.serve.lifecycle import QuietDisconnects
from xflow_tpu_torch.tracing import FORCE_HEADER, PARENT_HEADER, TRACE_HEADER, Tracer, clean_id, new_id

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """A replica's consecutive-failure breaker; thread-safe.

    CLOSED: traffic flows; `fail_threshold` consecutive failures open it.
    OPEN: `allow()` is False until `open_s` has passed, then the breaker
    is HALF_OPEN and hands out one probe permit (`allow_probe`). A probe
    success closes it (counters reset); a probe failure opens it again
    with a fresh timer. While the probe is out, every other `allow()` and
    `allow_probe()` is False. A success or failure that is not the probe
    cannot move an OPEN or HALF_OPEN breaker: it comes from a forward
    sent before the trip, evidence about the old process."""

    def __init__(self, fail_threshold: int = 3, open_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.fail_threshold = max(int(fail_threshold), 1)
        self.open_s = float(open_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opened_count = 0  # OPEN transitions over the breaker's life

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN and self._clock() - self._opened_at >= self.open_s:
            self._state = HALF_OPEN
            self._probe_inflight = False

    def allow(self) -> bool:
        """May a request go to this replica? Only when CLOSED: real
        traffic never rides the half-open probe."""
        with self._lock:
            self._maybe_half_open_locked()
            return self._state == CLOSED

    def allow_probe(self) -> bool:
        """Claim the half-open probe permit (a True return must be
        followed by `record_success(probe=True)` or
        `record_failure(probe=True)`); always True when CLOSED."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self, probe: bool = False) -> bool:
        """True when this success closed a circuit that was not CLOSED (the
        caller emits one circuit_close). A non-probe success while OPEN
        is stale and refused."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == OPEN and not probe:
                return False
            closed_now = self._state != CLOSED
            self._consecutive = 0
            self._probe_inflight = False
            self._state = CLOSED
            return closed_now

    def record_failure(self, probe: bool = False) -> bool:
        """True when this failure tripped the circuit open (the caller
        emits one circuit_open). A non-probe failure while OPEN or
        HALF_OPEN neither takes the probe permit nor restarts the timer."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == HALF_OPEN:
                if not probe:
                    return False
                self._probe_inflight = False  # a failed probe: OPEN, fresh timer
                self._state = OPEN
                self._opened_at = self._clock()
                return False
            if self._state == OPEN:
                return False
            self._consecutive += 1
            if self._consecutive >= self.fail_threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self.opened_count += 1
                return True
            return False


class ConnectError(Exception):
    """A forward that got no HTTP response (refused, reset, timed out):
    always retryable, the request may never have reached the replica."""


class Backend:
    """One replica as the router sees it: its address, its breaker, a
    keep-alive pool of up to 8 connections, and the step and freshness
    its last /healthz reported."""

    def __init__(self, idx: int, host: str, port: int,
                 breaker: Optional[CircuitBreaker] = None):
        self.idx = int(idx)
        self._lock = threading.Lock()
        self._addr = (host, int(port))
        self.breaker = breaker or CircuitBreaker()
        self._pool: deque = deque()
        self.requests = 0  # forwards sent, under _lock (handler threads race)
        self.failures = 0  # forwards that failed, under _lock
        self.freshness_s: Optional[float] = None  # None: unpublished checkpoint
        self.health_step: int = -1

    def note_health(self, body: bytes) -> None:
        """Keep the step and data_freshness_s of a 200 /healthz body; a
        malformed body is ignored (freshness never ejects)."""
        try:
            h = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return
        if not isinstance(h, dict):
            return
        step = h.get("step")
        if isinstance(step, int):
            self.health_step = step
        f = h.get("data_freshness_s")
        self.freshness_s = (float(f) if isinstance(f, (int, float)) and not isinstance(f, bool)
                            else None)

    def count(self, failed: bool = False) -> None:
        """Count one forward sent, or one that failed."""
        with self._lock:
            if failed:
                self.failures += 1
            else:
                self.requests += 1

    @property
    def addr(self) -> tuple:
        with self._lock:
            return self._addr

    def _get_conn(self, timeout: float) -> http.client.HTTPConnection:
        with self._lock:
            if self._pool:
                conn = self._pool.popleft()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn
            host, port = self._addr
        return http.client.HTTPConnection(host, port, timeout=timeout)

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        conn.close()

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None, timeout: float = 5.0) -> tuple[int, bytes]:
        """One HTTP round trip: (status, body). Raises ConnectError when no
        response came, and then closes every pooled connection: a killed
        replica leaves dead keep-alive sockets, and each would burn a
        half-open probe. The breaker is the caller's business (a 400 is
        the client's fault, not the replica's)."""
        conn = self._get_conn(timeout)
        try:
            conn.request(method, path, body, headers or {})
            resp = conn.getresponse()
            data = resp.read()
        except Exception as e:  # noqa: BLE001 — every transport failure is a connect failure
            conn.close()
            self.close()
            raise ConnectError(f"replica {self.idx}: {type(e).__name__}: {e}") from e
        self._put_conn(conn)
        return resp.status, data

    def close(self) -> None:
        with self._lock:
            while self._pool:
                self._pool.popleft().close()


class Router:
    """Health-checked round-robin failover over Backends. `handle_predict`
    is socket-free (the HTTP front end and the tests call it)."""

    def __init__(self, backends: list, deadline_ms: float = 2000.0, retries: int = 2,
                 hedge_ms: float = 0.0, health_poll_s: float = 0.5,
                 appender: Optional[JsonlAppender] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[Tracer] = None):
        self.backends = list(backends)
        self.deadline_s = max(float(deadline_ms), 1.0) / 1e3
        self.retries = max(int(retries), 0)
        self.hedge_s = max(float(hedge_ms), 0.0) / 1e3
        self.health_poll_s = max(float(health_poll_s), 0.05)
        self._app = appender or JsonlAppender("")
        self._clock = clock
        self.tracer = tracer  # None or rate 0: no tracing branch runs
        self._rr_lock = threading.Lock()
        self._rr = 0
        self._stop = threading.Event()
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True,
                                               name="xflow-router-health")
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "retries": 0, "hedges": 0, "hedge_wins": 0,
            "deadline_exceeded": 0, "retries_exhausted": 0, "no_backend": 0, "failovers": 0,
        }

    def event(self, name: str, **extra) -> None:
        """One kind="serve" event record on the router's stream."""
        self._app.append({"kind": "serve", "event": name, **extra})

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # ------------------------------------------------------------- health
    def start(self) -> None:
        self._health_thread.start()

    def _probe(self, b: Backend) -> None:
        """One health check, one breaker sample; in HALF_OPEN it is the
        recovery probe."""
        if not b.breaker.allow_probe():
            return
        try:
            status, body = b.request("GET", "/healthz", timeout=min(self.health_poll_s * 4, 5.0))
            ok = status == 200
            if ok:
                b.note_health(body)
        except ConnectError:
            ok = False
        if ok:
            if b.breaker.record_success(probe=True):
                self.event("circuit_close", backend=b.idx, port=b.addr[1])
        elif b.breaker.record_failure(probe=True):
            self.event("circuit_open", backend=b.idx, port=b.addr[1], reason="health_check")

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            for b in self.backends:
                if self._stop.is_set():
                    return
                self._probe(b)

    def healthy(self) -> list:
        return [b for b in self.backends if b.breaker.allow()]

    def pick(self, exclude: Optional[set] = None) -> Optional[Backend]:
        """Round-robin over the healthy backends not in `exclude` (those
        this request already failed on); when none is left, over every
        healthy one: one replica serving beats refusing."""
        healthy = self.healthy()
        if not healthy:
            return None
        pool = [b for b in healthy if not exclude or b.idx not in exclude] or healthy
        with self._rr_lock:
            self._rr += 1
            return pool[self._rr % len(pool)]

    # ------------------------------------------------------------ routing
    def _try_one(self, b: Backend, body: bytes, headers: dict,
                 timeout: float) -> tuple[bool, int, bytes]:
        """(retryable, status, data) of one forward. Retryable: a connect
        failure, a 503, any other 5xx (/predict is idempotent). The
        breaker sees connect failures and 5xx other than 503: a 503 is an
        answer from a live replica that sheds, and ejecting shedding
        replicas would turn a fleet-wide brownout into an outage."""
        b.count()
        try:
            status, data = b.request("POST", "/predict", body,
                                     {"Content-Type": "application/json", **headers},
                                     timeout=timeout)
        except ConnectError as e:
            b.count(failed=True)
            if b.breaker.record_failure():
                self.event("circuit_open", backend=b.idx, port=b.addr[1], reason=f"forward: {e}")
            return True, 503, json.dumps({"error": str(e)}).encode()
        if status == 503:
            b.count(failed=True)
            return True, status, data
        if status >= 500:
            # the replica fails the request (its /healthz may still say
            # 200): retry elsewhere and feed the breaker
            b.count(failed=True)
            if b.breaker.record_failure():
                self.event("circuit_open", backend=b.idx, port=b.addr[1],
                           reason=f"http_{status}")
            return True, status, data
        if b.breaker.record_success():
            self.event("circuit_close", backend=b.idx, port=b.addr[1])
        return False, status, data

    def handle_predict(self, body: bytes, headers: Optional[dict] = None) -> tuple[int, bytes]:
        """Route one /predict: pick, forward, retry elsewhere on a
        retryable failure, hedge when configured, 503 when the deadline
        runs out. Returns (status, response bytes)."""
        headers = headers or {}
        with self._inflight_cv:
            # admission and the in-flight count under one lock: drain()
            # never sees 0 in flight while an admitted request is uncounted
            if self._draining:
                return 503, json.dumps({"error": "router is draining"}).encode()
            self._inflight += 1
        try:
            return self._route(body, headers)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _traced_leg(self, ctx: Optional[dict], b: Backend, body: bytes, headers: dict,
                    timeout: float, leg: str) -> tuple[bool, int, bytes]:
        """One forward, in an `attempt` span when the request is traced:
        the replica gets X-Parent-Span, and X-Trace-Force on a retry or
        hedge leg (it cannot know the router's tail verdict)."""
        if ctx is None:
            return self._try_one(b, body, headers, timeout)
        tr = ctx["tr"]
        sp = tr.span(ctx["tid"], "attempt", parent=ctx["root"]["span"], backend=b.idx,
                     port=b.addr[1], leg=leg)
        hdrs = {**headers, TRACE_HEADER: ctx["tid"], PARENT_HEADER: sp["span"]}
        if leg != "primary":
            hdrs[FORCE_HEADER] = "1"
        retryable, status, data = self._try_one(b, body, hdrs, timeout)
        tr.end(sp, status=status, retryable=bool(retryable))
        return retryable, status, data

    def _route(self, body: bytes, headers: dict) -> tuple[int, bytes]:
        self._count("requests")
        tid = clean_id(headers.get(TRACE_HEADER))
        tr = self.tracer
        ctx = None
        if tr is not None and tr.enabled and tid:
            ctx = {"tr": tr, "tid": tid, "root": tr.span(tid, "request"), "forced": False}
        try:
            return self._route_attempts(body, headers, ctx)
        finally:
            if ctx is not None:
                rec = tr.end(ctx["root"], status=ctx.get("status", 0))
                # retries, hedges, errors, sheds and slow requests are kept
                tr.finish(tid, force=ctx["forced"] or ctx.get("status", 0) >= 500
                          or rec["dur_ms"] / 1e3 > tr.slow_s)

    def _route_attempts(self, body: bytes, headers: dict,
                        ctx: Optional[dict]) -> tuple[int, bytes]:
        def done(status: int, data: bytes) -> tuple[int, bytes]:
            if ctx is not None:
                ctx["status"] = status
            return status, data

        deadline = self._clock() + self.deadline_s
        tried: set = set()
        last = None
        prev_idx = None
        for attempt in range(self.retries + 1):
            left = deadline - self._clock()
            if left <= 0:
                break
            b = self.pick(exclude=tried)
            if b is None:
                self._count("no_backend")
                return done(503, json.dumps({"error": "no healthy replica"}).encode())
            tried.add(b.idx)
            leg = "retry" if attempt > 0 else "primary"
            if attempt > 0:
                self._count("retries")
                if ctx is not None:
                    ctx["forced"] = True
                if b.idx != prev_idx:  # a retry that switched replica
                    self._count("failovers")
            prev_idx = b.idx
            if self.hedge_s > 0 and left > self.hedge_s:
                retryable, status, data = self._try_hedged(b, body, headers, left, tried, ctx,
                                                           first_leg=leg)
            else:
                retryable, status, data = self._traced_leg(ctx, b, body, headers, left, leg)
            if not retryable:
                return done(status, data)
            last = (status, data)
        # two overload signals with opposite fixes: the budget ran out
        # (deadline too small, replicas too slow), or every retry failed
        # with budget to spare (fleet-wide shedding, dead replicas)
        if deadline - self._clock() <= 0:
            self._count("deadline_exceeded")
        else:
            self._count("retries_exhausted")
        if last is not None:
            return done(*last)
        return done(503, json.dumps(
            {"error": f"deadline exceeded ({self.deadline_s * 1e3:.0f}ms)"}).encode())

    def _try_hedged(self, primary: Backend, body: bytes, headers: dict, timeout: float,
                    tried: set, ctx: Optional[dict] = None,
                    first_leg: str = "primary") -> tuple[bool, int, bytes]:
        """Send to `primary`; after hedge_s with no answer, send the same
        request to one more healthy replica. The first answer that is not
        retryable wins; a retryable one waits for the other leg. Every
        wait ends at the request's remaining budget `timeout`."""
        results: queue.Queue = queue.Queue()
        t_end = self._clock() + timeout

        def leg(b: Backend, name: str) -> None:
            results.put((b, self._traced_leg(ctx, b, body, headers, timeout, name)))

        threading.Thread(target=leg, args=(primary, first_leg), daemon=True).start()
        legs, hedged = 1, False
        try:
            got = results.get(timeout=self.hedge_s)
        except queue.Empty:
            got = None
            hedge_b = self.pick(exclude=tried)
            if hedge_b is not None:
                hedged = True
                if ctx is not None:
                    ctx["forced"] = True
                tried.add(hedge_b.idx)
                self._count("hedges")
                self.event("hedge", backend=primary.idx, hedge_backend=hedge_b.idx)
                threading.Thread(target=leg, args=(hedge_b, "hedge"), daemon=True).start()
                legs += 1
        best = None
        for _ in range(legs):
            if got is None:
                left = t_end - self._clock()
                if left <= 0:
                    break
                try:
                    got = results.get(timeout=left)
                except queue.Empty:
                    break
            b, (retryable, status, data) = got
            got = None
            if not retryable:
                if hedged and b is not primary:
                    self._count("hedge_wins")
                return False, status, data
            best = (retryable, status, data)
        return best if best is not None else (
            True, 503, json.dumps({"error": "hedged request timed out"}).encode())

    # ----------------------------------------------------- health surface
    def health(self) -> dict:
        reps, fresh = [], []
        for b in self.backends:
            rep = {"replica": b.idx, "port": b.addr[1], "state": b.breaker.state,
                   "requests": b.requests, "failures": b.failures}
            if b.freshness_s is not None:
                rep["data_freshness_s"] = round(b.freshness_s, 3)
                rep["step"] = b.health_step
                fresh.append((b.freshness_s, b.idx))
            reps.append(rep)
        healthy = sum(1 for r in reps if r["state"] == CLOSED)
        out = {
            "ok": healthy > 0 and not self._draining,
            "router": True,
            "healthy": healthy,
            "replicas": reps,
            "draining": self._draining,
            "inflight": self._inflight,
        }
        if fresh:
            out["freshness_min_s"] = round(min(f for f, _ in fresh), 3)
            out["freshness_max_s"] = round(max(f for f, _ in fresh), 3)
            out["stalest_replica"] = max(fresh)[1]
        return out

    def stats_view(self) -> dict:
        with self._stats_lock:
            return {**self.health(), "routing": dict(self.stats)}

    # -------------------------------------------------------------- drain
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting (new predicts get a retryable 503), then wait
        for every request in flight. The fleet signals the replicas only
        after this returns, so an admitted request always finds its
        replica alive. False when requests remained at the timeout."""
        with self._inflight_cv:
            self._draining = True
        self.event("drain", inflight=self._inflight)
        deadline = time.monotonic() + timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._inflight_cv.wait(min(left, 0.5))
        return True

    def close(self) -> None:
        self._stop.set()
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=5.0)
        for b in self.backends:
            b.close()


class _RouterServer(QuietDisconnects, ThreadingHTTPServer):
    daemon_threads = True


def make_router_http_server(router: Router, host: str, port: int) -> ThreadingHTTPServer:
    """The router's client-facing HTTP server: the replicas' endpoints and
    wire shapes; /predict is proxied with failover, /healthz and /stats
    report the fleet."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # buffered, as the server's: headers and body leave in one segment
        # (unbuffered, Nagle holds the body for the client's delayed ACK)
        wbufsize = -1

        def setup(self):
            super().setup()
            self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def _reply(self, status: int, data: bytes, trace: str = "") -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if trace:
                self.send_header(TRACE_HEADER, trace)
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = 0
            # read the body first: left unread on a keep-alive connection
            # it would be parsed as the next request
            body = self.rfile.read(n) if n > 0 else b""
            if self.path != "/predict":
                self._reply(404, json.dumps({"error": f"no such endpoint {self.path!r}"}).encode())
                return
            fwd = {}
            pr = self.headers.get("X-Request-Priority")
            if pr is not None:
                fwd["X-Request-Priority"] = pr
            # a client's X-Trace-Id wins; with tracing on the router mints one
            tid = clean_id(self.headers.get(TRACE_HEADER))
            if not tid and router.tracer is not None and router.tracer.enabled:
                tid = new_id()
            if tid:
                fwd[TRACE_HEADER] = tid
            status, data = router.handle_predict(body, headers=fwd)
            self._reply(status, data, trace=tid)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                h = router.health()
                self._reply(200 if h["ok"] else 503, json.dumps(h).encode())
            elif self.path == "/stats":
                self._reply(200, json.dumps(router.stats_view()).encode())
            else:
                self._reply(404, json.dumps({"error": f"no such endpoint {self.path!r}"}).encode())

        def log_message(self, fmt, *args):
            pass  # the router's stream is the record

    return _RouterServer((host, port), Handler)
