"""The HTTP / unix-socket front end and the device worker, after
`xflow_tpu/serve/server.py`.

Request path:

    HTTP handler thread: parse JSON -> parse rows (the training hash
      path) -> MicroBatcher.submit -> wait on the request's Future
    device worker thread: MicroBatcher.take (the coalescing window) ->
      assemble one batch padded to the smallest ladder rung that fits ->
      ServeRunner.predict on the serving device -> scatter the pCTR
      slices and the generation back to each request's Future

One device batch a window, whatever the concurrency. The single worker
thread owns the device: handler threads only parse and wait and never
touch a CUDA tensor, and the worker's readback (`.cpu()`) is the sync,
so `device_s` covers the host-to-device copy, the forward and the
readback.

Failures: a malformed body or row gets 400 with the reason; a full
backlog, a brownout shed or a shutdown 503; a predict that raises fails
that batch's futures only (500), is never retried on another device,
and the worker goes on. `GET /healthz` reports the generation and step;
`GET /stats` snapshots the telemetry registry.

Not taken over: the chaos injectors (they come with the fleet) and
compile accounting (the torch forward has no compile step; `warmup()`
runs each rung before the ready line instead).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import socketserver
import sys
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.serve.autotune import AutotuneController, pick_rung
from xflow_tpu_torch.serve.coalescer import (
    BrownoutPolicy,
    MicroBatcher,
    RejectedRequest,
    assemble_batch,
)
from xflow_tpu_torch.serve.metrics import ServeMetrics
from xflow_tpu_torch.serve.runner import BadRequest, CheckpointWatcher, ServeRunner, parse_rows
from xflow_tpu_torch.telemetry import default_registry
from xflow_tpu_torch.tracing import (
    FORCE_HEADER,
    PARENT_HEADER,
    TRACE_HEADER,
    Tracer,
    clean_id,
    emit_linked_span,
    emit_op_span,
    new_id,
)

# "low" marks a request sheddable under brownout; anything else, or no
# header, is normal priority
PRIORITY_HEADER = "X-Request-Priority"


def parse_priority(value: Optional[str]) -> int:
    """Header value -> priority: < 0 is shed under brownout."""
    return -1 if value is not None and value.strip().lower() == "low" else 0


class ServeApp:
    """Runner, batcher, metrics and the device worker thread. Socket-free
    (tests drive `handle_predict` directly); the HTTP servers call it."""

    def __init__(self, cfg: Config, runner: ServeRunner,
                 metrics: Optional[ServeMetrics] = None):
        self.cfg = cfg
        self.runner = runner
        scfg = cfg.serve
        self.metrics = metrics or ServeMetrics(
            scfg.metrics_path, every_s=scfg.metrics_every_s, batch_size=scfg.max_batch,
            max_bytes=scfg.metrics_max_bytes,
        )
        # spans ride the serve stream; rate 0 = off, and the request
        # paths skip every tracing branch
        self.tracer = Tracer(self.metrics.appender, sample_rate=scfg.trace_sample_rate,
                             slow_ms=scfg.trace_slow_ms)

        def on_brownout(active: bool, queued_rows: int) -> None:
            self.metrics.event("brownout_enter" if active else "brownout_exit",
                               queued_rows=queued_rows)

        self.batcher = MicroBatcher(
            max_rows=scfg.max_batch,
            window_s=scfg.window_ms / 1e3,
            max_queue_rows=scfg.max_queue_rows,
            brownout=BrownoutPolicy.from_config(scfg),
            on_brownout=on_brownout,
        )
        self._rungs = tuple(runner.rungs)
        self.autotuner = AutotuneController(scfg, rungs=self._rungs) if scfg.autotune else None
        self._timeout_s = scfg.request_timeout_s
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True,
                                        name="xflow-serve-device")
        # the newest generation a batch has answered with: the worker
        # emits one serve_first span when it advances
        self._first_served_gen = -1
        self.t_start = time.perf_counter()

    def start(self) -> None:
        self._worker.start()

    # ------------------------------------------------------- device worker
    def _worker_loop(self) -> None:
        max_nnz = self.cfg.data.max_nnz
        while True:
            group = self.batcher.take(timeout=0.1)
            if group is None:
                if self._stop.is_set():
                    return
                # idle tick: windows still flush on schedule
                gen = self.runner.generation
                if gen is not None:
                    self._autotune(self.metrics.maybe_flush(
                        gen.gen, gen.step, freshness_s=gen.freshness_s()))
                continue
            t_batch = time.perf_counter()
            rung = pick_rung(sum(r.num_rows for r in group), self._rungs)
            try:
                arrays, spans = assemble_batch(group, rung, max_nnz)
                p, gen = self.runner.predict(arrays)
            except Exception as e:  # noqa: BLE001 — fail this batch's futures,
                # keep the worker for the next window
                for req in group:
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            t_done = time.perf_counter()
            if gen.gen != self._first_served_gen:
                self._first_served_gen = gen.gen
                self._first_serve_span(gen)
            self._trace_batch(spans, t_batch, t_done, gen, rung)
            queue_waits, totals = [], []
            n_rows = 0
            for req, lo, hi in spans:
                queue_waits.append(t_batch - req.t_submit)
                totals.append(t_done - req.t_submit)
                n_rows += hi - lo
                req.future.set_result({
                    "pctr": [float(x) for x in p[lo:hi]],
                    "generation": gen.gen,
                    "step": gen.step,
                    "queue_ms": round((t_batch - req.t_submit) * 1e3, 3),
                    "total_ms": round((t_done - req.t_submit) * 1e3, 3),
                })
            self.metrics.observe_batch(len(group), n_rows, queue_waits, t_done - t_batch,
                                       totals, batch_size=rung)
            self._autotune(self.metrics.maybe_flush(gen.gen, gen.step,
                                                    freshness_s=gen.freshness_s()))

    # ----------------------------------------------------------- autotune
    def _autotune(self, window: Optional[dict]) -> None:
        """Feed a flushed window to the SLO controller, apply its
        decisions, and record each as a kind="autotune" record and an
        operational span."""
        if window is None or self.autotuner is None:
            return
        t0_wall, t0 = time.time(), time.perf_counter()
        for d in self.autotuner.observe(window):
            if d.knob == "window_ms" and d.new != d.old:
                self.batcher.set_window_s(d.new / 1e3)
            elif d.knob == "rung" and d.new != d.old:
                self.batcher.set_release_rows(int(d.new))
            self.metrics.appender.append({
                "kind": "autotune",
                "knob": d.knob,
                "old": round(d.old, 4),
                "new": round(d.new, 4),
                "reason": d.reason,
                "slo_p99_ms": self.autotuner.slo_ms,
                "total_p99_ms": window["total_p99_ms"],
                "queue_wait_p99_ms": window["queue_wait_p99_ms"],
                "device_p99_ms": window["device_p99_ms"],
                "batch_fill": window["batch_fill"],
            })
            emit_op_span(self.metrics.appender, "autotune", t0_wall,
                         time.perf_counter() - t0, knob=d.knob, old=round(d.old, 4),
                         new=round(d.new, 4), reason=d.reason)

    # ------------------------------------------------------------- tracing
    def _first_serve_span(self, gen) -> None:
        """One `serve_first` span a published generation, when its first
        batch answers, continuing the publication's ingest trace."""
        sink = self.runner.span_sink
        pub = gen.publication
        if sink is None or not isinstance(pub, dict):
            return
        trace = pub.get("trace")
        if not isinstance(trace, str) or not trace:
            return
        emit_linked_span(sink, "serve_first", time.time(), 0.0, trace=trace,
                         parent=gen.reload_span or pub.get("span") or None,
                         step=gen.step, generation=gen.gen)

    def _trace_batch(self, spans, t_batch, t_done, gen, rung) -> None:
        """The shared device_batch span and each traced member's queue and
        device spans; nothing when tracing is off or no member is traced."""
        tr = self.tracer
        if not tr.enabled:
            return
        traced = [(req, lo, hi) for req, lo, hi in spans if req.trace]
        if not traced:
            return
        n_rows = sum(hi - lo for _, lo, hi in spans)
        # a deadline flush when the oldest member aged past the window in
        # force, else the backlog filled the batch
        oldest_wait = t_batch - min(req.t_submit for req, _, _ in spans)
        flush = "window" if oldest_wait >= 0.95 * self.batcher.effective_window_s else "size"
        bid = new_id()
        batch_rec = {
            "kind": "span",
            "trace": traced[0][0].trace,
            "span": bid,
            "name": "device_batch",
            "t0": round(tr.wall(t_batch), 6),
            "dur_ms": round((t_done - t_batch) * 1e3, 3),
            "requests": len(spans),
            "rows": n_rows,
            "batch_fill": round(n_rows / max(rung, 1), 4),
            "flush": flush,
            "generation": gen.gen,
        }
        tr.add_shared(batch_rec, [req.trace for req, _, _ in traced])
        for req, lo, hi in traced:
            tr.add(req.trace, {
                "kind": "span", "trace": req.trace, "span": new_id(), "parent": req.span,
                "name": "queue", "t0": round(tr.wall(req.t_submit), 6),
                "dur_ms": round((t_batch - req.t_submit) * 1e3, 3), "rows": hi - lo,
            })
            tr.add(req.trace, {
                "kind": "span", "trace": req.trace, "span": new_id(), "parent": req.span,
                "name": "device", "t0": round(tr.wall(t_batch), 6),
                "dur_ms": round((t_done - t_batch) * 1e3, 3), "batch": bid,
            })

    # ----------------------------------------------------------- app logic
    def handle_predict(self, body: bytes, priority: int = 0, trace_id: str = "",
                       parent_span: str = "", force_trace: bool = False) -> tuple[int, dict]:
        """(http_status, response) for one POST /predict body
        {"rows": ["field:feat field:feat ...", ...]}. `priority` < 0 marks
        the request sheddable under brownout. With tracing on and a
        `trace_id`, the request's server/parse/queue/device spans buffer
        under it and flush on its verdict (head-sampled, forced, or
        captured here as an error, shed or slow request)."""
        tr = self.tracer if (self.tracer.enabled and trace_id) else None
        if tr is None:
            return self._predict_impl(body, priority)
        root = tr.span(trace_id, "server", parent=parent_span or None)
        status, payload = self._predict_impl(body, priority, tr=tr, trace_id=trace_id,
                                             root=root)
        rec = tr.end(root, status=status)
        tr.finish(trace_id, force=force_trace or status != 200
                  or rec["dur_ms"] / 1e3 > tr.slow_s)
        return status, payload

    def _predict_impl(self, body: bytes, priority: int = 0, tr=None, trace_id: str = "",
                      root=None) -> tuple[int, dict]:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self.metrics.observe_bad_request()
            return 400, {"error": f"body is not JSON: {e}"}
        rows = payload.get("rows") if isinstance(payload, dict) else None
        if not isinstance(rows, list) or not rows:
            self.metrics.observe_bad_request()
            return 400, {"error": 'expected {"rows": [<libffm feature row>, ...]}'}
        t_parse = time.perf_counter()
        try:
            fields_rows, slots_rows = parse_rows(rows, self.cfg.data)
        except BadRequest as e:
            self.metrics.observe_bad_request()
            return 400, {"error": str(e)}
        if tr is not None:
            tr.add(trace_id, {
                "kind": "span", "trace": trace_id, "span": new_id(), "parent": root["span"],
                "name": "parse", "t0": round(tr.wall(t_parse), 6),
                "dur_ms": round((time.perf_counter() - t_parse) * 1e3, 3), "rows": len(rows),
            })
        try:
            fut = self.batcher.submit(fields_rows, slots_rows, priority=priority,
                                      trace=trace_id if tr is not None else "",
                                      span=root["span"] if tr is not None else "")
        except RejectedRequest as e:
            if e.shed:
                self.metrics.observe_shed()
                return 503, {"error": str(e)}
            self.metrics.observe_bad_request()
            return (400 if e.client_error else 503), {"error": str(e)}
        try:
            return 200, fut.result(timeout=self._timeout_s)
        except FutureTimeout:
            return 503, {"error": f"timed out after {self._timeout_s}s"}
        except Exception as e:  # noqa: BLE001 — a failed batch reports its reason
            return 500, {"error": f"{type(e).__name__}: {e}"}

    def health(self) -> dict:
        gen = self.runner.generation
        out = {
            "ok": gen is not None,
            "generation": gen.gen if gen else 0,
            "step": gen.step if gen else -1,
            "queued_rows": self.batcher.queued_rows,
            "brownout": self.batcher.brownout,
            "uptime_s": round(time.perf_counter() - self.t_start, 3),
        }
        fresh = gen.freshness_s() if gen else None
        if fresh is not None:
            out["data_freshness_s"] = round(fresh, 3)
        return out

    def stats(self) -> dict:
        out = {**self.health(), "registry": default_registry().snapshot()}
        if self.autotuner is not None:
            out["autotune"] = self.autotuner.state()
        return out

    def close(self) -> None:
        """Stop intake, drain the backlog (every queued future resolves),
        stop the worker, flush the metrics."""
        self.batcher.close()
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=30.0)
        gen = self.runner.generation
        self.metrics.close(gen.gen if gen else -1, gen.step if gen else -1,
                           freshness_s=gen.freshness_s() if gen else None)


def _make_handler(app: ServeApp):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive: a closed-loop client reuses its connection
        protocol_version = "HTTP/1.1"
        # buffered: headers and body leave in one segment (unbuffered,
        # Nagle holds the body for the peer's delayed ACK, ~40 ms)
        wbufsize = -1

        def setup(self):
            super().setup()
            try:
                self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # AF_UNIX: no Nagle

        def _reply(self, status: int, payload: dict, trace: str = "") -> None:
            data = json.dumps(payload).encode("utf-8")
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
                self._reply(404, {"error": f"no such endpoint {self.path!r}"})
                return
            # a client's X-Trace-Id wins; with tracing on a request without
            # one gets one minted here; echoed either way
            tid = clean_id(self.headers.get(TRACE_HEADER))
            if not tid and app.tracer.enabled:
                tid = new_id()
            status, payload = app.handle_predict(
                body,
                priority=parse_priority(self.headers.get(PRIORITY_HEADER)),
                trace_id=tid,
                parent_span=clean_id(self.headers.get(PARENT_HEADER)),
                force_trace=self.headers.get(FORCE_HEADER) == "1",
            )
            self._reply(status, payload, trace=tid)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                h = app.health()
                self._reply(200 if h["ok"] else 503, h)
            elif self.path == "/stats":
                self._reply(200, app.stats())
            else:
                self._reply(404, {"error": f"no such endpoint {self.path!r}"})

        def log_message(self, fmt, *args):
            pass  # the serve stream is the record of traffic

        def address_string(self):
            try:
                return super().address_string()
            except (IndexError, TypeError):
                return "unix"  # AF_UNIX peers have no host

    return Handler


class _QuietDisconnects:
    """A client dropping its keep-alive connection is normal, not a
    server error: no traceback for exactly that."""

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], (ConnectionResetError, BrokenPipeError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class _TCPHTTPServer(_QuietDisconnects, ThreadingHTTPServer):
    daemon_threads = True


def make_http_server(app: ServeApp, host: str, port: int) -> ThreadingHTTPServer:
    """The TCP server (port 0 = a free one; read `.server_address`)."""
    return _TCPHTTPServer((host, port), _make_handler(app))


class _UnixHTTPServer(_QuietDisconnects, socketserver.ThreadingMixIn, socketserver.TCPServer):
    """HTTP over AF_UNIX: the same handler and protocol, for colocated
    clients."""

    address_family = socket.AF_UNIX
    allow_reuse_address = True
    daemon_threads = True

    def server_bind(self):
        if os.path.exists(self.server_address):
            os.unlink(self.server_address)  # a dead server's socket file
        super().server_bind()

    def get_request(self):
        request, _ = super().get_request()
        return request, ("unix", 0)


def make_unix_server(app: ServeApp, path: str) -> _UnixHTTPServer:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return _UnixHTTPServer(path, _make_handler(app))


def serve_main(cfg: Config, device="cuda", ready_out=None) -> int:
    """`python -m xflow_tpu_torch serve`: load -> warm up -> watch ->
    serve until SIGTERM/SIGINT, then drain and return 0. Once the
    sockets listen, one JSON line goes to `ready_out` (default stdout):
    {serving, step, generation, pid, host, port[, unix_socket], device}.
    Raises when no checkpoint loads."""
    runner = ServeRunner(cfg, device=device)
    gen = runner.load()
    app = ServeApp(cfg, runner)
    if app.tracer.enabled:
        runner.span_sink = app.metrics.appender
    n = runner.warmup()
    print(f"serve: warmed up {n} ladder rung(s) on {runner.device}", file=sys.stderr)
    app.metrics.event("start", generation=gen.gen, step=gen.step)
    watcher = CheckpointWatcher(
        runner,
        poll_s=cfg.serve.reload_poll_s,
        on_reload=lambda g: app.metrics.event("reload", generation=g.gen, step=g.step),
        on_failed=lambda: app.metrics.event("reload_failed"),
    )
    servers = []
    if cfg.serve.port >= 0:
        servers.append(make_http_server(app, cfg.serve.host, cfg.serve.port))
    if cfg.serve.unix_socket:
        servers.append(make_unix_server(app, cfg.serve.unix_socket))
    if not servers:
        print("serve: nothing to listen on (serve.port=-1 and no serve.unix_socket)",
              file=sys.stderr)
        return 2
    app.start()
    watcher.start()
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()

    ready = {"serving": True, "step": gen.step, "generation": gen.gen, "pid": os.getpid()}
    if cfg.serve.port >= 0:
        ready["host"], ready["port"] = servers[0].server_address[:2]
    if cfg.serve.unix_socket:
        ready["unix_socket"] = cfg.serve.unix_socket
    dev = runner.device
    ready["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(json.dumps(ready), file=ready_out or sys.stdout, flush=True)

    stop = threading.Event()
    prev = {}

    def on_signal(signum, frame):
        stop.set()
        for s, h in prev.items():
            signal.signal(s, h)  # a second signal acts as usual

    for s in (signal.SIGTERM, signal.SIGINT):
        prev[s] = signal.signal(s, on_signal)
    try:
        while not stop.wait(0.2):
            pass
    finally:
        print("serve: shutting down (draining queued requests)", file=sys.stderr)
        for srv in servers:
            srv.shutdown()
        watcher.close()
        app.close()
        for srv in servers:
            srv.server_close()
        if cfg.serve.unix_socket and os.path.exists(cfg.serve.unix_socket):
            try:
                os.unlink(cfg.serve.unix_socket)
            except OSError:
                pass
    return 0
