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

Chaos drills (`testing/faults.serve_faults_from_env`, read once at
construction): a delay before every batch, and a SIGKILL after the Nth
answered batch, restricted by fleet replica and restart generation.

A serve world (`serve --coordinator H:P --num-processes N --process-id
K`, N above 1; `MeshLink`): rank 0 runs all of the above, and its device
worker drives the world; the other ranks bind nothing and run
`MeshLink.follow`. Collectives are issued by one thread a rank, in one
order: rank 0's worker and each follower's loop (HTTP handler threads
never touch one). Each round is one all_reduce(MAX) of a small header,
rank 0's fields against the others' -1: the op (idle tick / predict /
stop), a swap to step s, the step every rank should stage, and what each
rank reports back (its staged step, as -step so the MAX reads the
smallest, and a step it failed to stage). A predict round broadcasts the
[max_batch] batch as bytes. A reload: rank 0's watcher notices a newer
committed step; the header names it; every rank restores its own block
of it in a loader thread (`ServeRunner.stage`, on its loader stream);
once every rank reports it staged, the next header announces the swap,
which every rank applies before that round's batch, so no batch spans
two generations. A step some rank fails to stage is dropped and the
served one stays. SIGTERM on rank 0 drains, then broadcasts stop, and
the followers exit 0 (a follower ignores SIGTERM and waits for rank 0's
stop); a collective that fails (a rank died) ends rank 0 with rc 1.

In a serving fleet (`serve/fleet.py`) each replica is one such server;
`serve_main` reads its reload stagger from `XFLOW_RELOAD_STAGGER_S`.
The ready line stays the first JSON line on stdout (the fleet reads it);
warm-up notes go to stderr.

Not taken over: compile accounting (the torch forward has no compile
step; `warmup()` runs each rung before the ready line instead).
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import sys
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import signal
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.serve.autotune import AutotuneController, pick_rung
from xflow_tpu_torch.serve.coalescer import (
    BrownoutPolicy,
    MicroBatcher,
    RejectedRequest,
    assemble_batch,
)
from xflow_tpu_torch.serve.metrics import ServeMetrics
from xflow_tpu_torch.serve.lifecycle import QuietDisconnects, wait_for_signal
from xflow_tpu_torch.serve.runner import (
    BadRequest,
    CheckpointWatcher,
    Generation,
    ServeRunner,
    parse_rows,
)
from xflow_tpu_torch.telemetry import default_registry
from xflow_tpu_torch.testing.faults import hard_kill, serve_faults_from_env
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


OP_IDLE, OP_PREDICT, OP_STOP = 0, 1, 2
NO_STEP = -1


class MeshLink:
    """The control channel of a serve world, seen from one rank (the
    module docstring's protocol). Only the thread that drives this rank's
    collectives calls `round`, `predict`, `follow` and `stop`; `want` is
    rank 0's watcher's, and takes no collective."""

    def __init__(self, runner: ServeRunner, on_reload: Optional[Callable] = None,
                 on_failed: Optional[Callable] = None):
        self.runner = runner
        self.rank = dist.get_rank()
        self.device = runner.mesh.device
        tmpl, _ = assemble_batch([], runner.rungs[0], runner.cfg.data.max_nnz)
        self._spec = [(k, tmpl[k].dtype, tmpl[k].shape) for k in sorted(tmpl)]
        self._nbytes = sum(tmpl[k].nbytes for k in tmpl)
        self.on_reload, self.on_failed = on_reload, on_failed
        # rank 0's decisions
        self._want = NO_STEP  # the newest committed step its watcher saw
        self._target = NO_STEP  # the step the world stages
        self._swap_next = NO_STEP  # the swap the next header announces
        self._bad: set = set()  # steps some rank failed to stage
        # this rank's loader
        self._loader: Optional[threading.Thread] = None
        self._failed = NO_STEP  # the last step it failed to stage

    # ------------------------------------------------------------ start-up
    def load_agreed(self) -> Generation:
        """Every rank serves one step from the start: rank 0 loads the
        newest loadable one and broadcasts it, the others load it."""
        step = torch.tensor([NO_STEP], dtype=torch.int64, device=self.device)
        if self.rank == 0:
            try:
                gen = self.runner.load()
                step.fill_(gen.step)
            finally:  # a failed load still releases the followers
                dist.broadcast(step, src=0)
            return gen
        dist.broadcast(step, src=0)
        got = int(step.item())
        if got < 0:
            raise RuntimeError("rank 0 loaded no checkpoint")
        return self.runner.load(step=got)

    # -------------------------------------------------------------- rounds
    def want(self, step: int) -> None:
        """Rank 0's watcher: `step` is committed."""
        self._want = max(self._want, int(step))

    def round(self, op: int = OP_IDLE) -> int:
        """One header exchange; applies an announced swap and starts a
        staging the header asks for. Returns the op rank 0 sent."""
        runner, rank0 = self.runner, self.rank == 0
        ready = runner.staged_step
        vec = [op, self._swap_next, self._target] if rank0 else [NO_STEP] * 3
        h = torch.tensor(vec + [-ready, self._failed], dtype=torch.int64, device=self.device)
        dist.all_reduce(h, op=dist.ReduceOp.MAX)
        op, swap, target, neg_ready, failed = (int(v) for v in h.cpu().tolist())
        if swap != NO_STEP:
            gen = runner.swap(swap)
            if rank0 and self.on_reload is not None:
                self.on_reload(gen)
        if target != NO_STEP:
            self._start_stage(target)
        if rank0:
            self._decide(swap, target, -neg_ready, failed)
        return op

    def _start_stage(self, step: int) -> None:
        runner = self.runner
        if (step <= runner.step or step == self._failed or runner.staged_step == step
                or (self._loader is not None and self._loader.is_alive())):
            return

        def work():
            try:
                runner.stage(step)
            except Exception as e:  # noqa: BLE001 — reported in the header
                print(f"serve: rank {self.rank}: staging step {step} failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                self._failed = step

        self._loader = threading.Thread(target=work, daemon=True, name="xflow-serve-stage")
        self._loader.start()

    def _decide(self, swapped: int, target: int, min_ready: int, failed: int) -> None:
        """Rank 0, after a round: the next header's swap and target."""
        self._swap_next = NO_STEP
        if swapped != NO_STEP:
            self._target = NO_STEP
        elif target != NO_STEP and failed == target:
            print(f"serve: reload of step {target} failed on a rank; keeping step "
                  f"{self.runner.step}", file=sys.stderr)
            self._bad.add(target)
            self._target = NO_STEP
            if self.on_failed is not None:
                self.on_failed()
        elif target != NO_STEP and min_ready == target:
            self._swap_next = target
        if (self._target == NO_STEP and self._want > self.runner.step
                and self._want not in self._bad):
            self._target = self._want

    # ------------------------------------------------------------ batches
    def predict(self, arrays: dict) -> tuple:
        """Rank 0: one batch through the world -> (pctr [B], generation)."""
        self.round(OP_PREDICT)
        raw = np.concatenate([np.ascontiguousarray(arrays[k], dtype).reshape(-1).view(np.uint8)
                              for k, dtype, _ in self._spec])
        dist.broadcast(torch.from_numpy(raw).to(self.device), src=0)
        return self.runner.predict(arrays)

    def follow(self) -> int:
        """A follower's loop: rounds until rank 0's stop. Returns 0."""
        while True:
            op = self.round()
            if op == OP_STOP:
                return 0
            if op == OP_PREDICT:
                buf = torch.empty(self._nbytes, dtype=torch.uint8, device=self.device)
                dist.broadcast(buf, src=0)
                self.runner.predict(self._unpack(buf.cpu().numpy()))

    def _unpack(self, raw: np.ndarray) -> dict:
        out, off = {}, 0
        for k, dtype, shape in self._spec:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out[k] = raw[off:off + n].view(dtype).reshape(shape)
            off += n
        return out

    def stop(self) -> None:
        """Rank 0: release the followers."""
        self.round(OP_STOP)


class ServeApp:
    """Runner, batcher, metrics and the device worker thread. Socket-free
    (tests drive `handle_predict` directly); the HTTP servers call it.
    With `link` (rank 0 of a serve world) the worker drives the world."""

    def __init__(self, cfg: Config, runner: ServeRunner,
                 metrics: Optional[ServeMetrics] = None, link: Optional[MeshLink] = None):
        self.cfg = cfg
        self.runner = runner
        self.link = link
        self.fatal: Optional[BaseException] = None  # a serve world's failed collective
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
        # chaos injectors, read once: no cost a batch when unset
        self._fault_delay_s, self._fault_kill_batches = serve_faults_from_env()
        self._batches_served = 0
        # the newest generation a batch has answered with: the worker
        # emits one serve_first span when it advances
        self._first_served_gen = -1
        self.t_start = time.perf_counter()

    def start(self) -> None:
        self._worker.start()

    # ------------------------------------------------------- device worker
    def _worker_loop(self) -> None:
        try:
            self._serve_batches()
        except Exception as e:  # noqa: BLE001 — a serve world's collective failed
            if self.link is None:
                raise
            self.fatal = e
            print(f"serve: the serve world failed ({type(e).__name__}: {e})", file=sys.stderr)

    def _serve_batches(self) -> None:
        max_nnz = self.cfg.data.max_nnz
        link = self.link
        while True:
            group = self.batcher.take(timeout=0.1)
            if group is None:
                if self._stop.is_set():
                    if link is not None:
                        link.stop()
                    return
                if link is not None:
                    link.round()  # idle tick: reload readiness and swaps
                # idle tick: windows still flush on schedule
                gen = self.runner.generation
                if gen is not None:
                    self._autotune(self.metrics.maybe_flush(
                        gen.gen, gen.step, freshness_s=gen.freshness_s()))
                continue
            t_batch = time.perf_counter()
            if self._fault_delay_s > 0:
                time.sleep(self._fault_delay_s)  # a slow replica, for the router's drills
            rung = pick_rung(sum(r.num_rows for r in group), self._rungs)
            try:
                arrays, spans = assemble_batch(group, rung, max_nnz)
                p, gen = (self.runner.predict(arrays) if link is None
                          else link.predict(arrays))
            except Exception as e:  # noqa: BLE001 — fail this batch's futures,
                # keep the worker for the next window (in a serve world the
                # ranks may be out of step: the worker ends)
                for req in group:
                    if not req.future.done():
                        req.future.set_exception(e)
                if link is not None:
                    raise
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
            self._batches_served += 1
            if self._fault_kill_batches and self._batches_served >= self._fault_kill_batches:
                hard_kill()  # a replica dying under load, its answers already sent

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


class _TCPHTTPServer(QuietDisconnects, ThreadingHTTPServer):
    daemon_threads = True


def make_http_server(app: ServeApp, host: str, port: int) -> ThreadingHTTPServer:
    """The TCP server (port 0 = a free one; read `.server_address`)."""
    return _TCPHTTPServer((host, port), _make_handler(app))


class _UnixHTTPServer(QuietDisconnects, socketserver.ThreadingMixIn, socketserver.TCPServer):
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


def follow_main(cfg: Config, device, mesh) -> int:
    """A serve world's rank above 0: load the step rank 0 serves, then
    follow its headers until its stop (returns 0). SIGTERM and SIGINT are
    ignored: rank 0's stop ends the loop after its drain."""
    runner = ServeRunner(cfg, device=device, mesh=mesh)
    link = MeshLink(runner)
    gen = link.load_agreed()
    print(f"serve: rank {link.rank} follows rank 0 (step {gen.step}) on {runner.device}",
          file=sys.stderr)
    prev = {s: signal.signal(s, lambda signum, frame: None)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return link.follow()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def serve_main(cfg: Config, device="cuda", ready_out=None, mesh=None) -> int:
    """`python -m xflow_tpu_torch serve`: load -> warm up -> watch ->
    serve until SIGTERM/SIGINT, then drain and return 0. Once the
    sockets listen, one JSON line goes to `ready_out` (default stdout):
    {serving, step, generation, pid, host, port[, unix_socket], device[,
    world]}. Raises when no checkpoint loads. With `mesh` (a joined
    world) rank 0 serves through the world and the other ranks follow
    (`follow_main`); rank 0 returns 1 if the world fails."""
    if cfg.serve.port < 0 and not cfg.serve.unix_socket:
        # a world's ranks all see it, before any of them loads
        print("serve: nothing to listen on (serve.port=-1 and no serve.unix_socket)",
              file=sys.stderr)
        return 2
    if mesh is not None and dist.get_rank() != 0:
        return follow_main(cfg, device, mesh)
    runner = ServeRunner(cfg, device=device, mesh=mesh)
    link = None
    if mesh is None:
        gen = runner.load()
    else:
        link = MeshLink(runner)
        gen = link.load_agreed()
    app = ServeApp(cfg, runner, link=link)
    if app.tracer.enabled:
        runner.span_sink = app.metrics.appender
    n = runner.warmup(link.predict if link is not None else None)
    print(f"serve: warmed up {n} ladder rung(s) on {runner.device}", file=sys.stderr)
    app.metrics.event("start", generation=gen.gen, step=gen.step)
    try:
        # a fleet replica's share of the reload stagger (serve/fleet.py)
        stagger_s = float(os.environ.get("XFLOW_RELOAD_STAGGER_S", 0) or 0)
    except ValueError:
        stagger_s = 0.0
    on_reload = lambda g: app.metrics.event("reload", generation=g.gen, step=g.step)  # noqa: E731
    on_failed = lambda: app.metrics.event("reload_failed")  # noqa: E731
    if link is not None:
        link.on_reload, link.on_failed = on_reload, on_failed
    watcher = CheckpointWatcher(
        runner,
        poll_s=cfg.serve.reload_poll_s,
        on_reload=on_reload,
        on_failed=on_failed,
        stagger_s=stagger_s,
        notice=link.want if link is not None else None,
    )
    servers = []
    if cfg.serve.port >= 0:
        servers.append(make_http_server(app, cfg.serve.host, cfg.serve.port))
    if cfg.serve.unix_socket:
        servers.append(make_unix_server(app, cfg.serve.unix_socket))
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
    if mesh is not None:
        ready["world"] = dist.get_world_size()
    print(json.dumps(ready), file=ready_out or sys.stdout, flush=True)

    rc = 0
    try:
        rc = wait_for_signal(lambda: 1 if app.fatal is not None else None) or 0
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
    return rc
