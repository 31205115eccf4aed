"""PyTorch port, the server end to end on the CPU: served pCTRs of LR, FM,
MVM and FFM from checkpoints the port trained equal the JAX
`ServeRunner`'s and the port's `evaluate` within 1e-5, through
`ServeApp.handle_predict`, over HTTP on port 0 and over a unix socket;
and the reference's serving tests on the port: hot reload under
concurrent requests with no failure, a bad checkpoint mid-reload keeps
the old generation, the watcher does not retry a permanently bad step,
400s on malformed bodies with the server surviving, `/healthz` and
`/stats`, a predict that raises fails its batch with 500.

Every wait is bounded: `Future.result`, `http.client` and `join` carry
timeouts. Nothing gates on wall-clock coalescing.
"""

import http.client
import json
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.serve.runner import ServeRunner as JServeRunner
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.evaluate import predict_batches
from xflow_tpu_torch.serve.runner import CheckpointWatcher, ServeRunner
from xflow_tpu_torch.serve.server import ServeApp, make_http_server, make_unix_server
from xflow_tpu_torch.telemetry import default_registry
from xflow_tpu_torch.train.trainer import Trainer

LOG2_S, B, NF, V = 14, 64, 8, 4
ROWS = 200
MAX_BATCH = 32
PCTR_ATOL = 1e-5
MODELS = {
    "lr": {},
    "fm": {"model.v_dim": V},
    "mvm": {"model.v_dim": V, "model.mvm_plus_one": True},
    "ffm": {"model.v_dim": V},
}


def _pairs(model, ck):
    return {"model.name": model, "model.num_fields": NF, "data.log2_slots": LOG2_S,
            "data.batch_size": B, "data.max_nnz": NF, "train.checkpoint_dir": str(ck),
            **MODELS[model]}


def _serve_cfg(model, ck, **extra):
    return override(Config(), **_pairs(model, ck), **{
        "serve.max_batch": MAX_BATCH, "serve.ladder": "8,16", "serve.window_ms": 1.0,
        **extra})


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_data")
    (path,) = generate_shards(str(work / "train"), 1, ROWS, num_fields=NF,
                              ids_per_field=40, seed=5)
    rows = [line.split("\t", 1)[1].strip() for line in open(path).read().splitlines()]
    return {"work": work, "path": path, "rows": rows}


@pytest.fixture(scope="module")
def trained(shard):
    """Each model trained by the port for 2 epochs (8 steps, a checkpoint
    every 4 steps), with its evaluate pCTRs on the shard."""
    out = {}
    for model in MODELS:
        ck = shard["work"] / f"ck_{model}"
        cfg = override(Config(), **_pairs(model, ck), **{
            "data.train_path": shard["path"][: -len("-00000")], "train.epochs": 2,
            "train.checkpoint_every": 4, "train.log_every": 0})
        res = Trainer(cfg, device="cpu").fit()
        assert res.steps == 8 and res.bad_steps == 0
        gen = ServeRunner(_serve_cfg(model, ck), device="cpu").load()
        assert gen.step == 8
        preds = np.concatenate([
            p[b.row_mask > 0] for b, p in predict_batches(cfg, gen.tables, shard["path"], "cpu")
        ])
        out[model] = {"ck": ck, "preds": preds}
    return out


def _app(cfg):
    runner = ServeRunner(cfg, device="cpu")
    runner.load()
    assert runner.warmup() == 3  # rungs 8, 16, 32
    app = ServeApp(cfg, runner)
    app.start()
    return app


def _request(conn, method, path, body=None):
    conn.request(method, path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


class _UnixConn(http.client.HTTPConnection):
    def __init__(self, path):
        super().__init__("localhost", timeout=30)
        self._path = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self._path)


def _chunks(rows, sizes=(1, 5, 8, 16, 32, 2)):
    out, i = [], 0
    while i < len(rows):
        n = sizes[len(out) % len(sizes)]
        out.append(rows[i:i + n])
        i += n
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_handle_predict_matches_jax_and_evaluate(model, shard, trained):
    cfg = _serve_cfg(model, trained[model]["ck"])
    rows = shard["rows"][:96]
    jrunner = JServeRunner(joverride(JConfig(), **_pairs(model, trained[model]["ck"]),
                                     **{"serve.max_batch": MAX_BATCH}))
    assert jrunner.load().step == 8
    want, _ = jrunner.predict_rows(rows)
    runner = ServeRunner(cfg, device="cpu")
    assert runner.load().step == 8
    direct, gen = runner.predict_rows(rows)
    app = ServeApp(cfg, runner)
    app.start()
    try:
        got = []
        for chunk in _chunks(rows):
            status, payload = app.handle_predict(json.dumps({"rows": chunk}).encode())
            assert status == 200, payload
            assert (payload["generation"], payload["step"]) == (1, 8)
            got += payload["pctr"]
    finally:
        app.close()
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=PCTR_ATOL, rtol=0)
    np.testing.assert_allclose(got, trained[model]["preds"][:96], atol=PCTR_ATOL, rtol=0)
    np.testing.assert_array_equal(got, direct)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_http_and_unix_socket_match_evaluate(model, shard, trained, tmp_path):
    sock = str(tmp_path / "s" / "serve.sock")
    app = _app(_serve_cfg(model, trained[model]["ck"], **{"serve.unix_socket": sock}))
    servers = [make_http_server(app, "127.0.0.1", 0), make_unix_server(app, sock)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    conns = [http.client.HTTPConnection("127.0.0.1", servers[0].server_address[1], timeout=30),
             _UnixConn(sock)]
    try:
        rows = shard["rows"][:64]
        for conn in conns:
            got = []
            for chunk in _chunks(rows):  # one keep-alive connection
                status, payload = _request(conn, "POST", "/predict",
                                           json.dumps({"rows": chunk}))
                assert status == 200, payload
                got += payload["pctr"]
            np.testing.assert_allclose(got, trained[model]["preds"][:64], atol=PCTR_ATOL,
                                       rtol=0)
    finally:
        for c in conns:
            c.close()
        for s in servers:
            s.shutdown()
            s.server_close()
        app.close()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


# --------------------------------------------- the reference's serving tests
def _stage(src_ck, dst_ck, step):
    """Copy one committed step into the serving dir by one rename."""
    os.makedirs(dst_ck, exist_ok=True)
    tmp = os.path.join(dst_ck, f".staging_step_{step}")
    shutil.copytree(os.path.join(src_ck, f"step_{step}"), tmp)
    os.replace(tmp, os.path.join(dst_ck, f"step_{step}"))


def _poison(ck, step):
    bad = ck / f"step_{step}"
    bad.mkdir()
    (bad / "state.npz").write_bytes(b"this is not an npz file")
    (bad / "COMMITTED").write_text("ok\n")


def test_hot_reload_swaps_without_dropping_requests(shard, trained, tmp_path):
    """A reload under 8 concurrent clients fails no request; answers flip
    from generation 1 (step 4) to 2 (step 8), and no client sees the
    generation go back (each sends its next request after its answer)."""
    dst = tmp_path / "serving"
    _stage(trained["fm"]["ck"], dst, 4)
    cfg = _serve_cfg("fm", dst)
    app = _app(cfg)
    runner = app.runner
    results, errors = [], []
    stop = threading.Event()

    def client(i):
        body = json.dumps({"rows": shard["rows"][i * 3:i * 3 + 1 + i % 4]}).encode()
        while not stop.is_set():
            status, payload = app.handle_predict(body)
            if status != 200:
                errors.append((status, payload))
                return
            results.append((i, payload["generation"], payload["step"]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 20.0
        while len(results) < 50 and time.monotonic() < deadline:
            time.sleep(0.01)
        _stage(trained["fm"]["ck"], dst, 8)
        assert runner.maybe_reload().step == 8
        n = len(results)
        while len(results) < n + 50 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        app.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert {g for _, g, _ in results} == {1, 2}
    for i in range(8):
        gens = [g for c, g, _ in results if c == i]  # in the order client i got them
        assert gens == sorted(gens), (i, gens)
    assert {g: s for _, g, s in results} == {1: 4, 2: 8}


def test_bad_checkpoint_mid_reload_keeps_serving_old_generation(shard, trained, tmp_path):
    dst = tmp_path / "serving"
    _stage(trained["fm"]["ck"], dst, 8)
    runner = ServeRunner(_serve_cfg("fm", dst), device="cpu")
    assert runner.load().step == 8
    _poison(dst, 99)
    assert runner.maybe_reload() is None  # the walk-back lands on the served step
    assert runner.step == 8 and runner.generation.gen == 1
    p, gen = runner.predict_rows(shard["rows"][:4])
    assert gen.gen == 1 and p.shape == (4,)
    np.testing.assert_allclose(p, trained["fm"]["preds"][:4], atol=PCTR_ATOL, rtol=0)


def test_watcher_does_not_retry_a_permanently_bad_step(trained, tmp_path):
    dst = tmp_path / "serving"
    _stage(trained["fm"]["ck"], dst, 4)
    runner = ServeRunner(_serve_cfg("fm", dst), device="cpu")
    runner.load()
    _poison(dst, 99)
    failed = []
    w = CheckpointWatcher(runner, poll_s=0.02, on_failed=lambda: failed.append(1))
    w.start()
    try:
        deadline = time.monotonic() + 20
        while not failed and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.6)  # about 30 more polls: a retry would show
    finally:
        w.close()
    assert not w.is_alive()
    assert w.failures == 1 == len(failed) and w.reloads == 0
    assert runner.step == 4 and runner.generation.gen == 1


def test_watcher_reloads_on_newer_commit(trained, tmp_path):
    dst = tmp_path / "serving"
    _stage(trained["fm"]["ck"], dst, 4)
    runner = ServeRunner(_serve_cfg("fm", dst), device="cpu")
    runner.load()
    seen = []
    w = CheckpointWatcher(runner, poll_s=0.05, on_reload=lambda g: seen.append(g.step))
    w.start()
    try:
        _stage(trained["fm"]["ck"], dst, 8)
        deadline = time.monotonic() + 10
        while runner.step != 8 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        w.close()
    assert runner.step == 8 and seen == [8] and w.reloads == 1


@pytest.fixture()
def http_app(trained, tmp_path):
    app = _app(_serve_cfg("fm", trained["fm"]["ck"], **{
        "serve.metrics_path": str(tmp_path / "serve.jsonl")}))
    srv = make_http_server(app, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
    yield app, conn
    conn.close()
    srv.shutdown()
    srv.server_close()
    app.close()
    t.join(timeout=10)


def test_http_malformed_requests_400_server_survives(shard, trained, http_app):
    app, conn = http_app
    bad0 = default_registry().counter("serve.bad_requests").value
    for body in (b"not json", json.dumps({"rows": []}), json.dumps({"nope": 1}),
                 json.dumps({"rows": ["tokens without any colon"]}),
                 json.dumps({"rows": [123]}), json.dumps({"rows": ["0:a"] * (MAX_BATCH + 1)}),
                 b"\xff\xfe"):
        status, payload = _request(conn, "POST", "/predict", body)
        assert status == 400 and payload["error"], (body, payload)
    assert _request(conn, "POST", "/nope", b"{}")[0] == 404
    status, payload = _request(conn, "POST", "/predict", json.dumps({"rows": shard["rows"][:2]}))
    assert status == 200 and payload["generation"] == 1
    np.testing.assert_allclose(payload["pctr"], trained["fm"]["preds"][:2], atol=PCTR_ATOL,
                               rtol=0)
    assert default_registry().counter("serve.bad_requests").value - bad0 == 7


def test_http_healthz_stats_and_the_serve_stream(shard, http_app, tmp_path):
    app, conn = http_app
    status, h = _request(conn, "GET", "/healthz")
    assert status == 200 and h["ok"] and (h["step"], h["generation"]) == (8, 1)
    assert {"queued_rows", "brownout", "uptime_s"} <= h.keys()
    status, payload = _request(conn, "POST", "/predict", json.dumps({"rows": shard["rows"][:3]}))
    assert status == 200 and payload["queue_ms"] <= payload["total_ms"]
    status, s = _request(conn, "GET", "/stats")
    assert status == 200 and s["registry"]["serve.requests"] >= 1 and "autotune" not in s
    assert _request(conn, "GET", "/nope")[0] == 404
    app.close()  # flushes the last window, then "final"
    from xflow_tpu_torch.jsonl import read_jsonl
    from xflow_tpu_torch.serve.metrics import SERVE_WINDOW_KEYS

    recs = read_jsonl(str(tmp_path / "serve.jsonl"))
    windows = [r for r in recs if "requests" in r]
    assert windows and all(set(SERVE_WINDOW_KEYS) <= r.keys() for r in windows)
    assert windows[-1]["rows"] == 3 and recs[-1]["event"] == "final"


def test_predict_error_fails_only_its_batch_with_500(shard, trained):
    app = _app(_serve_cfg("fm", trained["fm"]["ck"]))
    real = app.runner.predict
    calls = []

    def flaky(arrays):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return real(arrays)

    app.runner.predict = flaky
    try:
        body = json.dumps({"rows": shard["rows"][:2]}).encode()
        status, payload = app.handle_predict(body)
        assert status == 500 and "device fault" in payload["error"]
        status, payload = app.handle_predict(body)  # the worker lives on
        assert status == 200 and len(payload["pctr"]) == 2
    finally:
        app.close()
    assert len(calls) == 2  # never retried


def test_autotune_and_brownout_reach_the_stream(shard, trained, tmp_path):
    """With autotune on, a window over the SLO moves a knob (recorded as a
    kind="autotune" record and span) and `/stats` carries the controller;
    a low-priority request in brownout gets 503 and counts as shed."""
    path = str(tmp_path / "serve.jsonl")
    app = _app(_serve_cfg("fm", trained["fm"]["ck"], **{
        "serve.metrics_path": path, "serve.autotune": True, "serve.slo_p99_ms": 1e-3,
        "serve.trace_sample_rate": 1.0}))
    try:
        body = json.dumps({"rows": shard["rows"][:4]}).encode()
        assert app.handle_predict(body, trace_id="t1")[0] == 200
        gen = app.runner.generation
        app._autotune(app.metrics.maybe_flush(gen.gen, gen.step, force=True))
        st = app.stats()["autotune"]
        assert st["decisions"] == 1 and st["windows_seen"] == 1
        app.batcher._brownout = True  # the mode itself is the batcher's, tested apart
        status, payload = app.handle_predict(body, priority=-1, trace_id="t2")
        assert status == 503 and "brownout" in payload["error"]
    finally:
        app.close()
    from xflow_tpu_torch.jsonl import read_jsonl

    recs = read_jsonl(path)
    tuned = [r for r in recs if r.get("kind") == "autotune"]
    assert len(tuned) == 1 and tuned[0]["reason"] in ("queue_dominated", "device_dominated")
    names = {r["name"] for r in recs if r.get("kind") == "span"}
    assert {"server", "parse", "queue", "device", "device_batch", "autotune"} <= names
    assert any(r.get("shed_requests") == 1 for r in recs)
