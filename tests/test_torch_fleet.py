"""PyTorch port, the serving fleet on the CPU, held to the JAX package.

Socket-free parts run in both packages on the same inputs: the circuit
breaker over the JAX test file's six scenarios under one fake clock,
`replica_env`, `backoff_delay` and `supervise` with a seeded rng and
scripted attempts, `serve_faults_from_env`, the JSONL stamps under the
same `XFLOW_*` environment, `drain_fleet`'s order, and the watcher's
stagger. Both routers then run against the same scriptable fake
replicas (tests/test_serve_fleet.py's `FakeReplica`) and must give the
same status codes, pick order, counters and events. The port's
`serve_bench` client knobs run against the fakes as the JAX tool's tests
run theirs. Last, one fleet end to end: `python -m xflow_tpu_torch
serve-fleet --device cpu` with two replicas on a checkpoint the port
trained, replica 1 killed by the injector under load and relaunched.

Every wait is bounded; nothing gates on wall-clock coalescing.
"""

import http.client
import io
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import xflow_tpu.jsonl as jjsonl
import xflow_tpu.launch.local as jlocal
import xflow_tpu.launch.supervise as jsupervise
import xflow_tpu.serve.fleet as jfleet
import xflow_tpu.serve.router as jrouter
import xflow_tpu.serve.runner as jrunner
import xflow_tpu.testing.faults as jfaults
import xflow_tpu_torch.jsonl as tjsonl
import xflow_tpu_torch.launch.local as tlocal
import xflow_tpu_torch.launch.supervise as tsupervise
import xflow_tpu_torch.serve.fleet as tfleet
import xflow_tpu_torch.serve.router as trouter
import xflow_tpu_torch.serve.runner as trunner
import xflow_tpu_torch.testing.faults as tfaults
from tests.test_serve_fleet import FakeClock, FakeReplica, _dead_port, _fake_on_port
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.serve.runner import ServeRunner
from xflow_tpu_torch.tools import serve_bench
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jrouter, jjsonl), "torch": (trouter, tjsonl)}
BODY = json.dumps({"rows": ["0:a 1:b"]}).encode()


# ------------------------------------------------------- circuit breaker
# The JAX test file's six breaker scenarios (tests/test_serve_fleet.py),
# each a script of clock moves and calls; every call's answer is kept.
def _opens_after_k(br, clock):
    return [br.state, br.allow(), br.record_failure(), br.record_failure(),
            br.record_failure(), br.state, br.allow(), br.opened_count]


def _success_resets(br, clock):
    return [br.record_failure(), br.record_success(), br.record_failure(), br.state]


def _half_open_probe(br, clock):
    out = [br.record_failure(), br.state, br.allow_probe()]
    clock.t = 5.1
    out += [br.state, br.allow(), br.allow_probe(), br.allow_probe(), br.record_success(),
            br.state, br.allow()]
    return out


def _stale_success(br, clock):
    out = [br.record_failure(), br.state, br.record_success(), br.state]
    clock.t = 5.1
    return out + [br.allow_probe(), br.record_success(probe=True), br.state]


def _stale_failure(br, clock):
    out = [br.record_failure()]
    clock.t = 5.1
    return out + [br.state, br.allow_probe(), br.record_failure(), br.state,
                  br.record_success(probe=True), br.state]


def _failed_probe(br, clock):
    out = [br.record_failure()]
    clock.t = 5.1
    out += [br.allow_probe(), br.record_failure(probe=True), br.state]
    clock.t = 10.0
    out.append(br.state)
    clock.t = 10.3
    return out + [br.state, br.allow_probe()]


BREAKER_SCENARIOS = {
    "opens_after_k_consecutive_failures": (3, 5.0, _opens_after_k, [
        "closed", True, False, False, True, "open", False, 1]),
    "success_resets_consecutive_count": (2, 2.0, _success_resets, [
        False, False, False, "closed"]),
    "half_open_probe_accounting": (1, 5.0, _half_open_probe, [
        True, "open", False, "half_open", False, True, False, True, "closed", True]),
    "stale_success_cannot_close_an_open_circuit": (1, 5.0, _stale_success, [
        True, "open", False, "open", True, True, "closed"]),
    "stale_failure_cannot_reopen_a_half_open_circuit": (1, 5.0, _stale_failure, [
        True, "half_open", True, False, "half_open", True, "closed"]),
    "failed_probe_reopens_with_fresh_timer": (1, 5.0, _failed_probe, [
        True, True, False, "open", "open", "half_open", True]),
}


@pytest.mark.parametrize("name", list(BREAKER_SCENARIOS))
def test_breaker_state_sequence_matches_jax(name):
    threshold, open_s, script, want = BREAKER_SCENARIOS[name]
    seqs = {}
    for pkg, (router, _) in PACKAGES.items():
        clock = FakeClock()
        br = router.CircuitBreaker(fail_threshold=threshold, open_s=open_s, clock=clock)
        seqs[pkg] = script(br, clock)
    assert seqs["torch"] == seqs["jax"] == want


# ------------------------------------------------------------ the fleet env
@pytest.mark.parametrize("idx,gen,stagger,world", [(0, 0, 1.0, 2), (2, 3, 0.5, 3),
                                                   (1, 1, 0.0, 1)])
def test_replica_env_matches_jax_apart_from_the_device(idx, gen, stagger, world):
    base = {"PATH": "/bin", "XFLOW_FAULT_SERVE_REPLICA": "1"}
    want = jfleet.replica_env(base, idx=idx, port=9003, run_id="r1", gen=gen,
                              stagger_s=stagger, world=world)
    got = tfleet.replica_env(base, idx=idx, port=9003, run_id="r1", gen=gen,
                             stagger_s=stagger, world=world)
    assert "JAX_PLATFORMS" in want and not any(k.startswith("JAX") for k in got)
    del want["JAX_PLATFORMS"]
    assert got == want
    assert got["XFLOW_RELOAD_STAGGER_S"] == str(idx * stagger)


def test_resolve_launch_run_id_matches_jax(monkeypatch):
    monkeypatch.setenv("XFLOW_RUN_ID", "fleet-7")
    assert tlocal.resolve_launch_run_id() == jlocal.resolve_launch_run_id() == "fleet-7"
    monkeypatch.delenv("XFLOW_RUN_ID")
    a, b = tlocal.resolve_launch_run_id(), tlocal.resolve_launch_run_id()
    assert a != b and len(a) == len(jlocal.resolve_launch_run_id()) == 12


# ---------------------------------------------------------- supervision
@pytest.mark.parametrize("attempt", [0, 1, 3, 7, 12])
@pytest.mark.parametrize("base", [0.2, 1.0])
def test_backoff_delay_matches_jax(attempt, base):
    want = jsupervise.backoff_delay(attempt, base, rng=random.Random(attempt))
    got = tsupervise.backoff_delay(attempt, base, rng=random.Random(attempt))
    assert got == want and 0.5 * min(base * 2 ** attempt, 60.0) <= got <= min(
        base * 2 ** attempt, 60.0)


SUPERVISE_SCRIPTS = {  # (attempt exit codes, uptimes, max_restarts, min_uptime_s)
    "first_attempt_succeeds": ([0], [1.0], 2, 0.0),
    "succeeds_after_two_restarts": ([137, 1, 0], [5.0, 5.0, 5.0], 3, 0.0),
    "budget_exhausted": ([1, 2, 3], [5.0, 5.0, 5.0], 2, 0.0),
    "crash_loop_stops_early": ([1, 1], [0.5, 0.5], 5, 2.0),
    "unsupervised": ([9], [1.0], 0, 0.0),
}


@pytest.mark.parametrize("name", list(SUPERVISE_SCRIPTS))
def test_supervise_matches_jax(name):
    rcs, uptimes, max_restarts, min_uptime = SUPERVISE_SCRIPTS[name]
    runs = {}
    for pkg, sup in (("jax", jsupervise), ("torch", tsupervise)):
        gens, sleeps, t = [], [], [0.0]

        def attempt(gen):
            gens.append(gen)
            t[0] += uptimes[gen]
            return rcs[gen]

        random.seed(11)  # both draw their jitter from the random module
        rc = sup.supervise(attempt, max_restarts=max_restarts, restart_backoff=0.5,
                           min_uptime_s=min_uptime, sleep=sleeps.append,
                           clock=lambda: t[0], out=io.StringIO())
        runs[pkg] = (rc, gens, sleeps)
    assert runs["torch"] == runs["jax"]


# ---------------------------------------------------------- serve faults
FAULT_ENVS = {
    "unset": {},
    "all_replicas": {"XFLOW_FAULT_SERVE_DELAY_S": "0.25", "XFLOW_FAULT_SERVE_KILL_BATCHES": "7"},
    "other_replica": {"XFLOW_FAULT_SERVE_DELAY_S": "0.25", "XFLOW_FAULT_SERVE_KILL_BATCHES": "7",
                      "XFLOW_FAULT_SERVE_REPLICA": "1"},
    "this_replica": {"XFLOW_FAULT_SERVE_DELAY_S": "0.25", "XFLOW_FAULT_SERVE_KILL_BATCHES": "7",
                     "XFLOW_FAULT_SERVE_REPLICA": "1", "XFLOW_REPLICA": "1"},
    "relaunched_generation": {"XFLOW_FAULT_SERVE_KILL_BATCHES": "25",
                              "XFLOW_FAULT_SERVE_REPLICA": "1", "XFLOW_REPLICA": "1",
                              "XFLOW_RESTART_GEN": "1"},
    "kill_in_gen_1": {"XFLOW_FAULT_SERVE_KILL_BATCHES": "25", "XFLOW_FAULT_SERVE_KILL_GEN": "1",
                      "XFLOW_RESTART_GEN": "1"},
    "garbage": {"XFLOW_FAULT_SERVE_DELAY_S": "x", "XFLOW_FAULT_SERVE_KILL_BATCHES": "-3",
                "XFLOW_FAULT_SERVE_REPLICA": "one"},
}


@pytest.mark.parametrize("name", list(FAULT_ENVS))
def test_serve_faults_from_env_matches_jax(monkeypatch, name):
    for k in [k for k in os.environ if k.startswith("XFLOW_")]:
        monkeypatch.delenv(k)
    for k, v in FAULT_ENVS[name].items():
        monkeypatch.setenv(k, v)
    assert tfaults.serve_faults_from_env() == jfaults.serve_faults_from_env()


# ------------------------------------------------------------ the stamps
STAMP_ENVS = {
    "solo": {},
    "launched": {"XFLOW_RUN_ID": "run-3", "XFLOW_PROCESS_ID": "2", "XFLOW_NUM_PROCESSES": "4",
                 "XFLOW_RESTART_GEN": "1"},
    "fleet_replica": {"XFLOW_RUN_ID": "run-3", "XFLOW_PROCESS_ID": "1",
                      "XFLOW_NUM_PROCESSES": "3", "XFLOW_RESTART_GEN": "1",
                      "XFLOW_REPLICA": "1", "XFLOW_REPLICA_PORT": "9001"},
    "replica_without_port": {"XFLOW_REPLICA": "0"},
    "unparseable": {"XFLOW_PROCESS_ID": "x", "XFLOW_NUM_PROCESSES": "0",
                    "XFLOW_RESTART_GEN": "y", "XFLOW_REPLICA": "z"},
}


@pytest.mark.parametrize("stamp", [None, {"rank": -1, "run_id": "fleet-1"}],
                         ids=["resolved", "router"])
@pytest.mark.parametrize("name", list(STAMP_ENVS))
def test_jsonl_stamps_match_jax(monkeypatch, tmp_path, name, stamp):
    for k in [k for k in os.environ if k.startswith("XFLOW_")]:
        monkeypatch.delenv(k)
    for k, v in STAMP_ENVS[name].items():
        monkeypatch.setenv(k, v)
    recs = {}
    for pkg, (_, jsonl) in PACKAGES.items():
        path = tmp_path / f"{pkg}.jsonl"
        app = jsonl.JsonlAppender(str(path), stamp=stamp)
        app.append({"kind": "serve", "event": "start"})
        app.append({"kind": "serve", "event": "final"})
        app.close()
        recs[pkg] = [[kv for kv in r.items() if kv[0] != "ts"]
                     for r in jsonl.read_jsonl(str(path))]
    if stamp is None and "XFLOW_RUN_ID" not in STAMP_ENVS[name]:
        # each process mints its own run id: one id within a package
        for pkg in recs:
            assert len({dict(r)["run_id"] for r in recs[pkg]}) == 1
            recs[pkg] = [[(k, "minted" if k == "run_id" else v) for k, v in r]
                         for r in recs[pkg]]
    assert recs["torch"] == recs["jax"]  # the same keys, values and order


def test_solo_server_stamp_is_unchanged(monkeypatch, tmp_path):
    """With no XFLOW_* variable a solo server's records carry the stamp
    of a one-process run, as before the fleet."""
    for k in [k for k in os.environ if k.startswith("XFLOW_")]:
        monkeypatch.delenv(k)
    path = tmp_path / "s.jsonl"
    app = tjsonl.JsonlAppender(str(path))
    app.append({"kind": "serve"})
    app.close()
    rec = tjsonl.read_jsonl(str(path))[0]
    assert set(rec) == {"ts", "rank", "run_id", "gen", "world", "kind"}
    assert (rec["rank"], rec["gen"], rec["world"]) == (0, 0, 1) and len(rec["run_id"]) == 12


# ----------------------------------------------------- routers vs fakes
def _router(pkg, replicas, tmp_path=None, fail_threshold=3, open_s=60.0, **kw):
    router, jsonl = PACKAGES[pkg]
    backends = [router.Backend(i, "127.0.0.1", r if isinstance(r, int) else r.port,
                               breaker=router.CircuitBreaker(fail_threshold=fail_threshold,
                                                             open_s=open_s))
                for i, r in enumerate(replicas)]
    app = jsonl.JsonlAppender(str(tmp_path / f"router_{pkg}.jsonl") if tmp_path else "",
                              stamp={"rank": -1, "run_id": "fleet-test"})
    kw.setdefault("health_poll_s", 30.0)  # the health loop stays idle unless started
    return router.Router(backends, appender=app, **kw)


def _events(pkg, tmp_path):
    path = tmp_path / f"router_{pkg}.jsonl"
    return [r for r in PACKAGES[pkg][1].read_jsonl(str(path))] if path.exists() else []


def _drive(pkg, tmp_path, modes, n, dead=(), **kw):
    """n predicts through pkg's router over fresh fakes (a mode a replica;
    `dead` indices are ports nobody listens on). Returns what both
    routers must agree on."""
    reps = [_dead_port() if i in dead else FakeReplica(mode=m) for i, m in enumerate(modes)]
    r = _router(pkg, reps, tmp_path, **kw)
    try:
        answers, picks = [], []
        for _ in range(n):
            status, data = r.handle_predict(BODY)
            answers.append((status, json.loads(data).get("replica_mode", "")))
            picks.append([b.requests for b in r.backends])  # the pick order
        return {
            "answers": answers,
            "picks": picks,
            "predicts": [0 if isinstance(x, int) else x.predicts for x in reps],
            "stats": dict(r.stats),
            "states": [b.breaker.state for b in r.backends],
            "healthy": [b.idx for b in r.healthy()],
            "requests": [b.requests for b in r.backends],
            "failures": [b.failures for b in r.backends],
            "events": [(e["event"], e.get("backend"), e.get("reason", "")[:8])
                       for e in _events(pkg, tmp_path)],
        }
    finally:
        r.close()
        for x in reps:
            if not isinstance(x, int):
                x.close()


ROUTE_CASES = {  # (modes, requests, dead, router kwargs)
    "round_robin": (["ok", "ok"], 6, (), {}),
    "503_retried_elsewhere": (["shed", "ok"], 4, (), {"retries": 2, "deadline_ms": 5000}),
    "shedding_replica_never_ejected": (["shed", "ok"], 8, (),
                                       {"retries": 2, "deadline_ms": 5000, "fail_threshold": 2}),
    "persistent_500_ejected": (["broken", "ok"], 6, (),
                               {"retries": 2, "deadline_ms": 5000, "fail_threshold": 2}),
    "dead_replica_failed_over": (["ok", "ok"], 7, (0,),
                                 {"retries": 2, "deadline_ms": 5000, "fail_threshold": 2}),
    "one_shedder_retries_without_failover": (["shed"], 1, (), {"retries": 2, "deadline_ms": 5000}),
    "retry_exhaustion_is_an_honest_503": (["shed", "shed"], 1, (),
                                          {"retries": 5, "deadline_ms": 5000,
                                           "fail_threshold": 100}),
    "no_healthy_backend": (["ok"], 2, (0,), {"retries": 0, "fail_threshold": 1}),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_router_matches_jax_on_fake_replicas(tmp_path, name):
    modes, n, dead, kw = ROUTE_CASES[name]
    got = {pkg: _drive(pkg, tmp_path, modes, n, dead, **kw) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    g = got["torch"]
    if name == "round_robin":
        assert g["predicts"] == [3, 3] and {s for s, _ in g["answers"]} == {200}
    elif name in ("503_retried_elsewhere", "shedding_replica_never_ejected"):
        assert all(a == (200, "ok") for a in g["answers"]) and g["stats"]["retries"] >= 1
        assert g["states"] == ["closed", "closed"]
    elif name == "persistent_500_ejected":
        assert all(a == (200, "ok") for a in g["answers"]) and g["healthy"] == [1]
        assert g["events"][0][:3] == ("circuit_open", 0, "http_500")
    elif name == "dead_replica_failed_over":
        assert all(a[0] == 200 for a in g["answers"]) and g["healthy"] == [1]
        assert g["events"][0][:2] == ("circuit_open", 0)
    elif name == "one_shedder_retries_without_failover":
        assert g["answers"][0][0] == 503
        assert (g["stats"]["retries"], g["stats"]["failovers"]) == (2, 0)
    elif name == "retry_exhaustion_is_an_honest_503":
        assert g["answers"][0][0] == 503 and g["stats"]["retries_exhausted"] == 1
        assert g["stats"]["deadline_exceeded"] == 0
    elif name == "no_healthy_backend":
        assert [s for s, _ in g["answers"]] == [503, 503] and g["stats"]["no_backend"] == 1


def test_router_counts_hold_under_concurrent_requests(tmp_path):
    """16 threads at a 0.1 ms switch interval through one router: every
    request is counted once, in the router and in its backend."""
    reps = [FakeReplica(), FakeReplica()]
    r = _router("torch", reps, tmp_path)
    switch = sys.getswitchinterval()
    statuses = []

    def client():
        for _ in range(25):
            statuses.append(r.handle_predict(BODY)[0])

    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        r.close()
        for x in reps:
            x.close()
    assert statuses == [200] * 400 and r.stats["requests"] == 400
    assert [b.requests for b in r.backends] == [200, 200]


def test_backend_flushes_its_pool_on_a_connect_failure():
    port = _dead_port()
    b = trouter.Backend(0, "127.0.0.1", port)
    try:
        for _ in range(3):  # the keep-alives a killed replica leaves behind
            b._put_conn(http.client.HTTPConnection("127.0.0.1", port))
        assert len(b._pool) == 3
        with pytest.raises(trouter.ConnectError):
            b.request("POST", "/predict", BODY, timeout=1.0)
        assert len(b._pool) == 0
    finally:
        b.close()


def _recover(pkg, tmp_path):
    rep, dead = FakeReplica(), _dead_port()
    r = _router(pkg, [dead, rep], tmp_path, retries=2, fail_threshold=1, open_s=0.2,
                health_poll_s=0.1)
    r.start()
    revived = None
    try:
        statuses = [r.handle_predict(BODY)[0] for _ in range(2)]
        tripped = r.backends[0].breaker.state
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if revived is None:
                try:
                    revived = _fake_on_port(dead)  # the relaunch on the same port
                except OSError:
                    time.sleep(0.05)
                    continue
            if r.backends[0].breaker.state == trouter.CLOSED:
                break
            time.sleep(0.05)
        names = [e["event"] for e in _events(pkg, tmp_path)]
        return statuses, tripped, r.backends[0].breaker.state, names
    finally:
        r.close()
        rep.close()
        if revived is not None:
            revived.close()


def test_router_half_open_recovery_matches_jax(tmp_path):
    got = {pkg: _recover(pkg, tmp_path) for pkg in PACKAGES}
    for statuses, tripped, state, names in got.values():
        assert statuses == [200, 200] and tripped in ("open", "half_open") and state == "closed"
        assert names[:1] == ["circuit_open"] and "circuit_close" in names
    assert got["torch"][0] == got["jax"][0]


def _hedge(pkg, tmp_path):
    slow, fast = FakeReplica(mode="slow", delay_s=1.5), FakeReplica()
    r = _router(pkg, [slow, fast], tmp_path, retries=1, deadline_ms=10000, hedge_ms=100)
    try:
        fast_answers = 0
        for _ in range(4):
            t0 = time.perf_counter()
            assert r.handle_predict(BODY)[0] == 200
            fast_answers += time.perf_counter() - t0 < 1.0
        events = [e["event"] for e in _events(pkg, tmp_path)]
        return r.stats, fast_answers, events
    finally:
        r.close()
        slow.close()
        fast.close()


def test_router_hedging_matches_jax(tmp_path):
    for pkg in PACKAGES:
        stats, fast_answers, events = _hedge(pkg, tmp_path)
        assert stats["hedges"] >= 1 and stats["hedge_wins"] >= 1 and fast_answers >= 1, pkg
        assert events.count("hedge") == stats["hedges"]


def _drain(pkg, tmp_path):
    slow = FakeReplica(mode="slow", delay_s=0.8)
    r = _router(pkg, [slow], tmp_path, deadline_ms=10000)
    results = []
    try:
        t = threading.Thread(target=lambda: results.append(r.handle_predict(BODY)))
        t.start()
        time.sleep(0.2)  # the request is at the replica
        drained = r.drain(timeout_s=10.0)
        t.join(timeout=10)
        after = r.handle_predict(BODY)
        return (drained, [s for s, _ in results], after[0], json.loads(after[1]),
                [e["event"] for e in _events(pkg, tmp_path)], r.health()["ok"])
    finally:
        r.close()
        slow.close()


def test_router_drain_matches_jax(tmp_path):
    got = {pkg: _drain(pkg, tmp_path) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (True, [200], 503) and got["torch"][4] == ["drain"]


def _traced(pkg, tmp_path, modes):
    import xflow_tpu.tracing as jtracing
    import xflow_tpu_torch.tracing as ttracing

    tracing = {"jax": jtracing, "torch": ttracing}[pkg]
    reps = [FakeReplica(mode=m) for m in modes]
    r = _router(pkg, reps, tmp_path, retries=2, deadline_ms=5000)
    r.tracer = tracing.Tracer(r._app, sample_rate=1.0)
    try:
        status, _ = r.handle_predict(BODY, headers={tracing.TRACE_HEADER: "trace-1"})
    finally:
        r.close()
        for x in reps:
            x.close()
    spans = [e for e in _events(pkg, tmp_path) if e.get("kind") == "span"]
    by_id = {sp["span"]: sp for sp in spans}
    return status, sorted(
        (sp["name"], sp["trace"], by_id[sp["parent"]]["name"] if "parent" in sp else "",
         sp.get("leg", ""), sp.get("backend", -1), sp.get("status", 0)) for sp in spans)


@pytest.mark.parametrize("modes", [["ok", "ok"], ["shed", "ok"]], ids=["one_leg", "retried"])
def test_router_trace_spans_match_jax(tmp_path, modes):
    """With tracing on, a request's `request` span and one `attempt` span
    a leg (its backend, leg name and status), parented the same way."""
    got = {pkg: _traced(pkg, tmp_path, modes) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    status, spans = got["torch"]
    assert status == 200 and [sp[0] for sp in spans].count("request") == 1
    assert {sp[2] for sp in spans if sp[0] == "attempt"} == {"request"}


def test_router_http_front_end(tmp_path):
    """The router's HTTP server: /predict proxied, the trace id echoed,
    /healthz and /stats report the fleet, 404 elsewhere."""
    reps = [FakeReplica(), FakeReplica()]
    r = _router("torch", reps, tmp_path)
    srv = trouter.make_router_http_server(r, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=10)
        conn.request("POST", "/predict", BODY, {"X-Trace-Id": "abc-1"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-Trace-Id") == "abc-1"
        assert json.loads(resp.read())["pctr"] == [0.5]
        conn.request("GET", "/healthz")
        h = json.loads(conn.getresponse().read())
        assert h["router"] and h["healthy"] == 2 and [x["replica"] for x in h["replicas"]] == [0, 1]
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read())["routing"]["requests"] == 1
        conn.request("POST", "/nope", b"{}")
        resp = conn.getresponse()
        assert resp.status == 404 and b"no such endpoint" in resp.read()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        r.close()
        for x in reps:
            x.close()


# ------------------------------------------------------- the signal wait
def test_wait_for_signal_returns_on_sigint_and_restores_the_handler():
    from xflow_tpu_torch.serve.lifecycle import wait_for_signal

    before = signal.getsignal(signal.SIGINT)
    timer = threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGINT))
    timer.start()
    t0 = time.monotonic()
    try:
        assert wait_for_signal(poll_s=0.05) is None
    finally:
        timer.cancel()
    assert time.monotonic() - t0 < 10
    assert signal.getsignal(signal.SIGINT) is before


def test_wait_for_signal_returns_what_done_returns():
    from xflow_tpu_torch.serve.lifecycle import wait_for_signal

    calls = []

    def done():
        calls.append(1)
        return 7 if len(calls) == 3 else None

    before = signal.getsignal(signal.SIGTERM)
    assert wait_for_signal(done, poll_s=0.01) == 7 and len(calls) == 3
    assert signal.getsignal(signal.SIGTERM) is before


# ------------------------------------------------------ drain order, stagger
@pytest.mark.parametrize("drained", [True, False])
def test_drain_fleet_orders_router_before_replicas_as_jax(drained):
    got = {}
    for pkg, fleet in (("jax", jfleet), ("torch", tfleet)):
        calls = []

        class FakeRouter:
            def drain(self, timeout_s=30.0):
                calls.append("router_drain")
                return drained

        class FakeSup:
            def __init__(self, i):
                self.i = i

            def terminate(self, sig=None):
                calls.append(f"terminate_{self.i}")

        out = fleet.drain_fleet(FakeRouter(), [FakeSup(0), FakeSup(1)], out=io.StringIO())
        got[pkg] = (out, calls)
    assert got["torch"] == got["jax"] == (drained, ["router_drain", "terminate_0", "terminate_1"])


class _FakeRunner:
    def __init__(self):
        self.step = 4
        self.reloaded_at = None

    def latest_committed_step(self):
        return 8

    def maybe_reload(self):
        self.reloaded_at = time.monotonic()
        self.step = 8

        class G:
            step, gen = 8, 2

        return G()


@pytest.mark.parametrize("runner_mod", [jrunner, trunner], ids=["jax", "torch"])
def test_checkpoint_watcher_staggers_the_reload(runner_mod):
    fast, slow = _FakeRunner(), _FakeRunner()
    t0 = time.monotonic()
    w0 = runner_mod.CheckpointWatcher(fast, poll_s=0.05, stagger_s=0.0)
    w2 = runner_mod.CheckpointWatcher(slow, poll_s=0.05, stagger_s=0.6)
    w0.start()
    w2.start()
    try:
        deadline = time.monotonic() + 10
        while (fast.reloaded_at is None or slow.reloaded_at is None) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        w0.close()
        w2.close()
    assert fast.reloaded_at is not None and slow.reloaded_at is not None
    assert slow.reloaded_at - t0 >= 0.6
    assert slow.reloaded_at - fast.reloaded_at >= 0.3


def test_watcher_closed_during_its_stagger_does_not_reload():
    r = _FakeRunner()
    w = trunner.CheckpointWatcher(r, poll_s=0.05, stagger_s=30.0)
    w.start()
    time.sleep(0.3)  # the step is noticed; the stagger is running
    t0 = time.monotonic()
    w.close()
    assert time.monotonic() - t0 < 5 and not w.is_alive() and r.reloaded_at is None


# ---------------------------------------------------- serve_bench knobs
def _bench(capsys, *argv):
    rc = serve_bench.main(list(argv))
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_bench_retries_absorb_503(capsys):
    rep = FakeReplica(mode="shed")

    def heal():  # the 503s before the flip are absorbed by --retries
        time.sleep(0.3)
        rep.mode = "ok"

    threading.Thread(target=heal, daemon=True).start()
    try:
        rc, rec = _bench(capsys, "--url", f"http://127.0.0.1:{rep.port}", "--duration", "1.5",
                         "--concurrency", "2", "--retries", "40", "--retry-backoff-ms", "50",
                         "--deadline-ms", "10000")
    finally:
        rep.close()
    assert rc == 0, rec
    assert rec["errors"] == 0 and rec["deadline_exceeded"] == 0
    assert rec["retried"] >= 1 and rec["retry_attempts"] >= rec["retried"]


def test_serve_bench_unabsorbed_errors_still_fail(capsys):
    rep = FakeReplica(mode="shed")  # 503 for ever: retries cannot absorb it
    try:
        rc, rec = _bench(capsys, "--url", f"http://127.0.0.1:{rep.port}", "--duration", "0.8",
                         "--concurrency", "1", "--retries", "1")
    finally:
        rep.close()
    assert rc == 1 and rec["errors"] >= 1 and "HTTP 503" in rec["first_error"]


def test_serve_bench_deadline_exceeded_counts_as_error(capsys):
    rep = FakeReplica(mode="slow", delay_s=1.0)
    try:
        rc, rec = _bench(capsys, "--url", f"http://127.0.0.1:{rep.port}", "--duration", "0.9",
                         "--concurrency", "1", "--deadline-ms", "200", "--retries", "3")
    finally:
        rep.close()
    assert rc == 1 and rec["deadline_exceeded"] >= 1


def test_serve_bench_hedge_wins_on_slow_server(capsys):
    rep = FakeReplica(mode="slow", delay_s=0.6)

    def heal():  # early requests hedge; later ones answer directly
        time.sleep(0.5)
        rep.mode = "ok"

    threading.Thread(target=heal, daemon=True).start()
    try:
        rc, rec = _bench(capsys, "--url", f"http://127.0.0.1:{rep.port}", "--duration", "1.2",
                         "--concurrency", "1", "--hedge-ms", "120")
    finally:
        rep.close()
    assert rc == 0, rec
    assert rec["hedged"] >= 1 and rec["errors"] == 0


# --------------------------------------------------------- end to end
LOG2_S, NF, V, ROWS = 12, 8, 4, 200
KILL_BATCHES = 25


@pytest.fixture(scope="module")
def fm_ck(tmp_path_factory):
    work = tmp_path_factory.mktemp("fleet_ck")
    (path,) = generate_shards(str(work / "train"), 1, ROWS, num_fields=NF, ids_per_field=40,
                              seed=5)
    cfg = override(Config(), **{
        "model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": 64, "data.max_nnz": NF,
        "train.checkpoint_dir": str(work / "ck"), "data.train_path": str(work / "train"),
        "train.epochs": 1, "serve.max_batch": 32})
    Trainer(cfg, device="cpu").fit()
    return {"cfg": cfg, "path": path, "ck": str(work / "ck")}


def fleet_argv(ck: str, *extra: str) -> list:
    """A CPU fleet over the FM checkpoint `ck` of `fm_ck`."""
    return [sys.executable, "-m", "xflow_tpu_torch", "serve-fleet", "--checkpoint-dir", ck,
            "--model", "fm", "--log2-slots", str(LOG2_S), "--port", "0", "--device", "cpu",
            "--window-ms", "1", "--max-batch", "32", "--set", f"model.v_dim={V}",
            "--set", f"model.num_fields={NF}", "--set", f"data.max_nnz={NF}",
            "--set", "serve.ladder=8,16,32", *extra]


def read_ready(proc, timeout_s: float) -> dict:
    import select

    if not select.select([proc.stdout], [], [], timeout_s)[0]:
        raise TimeoutError(f"no ready line within {timeout_s} s")
    return json.loads(proc.stdout.readline())


def test_fleet_end_to_end_on_the_cpu(fm_ck, tmp_path):
    """Two replicas, replica 1 SIGKILLed by the injector after its 25th
    batch under a closed loop with client retries: no failed request, the
    replica relaunches at gen 1 and rejoins, the router's pCTRs equal the
    port's predict_rows, and SIGTERM drains the router before the
    replicas and exits 0."""
    run = tmp_path / "run"
    env = {**os.environ, "XFLOW_FAULT_SERVE_KILL_BATCHES": str(KILL_BATCHES),
           "XFLOW_FAULT_SERVE_REPLICA": "1", "XFLOW_FAULT_SERVE_KILL_GEN": "0"}
    proc = subprocess.Popen(
        fleet_argv(fm_ck["ck"], "--replicas", "2", "--max-restarts", "1",
                   "--restart-backoff", "0.2", "--run-dir", str(run), "--eject-failures", "2",
                   "--circuit-open-s", "0.5", "--health-poll-s", "0.1"),
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = read_ready(proc, 120)
        assert ready["fleet"] and [r["replica"] for r in ready["replicas"]] == [0, 1]
        assert {r["step"] for r in ready["replicas"]} == {4}
        assert {r["device"] for r in ready["replicas"]} == {"cpu"}
        url = f"http://127.0.0.1:{ready['router_port']}"
        args = serve_bench.build_parser().parse_args([
            "--url", url, "--duration", "4", "--concurrency", "4", "--data", fm_ck["path"],
            "--rows-per-request", "1-8", "--retries", "2", "--deadline-ms", "10000"])
        rep = serve_bench.run(args)
        assert rep["errors"] == 0 and rep["deadline_exceeded"] == 0, rep
        assert rep["requests"] > 2 * KILL_BATCHES

        conn = http.client.HTTPConnection("127.0.0.1", ready["router_port"], timeout=30)
        deadline, health = time.monotonic() + 60, {}
        while time.monotonic() < deadline:  # the relaunched replica rejoins
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            if health["healthy"] == 2:
                break
            time.sleep(0.2)
        assert health["healthy"] == 2, health
        rows = [line.split("\t", 1)[1].strip() for line in open(fm_ck["path"]).read().splitlines()[:16]]
        served = []
        for _ in range(2):  # round-robin: both replicas answer
            conn.request("POST", "/predict", json.dumps({"rows": rows}))
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            assert resp.status == 200 and payload["step"] == 4, payload
            served.append(payload["pctr"])
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    runner = ServeRunner(fm_ck["cfg"], device="cpu")
    runner.load()
    want, _ = runner.predict_rows(rows)
    for got in served:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    assert "replica 1: attempt 0 exited rc=-9" in err and "replica 1 rejoined" in err
    assert err.index("draining router") < err.index("stopping replicas")
    router = tjsonl.read_jsonl(str(run / "serve_router.jsonl"))
    names = [r["event"] for r in router]
    assert names[0] == "fleet_start" and names[-1] == "fleet_final"
    assert "circuit_open" in names and "circuit_close" in names and "drain" in names
    assert {(r["rank"], r["world"]) for r in router} == {(-1, 2)}
    t_drain = next(r["ts"] for r in router if r["event"] == "drain")
    for k in (0, 1):
        recs = tjsonl.read_jsonl(str(run / f"serve_replica{k}.jsonl"))
        assert {(r["replica"], r["rank"], r["run_id"]) for r in recs} == {(k, k, ready["run_id"])}
        finals = [r for r in recs if r.get("event") == "final"]
        assert finals and min(r["ts"] for r in finals) >= t_drain  # the router drained first
    gens1 = {r["gen"] for r in tjsonl.read_jsonl(str(run / "serve_replica1.jsonl"))}
    assert gens1 == {0, 1}
