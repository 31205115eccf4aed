"""PyTorch port, the server's socket-free parts against the JAX package on
the same inputs: request parsing and batch assembly, the MicroBatcher
under one scripted sequence of submits and takes on an injected clock
(size and deadline flushes, whole requests, 503s, brownout with
low-priority shedding, the release rung, close-then-drain), the ladder
and the SLO controller over one sequence of windows, head sampling,
the serve telemetry window keys and the stream's roll, and the tiered
restore past a digest-poisoned primary step.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu import jsonl as jjsonl
from xflow_tpu import tracing as jtracing
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.serve import autotune as jautotune
from xflow_tpu.serve import coalescer as jco
from xflow_tpu.serve.metrics import SERVE_WINDOW_KEYS as J_WINDOW_KEYS
from xflow_tpu.serve.metrics import ServeMetrics as JServeMetrics
from xflow_tpu.serve.runner import BadRequest as JBadRequest
from xflow_tpu.serve.runner import parse_rows as jparse_rows
from xflow_tpu.telemetry import Registry as JRegistry
from xflow_tpu.testing.faults import bitflip_npz_array
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.state import TrainState
from xflow_tpu_torch import jsonl, tracing
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.serve import autotune, coalescer as co
from xflow_tpu_torch.serve.metrics import SERVE_WINDOW_KEYS, ServeMetrics
from xflow_tpu_torch.serve.runner import BadRequest, ServeRunner, parse_rows
from xflow_tpu_torch.telemetry import Registry
from xflow_tpu_torch.train import checkpoint as tckpt

LOG2_S, V = 12, 4
S, K = 1 << LOG2_S, 1 + V


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------- parse and assemble
def test_parse_rows_matches_jax_and_rejects_the_same_rows():
    rows = ["0:a 1:b 2:c", "5\t3:x:0.5 4:y", "1:1234 junk 7:é", "2:z " * 12]
    for pairs in ({}, {"data.hash_salt": 5, "data.log2_slots": 16}):
        tf, ts = parse_rows(rows, override(Config(), **pairs).data)
        jf, js = jparse_rows(rows, joverride(JConfig(), **pairs).data)
        for a, b in zip(tf + ts, jf + js):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for bad in (["nothing here"], [42], ["0:a", None], ["\t"]):
        with pytest.raises(BadRequest) as mine:
            parse_rows(bad, Config().data)
        with pytest.raises(JBadRequest) as theirs:
            jparse_rows(bad, JConfig().data)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("batch_size,max_nnz", [(4, 4), (8, 3), (16, 12)])
def test_assemble_batch_matches_jax(batch_size, max_nnz):
    rng = np.random.default_rng(batch_size + max_nnz)

    reqs = []
    for n in (1, 2, 1):
        fields = [rng.integers(0, 9, size=rng.integers(1, 10)).astype(np.int32)
                  for _ in range(n)]
        reqs.append((fields, [rng.integers(0, S, size=f.size).astype(np.int32)
                              for f in fields]))
    for use in (reqs[:1], reqs[:2], reqs):
        mine, mspans = co.assemble_batch(
            [co.PendingRequest(fields=f, slots=s) for f, s in use], batch_size, max_nnz)
        theirs, jspans = jco.assemble_batch(
            [jco.PendingRequest(fields=f, slots=s) for f, s in use], batch_size, max_nnz)
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype and mine[k].tobytes() == theirs[k].tobytes()
        assert [(lo, hi) for _, lo, hi in mspans] == [(lo, hi) for _, lo, hi in jspans]
    empty, spans = co.assemble_batch([], batch_size, max_nnz)
    assert spans == [] and not empty["mask"].any() and not empty["row_mask"].any()
    with pytest.raises(ValueError):
        co.assemble_batch([co.PendingRequest(fields=[np.zeros(1, np.int32)] * 17,
                                             slots=[np.zeros(1, np.int32)] * 17)], 16, 1)


# ---------------------------------------------------------------- batcher
def _rows(n, nnz=3):
    return ([np.arange(nnz, dtype=np.int32) for _ in range(n)],
            [np.full(nnz, 7, dtype=np.int32) for _ in range(n)])


def _drive(mod, script, **kw):
    """Run `script` on a `mod.MicroBatcher` with a fake clock; the trace of
    what each op returned and every brownout callback."""
    clock, out = FakeClock(), []
    policy = kw.pop("brownout", None)
    mb = mod.MicroBatcher(clock=clock, on_brownout=lambda a, q: out.append(("mode", a, q)),
                          brownout=mod.BrownoutPolicy(**policy) if policy else None, **kw)
    for op, *args in script:
        if op == "t":
            clock.t = args[0]
        elif op == "submit":
            n, prio = args if len(args) == 2 else (args[0], 0)
            try:
                mb.submit(*_rows(n), priority=prio)
                out.append(("ok", n))
            except mod.RejectedRequest as e:
                out.append(("rejected", e.client_error, e.shed, str(e)))
        elif op == "take":
            g = mb.take(timeout=0.0)
            out.append(("take", None if g is None else [r.num_rows for r in g]))
        elif op == "close":
            mb.close()
        elif op == "window":
            mb.set_window_s(args[0])
        elif op == "release":
            mb.set_release_rows(args[0])
        out.append(("state", mb.queued_rows, mb.brownout, mb.effective_window_s,
                    mb.release_rows))
    return out


SCRIPTS = {
    # rows reach max_rows: flush at once, whatever the window
    "size_flush": (dict(max_rows=4, window_s=100.0),
                   [("submit", 2), ("take",), ("submit", 2), ("take",), ("take",)]),
    # the oldest request ages past the window
    "deadline_flush": (dict(max_rows=100, window_s=5.0),
                       [("submit", 1), ("take",), ("t", 4.9), ("submit", 3), ("take",),
                        ("t", 5.0), ("take",), ("take",)]),
    # 3 + 3 > 4: requests stay whole, one group each
    "whole_requests": (dict(max_rows=4, window_s=0.0),
                       [("submit", 3), ("submit", 3), ("submit", 1), ("take",), ("take",),
                        ("take",)]),
    # client errors and the backlog cliff
    "rejections": (dict(max_rows=4, window_s=0.0, max_queue_rows=6),
                   [("submit", 5), ("submit", 0), ("submit", 4), ("submit", 2),
                    ("submit", 1), ("take",), ("submit", 1), ("take",), ("take",)]),
    # close: submits 503, the backlog drains, then None
    "close_drain": (dict(max_rows=8, window_s=100.0),
                    [("submit", 2), ("submit", 3), ("close",), ("submit", 1), ("take",),
                     ("take",)]),
    # the autotuner's setters: a smaller rung releases sooner, a request
    # over the rung still releases alone
    "release_rung": (dict(max_rows=8, window_s=100.0),
                     [("release", 2), ("submit", 1), ("take",), ("submit", 1), ("take",),
                      ("submit", 5), ("take",), ("release", 99), ("window", 0.5),
                      ("submit", 1), ("take",), ("t", 0.5), ("take",)]),
    # brownout: a backlog over high_rows sustained after_s enters (window
    # x 0.25, low priority shed), under low_rows sustained after_s exits
    "brownout": (dict(max_rows=8, window_s=1.0, max_queue_rows=40,
                      brownout=dict(high_rows=20, low_rows=5, after_s=0.25,
                                    window_factor=0.25)),
                 [("submit", 8), ("submit", 8), ("submit", 8), ("t", 0.1),
                  ("submit", 1, -1), ("t", 0.3), ("submit", 1, -1), ("submit", 2),
                  ("t", 0.35), ("take",), ("take",), ("take",), ("t", 0.4), ("take",),
                  ("t", 0.5), ("take",), ("t", 0.8), ("take",), ("submit", 1, -1),
                  ("t", 2.0), ("take",), ("take",)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_micro_batcher_matches_jax_on_a_scripted_sequence(name):
    kw, script = SCRIPTS[name]
    mine = _drive(co, script, **dict(kw))
    assert mine == _drive(jco, script, **dict(kw))
    takes = [e for e in mine if e[0] == "take" and e[1]]
    assert takes, "the script released no group"
    if name == "brownout":
        modes = [e[1] for e in mine if e[0] == "mode"]
        sheds = [e for e in mine if e[0] == "rejected" and e[2]]
        assert modes == [True, False] and len(sheds) == 1


def test_brownout_policy_from_config_matches_jax():
    pairs = {"serve.max_queue_rows": 1000, "serve.brownout_high_frac": 0.7,
             "serve.brownout_low_frac": 0.1, "serve.brownout_after_s": 0.5,
             "serve.brownout_window_factor": 0.5}
    for p in ({}, pairs):
        mine = co.BrownoutPolicy.from_config(override(Config(), **p).serve)
        theirs = jco.BrownoutPolicy.from_config(joverride(JConfig(), **p).serve)
        assert (mine.high_rows, mine.low_rows, mine.after_s, mine.window_factor) == (
            theirs.high_rows, theirs.low_rows, theirs.after_s, theirs.window_factor)


# ------------------------------------------------------- ladder, autotune
@pytest.mark.parametrize("ladder,max_batch", [("", 256), ("32,64,128,256", 256),
                                              ("16, 64,999", 128), ("8,,8,4", 32)])
def test_parse_ladder_and_pick_rung_match_jax(ladder, max_batch):
    pairs = {"serve.ladder": ladder, "serve.max_batch": max_batch}
    rungs = autotune.parse_ladder(override(Config(), **pairs).serve)
    assert rungs == jautotune.parse_ladder(joverride(JConfig(), **pairs).serve)
    for n in range(0, max_batch + 3):
        assert autotune.pick_rung(n, rungs) == jautotune.pick_rung(n, rungs)


@pytest.mark.parametrize("ladder", ["x,8", "0,8", "-4"])
def test_parse_ladder_rejects_what_jax_rejects(ladder):
    with pytest.raises(ValueError) as mine:
        autotune.parse_ladder(override(Config(), **{"serve.ladder": ladder}).serve)
    with pytest.raises(ValueError) as theirs:
        jautotune.parse_ladder(joverride(JConfig(), **{"serve.ladder": ladder}).serve)
    assert str(mine.value) == str(theirs.value)


def _windows(seed, n=60):
    """A sequence of windows that crosses the SLO both ways, with queue
    and device each dominating, and a stretch the window floor cannot
    meet."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 10) % 4
        total = {0: 40.0, 1: 5.0, 2: 26.0, 3: 80.0}[phase] * rng.uniform(0.8, 1.2)
        q, d = (total * 0.7, total * 0.2) if phase in (0, 3) else (total * 0.1, total * 0.8)
        out.append({"total_p99_ms": round(total, 3), "queue_wait_p99_ms": round(q, 3),
                    "device_p99_ms": round(d, 3), "batch_fill": 0.5})
    out.insert(7, {"total_p99_ms": None, "queue_wait_p99_ms": 1.0, "device_p99_ms": 1.0})
    return out


@pytest.mark.parametrize("pairs", [
    {"serve.ladder": "32,64,128,256"},
    {"serve.ladder": "", "serve.autotune_min_window_ms": 1.0, "serve.slo_p99_ms": 10.0},
    {"serve.ladder": "16,256", "serve.autotune_band_frac": 0.0,
     "serve.autotune_step_frac": 0.9, "serve.window_ms": 8.0},
])
def test_autotune_controller_makes_the_jax_decisions(pairs):
    pairs = {"serve.autotune": True, **pairs}
    clock, jclock = FakeClock(), FakeClock()
    mine = autotune.AutotuneController(override(Config(), **pairs).serve, clock=clock)
    theirs = jautotune.AutotuneController(joverride(JConfig(), **pairs).serve, clock=jclock)
    reasons = set()
    for i, w in enumerate(_windows(len(pairs))):
        clock.t = jclock.t = float(i)
        got, want = mine.observe(dict(w)), theirs.observe(dict(w))
        assert [(d.knob, d.old, d.new, d.reason) for d in got] == [
            (d.knob, d.old, d.new, d.reason) for d in want]
        reasons |= {d.reason for d in got}
        assert mine.state() == theirs.state()
    assert len(reasons) >= 3, reasons
    with pytest.raises(ValueError):
        autotune.AutotuneController(override(Config(), **{"serve.slo_p99_ms": 0.0}).serve)


# ---------------------------------------------------------------- tracing
def test_sampled_keeps_and_drops_the_jax_ids():
    rng = np.random.default_rng(0)
    ids = [tracing.new_id() for _ in range(1500)] + [
        "".join(chr(c) for c in rng.integers(33, 127, size=rng.integers(1, 40)))
        for _ in range(500)] + ["", "é-ü", "x" * 70]
    kept = 0
    for rate in (-1.0, 0.0, 1e-3, 0.01, 0.1, 0.25, 0.5, 0.9, 0.999, 1.0, 2.0):
        for tid in ids:
            got = tracing.sampled(tid, rate)
            assert got == jtracing.sampled(tid, rate), (tid, rate)
            kept += got
    assert 0 < kept < 11 * len(ids)
    for raw in ("abc", " a-b_c.d ", "bad id", "x" * 65, "", None, "ü", "ok\n"):
        assert tracing.clean_id(raw) == jtracing.clean_id(raw)


class _ListSink:
    def __init__(self):
        self.records = []

    def append(self, rec):
        self.records.append(rec)


@pytest.mark.parametrize("mod", [tracing, jtracing], ids=["port", "jax"])
def test_tracer_verdicts_and_shared_spans(mod):
    """The same verdict sequence emits the same span names, in both
    packages: head-sampled and forced traces flush, dropped ones don't,
    late spans follow the verdict, a shared batch span emits once."""
    sink = _ListSink()
    tr = mod.Tracer(sink, sample_rate=0.5)
    keep = next(t for t in (f"k{i}" for i in range(100)) if mod.sampled(t, 0.5))
    drop = next(t for t in (f"d{i}" for i in range(100)) if not mod.sampled(t, 0.5))
    for t in (keep, drop):
        tr.end(tr.span(t, "server"))
    tr.add_shared({"kind": "span", "trace": keep, "span": "b", "name": "device_batch"},
                  [keep, drop])
    assert tr.finish(keep) and not tr.finish(drop)
    tr.add(keep, {"kind": "span", "trace": keep, "name": "late"})
    tr.add(drop, {"kind": "span", "trace": drop, "name": "late"})
    forced = f"f-{drop}"
    tr.end(tr.span(forced, "server"))
    tr.finish(forced, force=True)
    assert [(r["trace"], r["name"]) for r in sink.records] == [
        (keep, "server"), (keep, "device_batch"), (keep, "late"), (forced, "server")]
    assert tr.pending_traces() == 0 and "_shared" not in sink.records[1]


# ---------------------------------------------------------------- telemetry
def test_serve_metrics_window_matches_jax(tmp_path):
    assert SERVE_WINDOW_KEYS == J_WINDOW_KEYS
    recs = []
    for name, cls, reg in (("t", ServeMetrics, Registry()), ("j", JServeMetrics, JRegistry())):
        m = cls(str(tmp_path / f"{name}.jsonl"), every_s=3600.0, batch_size=8, registry=reg)
        m.event("start", generation=1, step=4)
        assert m.maybe_flush(1, 4) is None  # the window has not elapsed
        m.observe_batch(2, 5, [0.001, 0.002], 0.003, [0.004, 0.005], batch_size=8)
        m.observe_batch(1, 1, [0.0005], 0.002, [0.0025])
        m.observe_bad_request()
        m.observe_shed()
        m.event("reload", generation=2, step=9)
        # a window flushed with the pre-swap pair stamps the high-water one
        rec = m.maybe_flush(1, 4, force=True, freshness_s=12.34567)
        m.close(2, 9)
        recs.append((rec, reg.snapshot(), (tmp_path / f"{name}.jsonl").read_text()))
    (mine, msnap, mtext), (theirs, jsnap, jtext) = recs
    assert set(SERVE_WINDOW_KEYS) | {"kind", "data_freshness_s"} == set(mine) == set(theirs)
    for k in SERVE_WINDOW_KEYS:
        if k not in ("qps", "rows_per_s", "window_s"):  # wall-clock rates
            assert mine[k] == theirs[k], k
    assert (mine["generation"], mine["step"], mine["batch_fill"]) == (2, 9, 0.375)
    del msnap["serve.qps"], jsnap["serve.qps"]  # a wall-clock rate
    assert msnap == jsnap and msnap["serve.shed_requests"] == 1
    strip = ("ts", "run_id", "qps", "rows_per_s", "window_s")
    lines = [[{k: v for k, v in json.loads(ln).items() if k not in strip}
              for ln in text.splitlines()] for text in (mtext, jtext)]
    assert lines[0] == lines[1] and [r.get("event") for r in lines[0]] == [
        "start", "reload", None, "final"]


def test_stream_rolls_past_max_bytes_and_reads_in_order(tmp_path):
    """`serve.metrics_max_bytes`: the live file rolls to one `.1` sibling;
    both packages' readers fold the roll back in file order."""
    path = str(tmp_path / "serve.jsonl")
    m = ServeMetrics(path, batch_size=4, registry=Registry(), max_bytes=600)
    for i in range(40):
        m.event("tick", generation=1, step=i)
    m.close(1, 39)
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) <= 600 and os.path.getsize(path + ".1") <= 600
    mine = jsonl.read_jsonl(path)
    assert mine == jjsonl.read_jsonl(path)
    steps = [r["step"] for r in mine if r.get("event") == "tick"]
    assert steps == sorted(steps) and steps[-1] == 39 and mine[-1]["event"] == "final"
    assert len(mine) < 41  # older rolls are dropped: the stream stays bounded
    live = jjsonl.read_jsonl(path, fold_rotated=False)
    assert mine[-len(live):] == live and mine[:-len(live)] == jjsonl.read_jsonl(path + ".1")
    with open(path, "a") as f:
        f.write('{"cut": \n[1, 2]\n')
    recs, skipped = jsonl.read_jsonl_counted(path)
    assert (recs, skipped) == jjsonl.read_jsonl_counted(path, warn=False) and skipped == 2


@pytest.mark.parametrize("cls", [Registry, JRegistry], ids=["port", "jax"])
def test_registry_counters_gauges_timers(cls):
    """The same operations give the same snapshot and window in both
    packages' registries."""
    reg = cls()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    t = reg.timer("t")
    for x in (0.003, 0.001, 0.002, 0.010):
        t.observe(x)
    with t.timing():
        pass
    with pytest.raises(TypeError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    snap = reg.snapshot()
    assert (snap["c"], snap["g"], snap["t.count"]) == (5, 2.5, 5)
    assert abs(snap["t.total_s"] - 0.016) < 1e-3
    assert t.percentile(100) == 0.010 and t.percentile(0) < 1e-3
    assert len(t.window_reset()) == 5 and np.isnan(t.percentile(50)) and t.count == 5


# ------------------------------------------------------------- tiered restore
def _jax_save(ck, wv, step):
    packed = jst.pack_table(jnp.asarray(wv))
    zeros = jnp.zeros_like(packed)
    jckpt.save(str(ck), TrainState(tables={"wv": packed},
                                   opt_state={"wv": {"n": zeros, "z": zeros}},
                                   step=jnp.asarray(step, jnp.int32)),
               logical_widths={"wv": K})


def _wv(seed):
    return (np.random.default_rng(seed).normal(size=(S, K)) * 0.3).astype(np.float32)


def test_restore_tiered_takes_the_replica_of_a_poisoned_step(tmp_path, capsys):
    primary, replica = tmp_path / "primary", tmp_path / "replica"
    _jax_save(primary, _wv(1), 3)
    _jax_save(primary, _wv(2), 7)
    replica.mkdir()
    shutil.copytree(primary / "step_7", replica / "step_7")
    bitflip_npz_array(str(primary / "step_7" / "state.npz"), member="tables/wv.npy")
    like = TrainState(tables={"wv": jnp.zeros((S // 8, 8 * K))}, opt_state={},
                      step=jnp.zeros((), jnp.int32))
    jstate, jstep, jsrc = jckpt.restore_tiered(str(primary), like,
                                               replica_dir=str(replica))
    tables, step, src = tckpt.restore_tiered(str(primary), {"wv": (S, K)},
                                             replica_dir=str(replica))
    assert (step, src) == (jstep, jsrc) == (7, str(replica))
    np.testing.assert_array_equal(tables["wv"], _wv(2))
    np.testing.assert_array_equal(np.asarray(jstate.tables["wv"]).reshape(S, K), _wv(2))
    err = capsys.readouterr().err
    assert "(primary tier) failed to load" in err and "digest mismatch" in err
    # without the replica both walk back to step 3
    assert tckpt.restore_tiered(str(primary), {"wv": (S, K)})[1:] == (3, str(primary))
    assert jckpt.restore_tiered(str(primary), like)[1] == 3
    # the runner reads both tiers, and the publication from the tier it loaded
    with open(replica / "step_7" / "publication.json", "w") as f:
        json.dump({"step": 7, "trace": "abc", "ingest_ts": 1.0}, f)
    cfg = override(Config(), **{
        "model.name": "fm", "model.v_dim": V, "data.log2_slots": LOG2_S,
        "train.checkpoint_dir": str(primary), "train.ckpt_replica_dir": str(replica)})
    runner = ServeRunner(cfg, device="cpu")
    assert runner.latest_committed_step() == 7
    gen = runner.load()
    assert (gen.step, gen.publication["trace"]) == (7, "abc") and gen.freshness_s() > 0
    assert tckpt.read_publication(str(replica), 7) == jckpt.read_publication(str(replica), 7)
    assert tckpt.read_publication(str(primary), 7) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_tiered(str(tmp_path / "none"), {"wv": (S, K)})
    bitflip_npz_array(str(replica / "step_7" / "state.npz"), member="tables/wv.npy")
    bitflip_npz_array(str(primary / "step_3" / "state.npz"), member="tables/wv.npy")
    with pytest.raises(RuntimeError, match="all 3 candidates failed"):
        tckpt.restore_tiered(str(primary), {"wv": (S, K)}, replica_dir=str(replica))
