"""PyTorch port, the multi-slice sync tier against the JAX package: the
port's `SliceSyncer` and the JAX one run the same scripts (every case of
`tests/test_multislice.py`) on the same numpy states, each in its own
sync directory, with one injected clock and sleep, and must write the
same npz files (member names, dtypes and bytes), make the same staleness
decisions (the kind="sync" records equal less `ts` and `dur_ms`) and end
in the same tables; the membership file, the fault environment and
`{slice}` substitution are held to the JAX functions; `sync.mode=off`
and a single slice's `sync` are bitwise one run; and a 2-slice LR
`launch-multislice` in sync mode ends in JAX's tables within 1e-6.
"""

import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import xflow_tpu.parallel.multislice as jms
import xflow_tpu.testing.faults as jfaults
import xflow_tpu_torch.parallel.multislice as tms
import xflow_tpu_torch.testing.faults as tfaults
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model
from xflow_tpu.optim import get_optimizer
from xflow_tpu.train import init_state
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train.state import TrainState as TState
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jms, "torch": tms}

SYNC_PAIRS = {
    "sync.mode": "bounded", "sync.staleness_k": 1, "sync.on_stale": "proceed",
    "sync.timeout_s": 0.2, "sync.retries": 0, "sync.backoff_s": 0.0,
    "sync.snapshot_every": 1000,
}


def sync_cfgs(root, **kw):
    """{pkg: SyncConfig} with the same fields, each its own directory."""
    pairs = {**SYNC_PAIRS, **kw}
    return {"jax": joverride(JConfig(), **pairs, **{"sync.dir": str(root / "jax")}).sync,
            "torch": override(Config(), **pairs, **{"sync.dir": str(root / "torch")}).sync}


def np_state(seed=0, optim="sgd"):
    """(tables, opt_state, step) as numpy: the JAX LR init plus a seeded
    perturbation, so the leaves are not all zeros."""
    cfg = joverride(JConfig(), **{"data.log2_slots": 6})
    st = init_state(get_model("lr"), get_optimizer(optim), cfg, seed=seed)
    rng = np.random.default_rng(seed)
    tables = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
              for k, v in st.tables.items()}
    opt = {k: {a: np.abs(rng.normal(size=b.shape)).astype(np.float32) for a, b in v.items()}
           for k, v in st.opt_state.items()}
    return tables, opt, int(st.step)


def make_state(pkg, np_st):
    tables, opt, step = np_st
    if pkg == "jax":
        from xflow_tpu.train.state import TrainState as JState

        return JState(tables={k: jax.numpy.asarray(v) for k, v in tables.items()},
                      opt_state={k: {a: jax.numpy.asarray(b) for a, b in v.items()}
                                 for k, v in opt.items()},
                      step=jax.numpy.asarray(step, jax.numpy.int32))
    return TState({k: torch.from_numpy(v.copy()) for k, v in tables.items()},
                  {k: {a: torch.from_numpy(b.copy()) for a, b in v.items()}
                   for k, v in opt.items()}, step)


def bump(pkg, state, delta):
    """A fake training block: every leaf moves by `delta`, the step by 3."""
    if pkg == "jax":
        return state._replace(tables={k: v + delta for k, v in state.tables.items()},
                              opt_state={k: {a: b + delta for a, b in v.items()}
                                         for k, v in state.opt_state.items()},
                              step=state.step + 3)
    return state._replace(tables={k: v + delta for k, v in state.tables.items()},
                          opt_state={k: {a: b + delta for a, b in v.items()}
                                     for k, v in state.opt_state.items()},
                          step=state.step + 3)


def leaves(state) -> dict:
    out = {f"tables/{k}": np.asarray(v) for k, v in state.tables.items()}
    out.update({f"opt/{k}/{a}": np.asarray(b) for k, v in state.opt_state.items()
                for a, b in v.items()})
    return out


class Clock:
    """One injected clock: sleep advances it."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(round(s, 9))
        self.t += s


def syncer(pkg, cfg, slice_id, n, clock):
    return PKGS[pkg].SliceSyncer(cfg[pkg], slice_id, n, clock=clock, sleep=clock.sleep)


def npz_contents(path) -> list:
    with np.load(path) as z:
        return [(k, z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files]


def same_dirs(root) -> None:
    """Both packages' sync dirs hold the same files; every npz the same
    members and bytes, every marker the same JSON less `ts`."""
    names = {p: sorted(os.listdir(root / p)) for p in PKGS}
    assert names["torch"] == names["jax"]
    for name in names["jax"]:
        a, b = root / "jax" / name, root / "torch" / name
        if name.endswith(".npz"):
            assert npz_contents(b) == npz_contents(a), name
        elif name.endswith(".ok"):
            ja, jb = json.load(open(a)), json.load(open(b))
            ja.pop("ts"), jb.pop("ts")
            assert jb == ja, name


def rec_less_time(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "dur_ms")}


# ----------------------------------------------------------- scripts
def script_passthrough(pkg, cfg, clock, env):
    st = make_state(pkg, np_state())
    s = syncer(pkg, cfg, 0, 1, clock)
    s.attach(st)
    st1 = bump(pkg, st, 1.0)
    st2, r1 = s.sync(st1)
    st3, r2 = s.sync(st2)
    assert st2 is st1 and st3 is st2  # the same state, the same tensors
    assert all(a is b for a, b in zip(st3.tables.values(), st1.tables.values()))
    return [r1, r2], leaves(st3)


def script_converge(pkg, cfg, clock, env):
    stA, stB = make_state(pkg, np_state()), make_state(pkg, np_state())
    sA, sB = syncer(pkg, cfg, 0, 2, clock), syncer(pkg, cfg, 1, 2, clock)
    sA.attach(stA)
    sB.attach(stB)
    stA1, rA = sA.sync(bump(pkg, stA, 1.0))
    stB1, rB = sB.sync(bump(pkg, stB, 2.0))
    stA2, rA2 = sA.sync(stA1)
    assert (rA["applied"], rB["applied"], rA2["applied"]) == (0, 1, 1)
    want = np_state()[0]["w"] + 3.0
    np.testing.assert_allclose(np.asarray(stA2.tables["w"]), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(stB1.tables["w"]), want, rtol=0, atol=1e-6)
    return [rA, rB, rA2], {**leaves(stA2), **{"B/" + k: v for k, v in leaves(stB1).items()}}


def script_requires_attach(pkg, cfg, clock, env):
    s = syncer(pkg, cfg, 0, 1, clock)
    with pytest.raises(RuntimeError, match="before attach"):
        s.sync(make_state(pkg, np_state()))
    return [], {}


def script_proceed_on_stale(pkg, cfg, clock, env):
    st = make_state(pkg, np_state())
    s = syncer(pkg, cfg, 0, 2, clock)
    s.attach(st)
    _, rec = s.sync(bump(pkg, st, 1.0))
    assert rec["stale"] == 1 and rec["lags"] == {"1": 1} and rec["timeouts"] == 0
    return [rec], {}


def script_wait_on_stale(pkg, cfg, clock, env):
    st = make_state(pkg, np_state())
    s = syncer(pkg, cfg, 0, 2, clock)
    s.attach(st)
    random.seed(5)  # the backoff's jitter
    _, rec = s.sync(bump(pkg, st, 1.0))
    assert rec["timeouts"] == 2 and rec["stale"] == 1  # bounded: timeout and one retry
    return [rec, {"sleeps": clock.sleeps}], {}


def script_membership_release(pkg, cfg, clock, env):
    st = make_state(pkg, np_state())
    s = syncer(pkg, cfg, 0, 2, clock)
    s.attach(st)
    PKGS[pkg].write_membership(cfg[pkg].dir, {0}, run_id="r", note="slice 1 dead")
    _, rec = s.sync(bump(pkg, st, 1.0))
    assert rec["live"] == [0] and rec["left"] == [1] and rec["stale"] == 0
    assert clock.t == 0.0  # membership, not the 60 s timeout, released it
    return [rec], {}


def script_dead_peer_deltas(pkg, cfg, clock, env):
    stA, stB = make_state(pkg, np_state()), make_state(pkg, np_state())
    sB = syncer(pkg, cfg, 1, 2, clock)
    sB.attach(stB)
    _, rB = sB.sync(bump(pkg, stB, 2.0))
    PKGS[pkg].write_membership(cfg[pkg].dir, {0}, run_id="r", note="slice 1 dead")
    sA = syncer(pkg, cfg, 0, 2, clock)
    sA.attach(stA)
    stA1, rec = sA.sync(bump(pkg, stA, 1.0))
    assert rec["applied"] == 1 and rec["live"] == [0]
    return [rB, rec], leaves(stA1)


def script_adopt_snapshot(pkg, cfg, clock, env):
    stA = make_state(pkg, np_state())
    sA = syncer(pkg, cfg, 0, 2, clock)
    sA.attach(stA)
    stA1, rA = sA.sync(bump(pkg, stA, 1.0))
    stB = make_state(pkg, np_state(seed=3))
    sB = syncer(pkg, cfg, 1, 2, clock)
    stB2, adopted = sB.adopt_latest_snapshot(stB)
    assert adopted == (1, 0) and sB._applied[0] == 1 and sB.round == 1
    assert int(stB2.step) == int(stB.step)  # its own step
    np.testing.assert_array_equal(np.asarray(stB2.tables["w"]), np.asarray(stA1.tables["w"]))
    return [rA, {"adopted": list(adopted)}], leaves(stB2)


def script_fast_forward(pkg, cfg, clock, env):
    stA = make_state(pkg, np_state())
    sA = syncer(pkg, cfg, 0, 2, clock)
    sA.attach(stA)
    st = bump(pkg, stA, 1.0)
    recs = []
    for _ in range(2):
        st, rec = sA.sync(st)
        recs.append(rec)
    env.setenv("XFLOW_RESTART_GEN", "1")
    stB = make_state(pkg, np_state())
    sB = syncer(pkg, cfg, 1, 2, clock)
    stB2, adopted = sB.adopt_latest_snapshot(stB)
    assert adopted is None
    sB.attach(stB2)
    assert sB._applied[0] == 2
    stB3, rec = sB.sync(bump(pkg, stB2, 5.0))
    assert rec["applied"] == 0
    env.delenv("XFLOW_RESTART_GEN")
    return recs + [rec], leaves(stB3)


def script_ftrl_rounds(pkg, cfg, clock, env):
    """Three slices under FTRL (n, z leaves), async: rounds land out of
    step and each applies what it finds, in (round, slice) order."""
    sts = [make_state(pkg, np_state(seed=0, optim="ftrl")) for _ in range(3)]
    ss = [syncer(pkg, cfg, j, 3, clock) for j in range(3)]
    for s, st in zip(ss, sts):
        s.attach(st)
    recs = []
    for j, d in ((0, 0.5), (2, 0.25), (0, 1.0), (1, 2.0), (2, 0.125), (1, 0.0)):
        sts[j], rec = ss[j].sync(bump(pkg, sts[j], d))
        recs.append(rec)
    out = {}
    for j, st in enumerate(sts):
        out.update({f"{j}/{k}": v for k, v in leaves(st).items()})
    return recs, out


SCRIPTS = {
    "passthrough": (script_passthrough, {"sync.mode": "sync"}),
    "converge": (script_converge, {}),
    "requires_attach": (script_requires_attach, {}),
    "proceed_on_stale": (script_proceed_on_stale, {"sync.staleness_k": 0}),
    "wait_on_stale": (script_wait_on_stale, {"sync.staleness_k": 0, "sync.on_stale": "wait",
                                             "sync.timeout_s": 0.05, "sync.retries": 1,
                                             "sync.backoff_s": 0.5}),
    "membership_release": (script_membership_release, {"sync.mode": "sync",
                                                       "sync.timeout_s": 60.0}),
    "dead_peer_deltas": (script_dead_peer_deltas, {}),
    "adopt_snapshot": (script_adopt_snapshot, {"sync.snapshot_every": 1}),
    "fast_forward": (script_fast_forward, {}),
    "ftrl_async_three_slices": (script_ftrl_rounds, {"sync.mode": "async",
                                                     "sync.snapshot_every": 2}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_syncer_matches_jax(tmp_path, monkeypatch, name):
    for k in list(os.environ):
        if k.startswith("XFLOW_"):
            monkeypatch.delenv(k)
    script, kw = SCRIPTS[name]
    cfg = sync_cfgs(tmp_path, **kw)
    got = {}
    for pkg in PKGS:
        clock = Clock()
        recs, state = script(pkg, cfg, clock, monkeypatch)
        got[pkg] = ([rec_less_time(r) for r in recs], state, clock.sleeps)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][2] == got["jax"][2]
    assert sorted(got["torch"][1]) == sorted(got["jax"][1])
    for k, v in got["jax"][1].items():
        np.testing.assert_array_equal(got["torch"][1][k], v, err_msg=k)
    same_dirs(tmp_path)


def test_syncer_config_errors_match_jax(tmp_path):
    for pairs, msg in (({"sync.mode": "off", "sync.dir": str(tmp_path)}, "sync.mode='off'"),
                       ({"sync.mode": "bounded", "sync.dir": ""}, "sync.dir is empty")):
        errs = []
        for mod, cfg in ((jms, joverride(JConfig(), **pairs)), (tms, override(Config(), **pairs))):
            with pytest.raises(ValueError, match=msg) as e:
                mod.SliceSyncer(cfg.sync, 0, 2)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# ------------------------------------------------- membership and env
def test_membership_defensive_read_matches_jax(tmp_path):
    for pkg, mod in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        assert mod.read_membership(str(d), 3) == {0, 1, 2}
        mod.write_membership(str(d), {0, 2}, run_id="r", note="t")
        assert jms.read_membership(str(d), 3) == tms.read_membership(str(d), 3) == {0, 2}
        mod.write_membership(str(d), {7}, run_id="r", note="t")
        assert mod.read_membership(str(d), 3) == {0, 1, 2}
        with open(d / "membership.json", "w") as f:
            f.write("{nope")
        assert mod.read_membership(str(d), 3) == {0, 1, 2}
    # each package reads the other's file
    for a, b in (("jax", "torch"), ("torch", "jax")):
        PKGS[a].write_membership(str(tmp_path / a), {1}, run_id="r", note="t")
        assert PKGS[b].read_membership(str(tmp_path / a), 3) == {1}


SYNC_FAULT_ENVS = {
    "unset": {},
    "both": {"XFLOW_FAULT_SLICE_KILL_ROUND": "3", "XFLOW_FAULT_SYNC_DELAY_S": "0.25"},
    "other_slice": {"XFLOW_FAULT_SLICE_KILL_ROUND": "3", "XFLOW_FAULT_SYNC_DELAY_S": "0.25",
                    "XFLOW_FAULT_SLICE": "1", "XFLOW_SLICE": "0"},
    "this_slice": {"XFLOW_FAULT_SLICE_KILL_ROUND": "3", "XFLOW_FAULT_SYNC_DELAY_S": "0.25",
                   "XFLOW_FAULT_SLICE": "1", "XFLOW_SLICE": "1"},
    "relaunched": {"XFLOW_FAULT_SLICE_KILL_ROUND": "3", "XFLOW_FAULT_SYNC_DELAY_S": "0.25",
                   "XFLOW_FAULT_SLICE": "1", "XFLOW_SLICE": "1", "XFLOW_RESTART_GEN": "1"},
    "split_targets": {"XFLOW_FAULT_SLICE_KILL_ROUND": "2", "XFLOW_FAULT_SYNC_DELAY_S": "0.5",
                      "XFLOW_FAULT_SLICE_KILL_SLICE": "1", "XFLOW_FAULT_SYNC_DELAY_SLICE": "0",
                      "XFLOW_SLICE": "0"},
    "junk": {"XFLOW_FAULT_SLICE_KILL_ROUND": "x", "XFLOW_FAULT_SLICE": "y", "XFLOW_SLICE": "1"},
}


@pytest.mark.parametrize("case", sorted(SYNC_FAULT_ENVS))
def test_sync_fault_env_matches_jax(monkeypatch, case):
    for k in list(os.environ):
        if k.startswith("XFLOW_"):
            monkeypatch.delenv(k)
    for k, v in SYNC_FAULT_ENVS[case].items():
        monkeypatch.setenv(k, v)
    assert tfaults.sync_faults_from_env() == jfaults.sync_faults_from_env()


def test_slice_forward_args_substitution():
    args = ["--train", "/d/tr_s{slice}", "--checkpoint-dir", "ck{slice}", "--epochs", "2"]
    for j in (0, 3):
        assert tms.slice_forward_args(args, j) == jms.slice_forward_args(args, j)
    assert tms.slice_forward_args(args, 1)[:2] == ["--train", "/d/tr_s1"]


# ------------------------------------------------------ the trainer
def _fit_pairs(root, **kw):
    return {"data.train_path": str(root / "train"), "data.log2_slots": 12,
            "data.batch_size": 100, "data.max_nnz": 8, "model.num_fields": 5,
            "model.name": "lr", "optim.name": "sgd", "train.epochs": 1,
            "train.pred_dump": False, **kw}


def test_mode_off_and_single_slice_sync_are_bitwise_identical(tmp_path, monkeypatch):
    """sync.mode=off and a single slice's sync.mode=sync (rounds every 2
    steps and the final one) give bitwise the same tables, and the sync
    run's records carry kind="sync" with the JAX keys and a slice_sync
    span."""
    for k in list(os.environ):
        if k.startswith("XFLOW_"):
            monkeypatch.delenv(k)
    generate_shards(str(tmp_path / "train"), 1, 600, num_fields=5, ids_per_field=30, seed=0)
    t_off = Trainer(override(Config(), **_fit_pairs(tmp_path)), device="cpu")
    t_off.fit()
    mpath = tmp_path / "m.jsonl"
    t_sync = Trainer(override(Config(), **_fit_pairs(tmp_path, **{
        "sync.mode": "sync", "sync.dir": str(tmp_path / "solo"), "sync.every_steps": 2,
        "train.metrics_path": str(mpath)})), device="cpu")
    t_sync.fit()
    for name in t_off.state.tables:
        assert t_off.state.tables[name].numpy().tobytes() == \
            t_sync.state.tables[name].numpy().tobytes()
    recs = [json.loads(ln) for ln in open(mpath)]
    syncs = [r for r in recs if r.get("kind") == "sync"]
    assert [r["round"] for r in syncs] == [1, 2, 3, 4]  # 6 steps: 3 rounds and the final
    assert {"round", "k", "mode", "live", "joined", "left", "bytes_out", "bytes_in",
            "applied", "stale", "timeouts", "lag_max", "lags", "dur_ms"} <= set(syncs[0])
    assert sum(1 for r in recs if r.get("kind") == "span" and r.get("name") == "slice_sync") \
        == 4


def _run_multislice(pkg, root, shards_prefix, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    for k in list(env):
        if k.startswith("XFLOW_"):
            env.pop(k)
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    env.update(extra_env or {})
    argv = [sys.executable, "-m", pkg, "launch-multislice", "--slices", "2", "--run-dir",
            str(root / "run"), "--", "--train", f"{shards_prefix}{{slice}}", "--model", "lr",
            "--epochs", "2", "--batch-size", "50", "--log2-slots", "10",
            "--checkpoint-dir", str(root / "ck{slice}"), "--set", "model.num_fields=5",
            "--set", "data.max_nnz=8", "--set", "train.pred_dump=false",
            "--set", "sync.mode=sync", "--set", "sync.every_steps=2",
            "--set", "sync.timeout_s=60", "--set", "train.log_every=1"]
    if pkg == "xflow_tpu_torch":
        argv[argv.index("--model"):argv.index("--model")] = ["--device", "cpu"]
    return subprocess.run(argv, cwd=root, env=env, capture_output=True, text=True, timeout=300)


def test_two_slice_lr_launch_matches_jax(tmp_path):
    """`launch-multislice --slices 2` of LR in sync mode, the port beside
    the JAX package on the same shards: each slice's final tables within
    1e-6, both slices at init + the delta sum, the records of both."""
    for j in range(2):
        generate_shards(str(tmp_path / f"s{j}"), 1, 300, num_fields=5, ids_per_field=30,
                        seed=j, truth_seed=0)
    out = {}
    for pkg in ("xflow_tpu", "xflow_tpu_torch"):
        root = tmp_path / pkg
        root.mkdir()
        r = _run_multislice(pkg, root, str(tmp_path / "s"))
        assert r.returncode == 0, (pkg, r.stderr[-3000:])
        out[pkg] = {}
        for j in range(2):
            ck = root / f"ck{j}"
            (step,) = [int(d.split("_")[1]) for d in os.listdir(ck) if d.startswith("step_")]
            out[pkg][j] = dict(np.load(ck / f"step_{step}" / "state.npz"))
        recs = [json.loads(ln) for ln in open(root / "run" / "metrics_rank1.jsonl")]
        syncs = [x for x in recs if x.get("kind") == "sync"]
        assert syncs and all((x["rank"], x["slice"]) == (1, 1) for x in syncs)
        out[pkg]["rounds"] = [x["round"] for x in syncs]
    assert out["xflow_tpu_torch"]["rounds"] == out["xflow_tpu"]["rounds"]
    for j in range(2):
        t, jx = out["xflow_tpu_torch"][j], out["xflow_tpu"][j]
        for k in ("tables/w", "opt/w/n", "opt/w/z"):
            np.testing.assert_allclose(t[k], jx[k], rtol=0, atol=1e-6, err_msg=(j, k))
    # both slices hold init + the sum of every committed delta
    sync_dir = tmp_path / "xflow_tpu_torch" / "run" / "sync"
    total = {k: np.zeros_like(v) for k, v in out["xflow_tpu_torch"][0].items()
             if k != "step"}
    for name in os.listdir(sync_dir):
        if name.startswith("delta_") and name.endswith(".npz"):
            with np.load(sync_dir / name) as z:
                for k in z.files:
                    total[k] += z[k]
    for j in range(2):
        for k, v in total.items():
            np.testing.assert_allclose(out["xflow_tpu_torch"][j][k], v, rtol=0, atol=1e-5,
                                       err_msg=(j, k))
