"""PyTorch port, the checkpoint's write side held against the JAX package:

- `prune_checkpoints` removes the same names as JAX's for keep 0, 1, 2
  and 5 over one tree of committed steps and uncommitted debris;
- `write_flat` with a data_state and a publication writes the JAX
  writer's files (the npz arrays, meta.json, the sidecars' JSON), and
  each package's `read_publication` reads the other's sidecar;
- `mirror_step` lands the replica files JAX's mirror lands, byte for
  byte, is idempotent, writes COMMITTED last, and a byte flipped in
  the staged replica (the replica fault seam) raises
  `CheckpointDigestError` with no replica commit;
- the async writer through `Trainer.fit` on the JAX durable suite's LR
  run (600 rows, 12 steps, checkpoints every 5), the port and the JAX
  trainer under the same `XFLOW_FAULT_CKPT_*` environment: a skip on
  busy under the slow fault, ENOSPC degrading to replica-only saves, a
  synchronous mirror failure keeping the primary, no ckpt record with
  async off, the same (step, tier, event) trail and the same ckpt
  record keys as JAX's;
- async and synchronous saves of one step give equal arrays, digests
  and data_state, and a snapshot taken before further steps saves the
  cadence step's state; no path writes a state leaf in place (both
  step forms, the guard's skip, `_occupancy`, restore), which is what
  lets the card's snapshot keep references to the leaves;
- `_fused_alias`: a JAX two-table FM checkpoint restores into the
  port's fused FM (tables and FTRL state bitwise the concatenation),
  the port's fused checkpoint restores into JAX's two-table FM, and
  pCTRs agree within 1e-5;
- a hard kill in the middle of an async save, then a resume: the walk
  back restores the newest committed step, with the data_state and the
  resume position JAX's resume of the same run has.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.serve.runner import ServeRunner as JServeRunner
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.trainer import Trainer as JTrainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.serve.runner import ServeRunner
from xflow_tpu_torch.train import checkpoint as tckpt
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_ENVS = ("XFLOW_FAULT_CKPT_ENOSPC_BYTES", "XFLOW_FAULT_CKPT_SLOW_S_PER_MB",
              "XFLOW_FAULT_CKPT_TIER")
PCTR_ATOL = 1e-5
WAIT_S = 120.0  # the bound of every wait on a subprocess


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in FAULT_ENVS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _listing(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


# ----------------------------------------------------------- prune and write
def _debris_tree(root):
    """Committed steps 3, 6, 9, 12 and 15, an uncommitted step 18, an
    uncommitted step 4 between them, and a file no sweep may touch."""
    flat = {"tables/w": np.arange(8, dtype=np.float32), "step": np.asarray(0, np.int32)}
    for step in (3, 6, 9, 12, 15):
        tckpt.write_flat(str(root), dict(flat, step=np.asarray(step, np.int32)), step)
    for step in (4, 18):
        os.makedirs(root / f"step_{step}")
        (root / f"step_{step}" / "state.npz").write_bytes(b"torn")
    (root / "notes.txt").write_text("kept")


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_removes_the_names_jax_removes(tmp_path, keep):
    _debris_tree(tmp_path / "t")
    _debris_tree(tmp_path / "j")
    got = tckpt.prune_checkpoints(str(tmp_path / "t"), keep)
    want = jckpt.prune_checkpoints(str(tmp_path / "j"), keep)
    assert sorted(map(os.path.basename, got)) == sorted(map(os.path.basename, want))
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")
    assert "step_4" not in _listing(tmp_path / "t") and "notes.txt" in _listing(tmp_path / "t")
    assert tckpt.tier_steps(str(tmp_path / "t")) == jckpt.tier_steps(str(tmp_path / "j"))


PUB = {"step": 7, "seq": 2, "trace": "ab" * 8, "span": "cd" * 8,
       "ingest_ts": 100.25, "consumed_ts": 101.5, "published_ts": 103.75}
DATA_STATE = {"version": 2, "epoch": 0, "batches": 7, "completed": False, "examples": 448,
              "examples_per_rank": [448], "shard_batches": {"0": 0}, "num_shards": 1,
              "world_size": 1, "quarantined_rows": 0}


def _flat(seed, step=7):
    rng = np.random.default_rng(seed)
    return {"tables/wv": rng.normal(size=(64, 5)).astype(np.float32),
            "opt/wv/n": np.abs(rng.normal(size=(64, 5))).astype(np.float32),
            "opt/wv/z": rng.normal(size=(64, 5)).astype(np.float32),
            "step": np.asarray(step, np.int32)}


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in _listing(d)}


def test_write_flat_with_a_publication_matches_jax(tmp_path):
    flat = _flat(0)
    t = tckpt.write_flat(str(tmp_path / "t"), flat, 7, data_state=DATA_STATE, publication=PUB)
    j = jckpt.write_flat(str(tmp_path / "j"), flat, 7, data_state=DATA_STATE, publication=PUB)
    tf, jf = _files(t), _files(j)
    assert sorted(tf) == sorted(jf) == ["COMMITTED", "data_state.json", "meta.json",
                                        "publication.json", "state.npz"]
    for name in ("COMMITTED", "data_state.json", "publication.json"):
        assert tf[name] == jf[name], name
    assert json.loads(tf["meta.json"]) == json.loads(jf["meta.json"])
    with np.load(os.path.join(t, "state.npz")) as a, np.load(os.path.join(j, "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # each package reads the other's sidecar
    assert jckpt.read_publication(str(tmp_path / "t"), 7) == PUB
    assert tckpt.read_publication(str(tmp_path / "j"), 7) == PUB
    # a data_state and a publication land before the marker: a reader
    # that sees COMMITTED sees both
    marker = os.stat(os.path.join(t, "COMMITTED")).st_mtime_ns
    assert all(os.stat(os.path.join(t, n)).st_mtime_ns <= marker for n in tf)


def test_mirror_step_matches_jax_idempotent_and_committed_last(tmp_path, monkeypatch):
    primary = str(tmp_path / "ck")
    tckpt.write_flat(primary, _flat(1), 7, data_state=DATA_STATE, publication=PUB)
    order = []
    real = tckpt._write_atomic

    def recording(path, writer, fault=None):
        order.append(os.path.basename(path))
        return real(path, writer, fault)

    monkeypatch.setattr(tckpt, "_write_atomic", recording)
    dst = tckpt.mirror_step(primary, str(tmp_path / "rt"), 7)
    jdst = jckpt.mirror_step(primary, str(tmp_path / "rj"), 7)
    assert order[-1] == "COMMITTED" and order.count("COMMITTED") == 1
    assert _files(dst) == _files(jdst)
    assert tckpt.committed_steps(str(tmp_path / "rt")) == [7]
    mtimes = {n: os.stat(os.path.join(dst, n)).st_mtime_ns for n in _listing(dst)}
    order.clear()
    assert tckpt.mirror_step(primary, str(tmp_path / "rt"), 7) == dst  # idempotent
    assert order == []
    assert {n: os.stat(os.path.join(dst, n)).st_mtime_ns for n in _listing(dst)} == mtimes


def test_mirror_raises_on_a_byte_flipped_in_the_replica(tmp_path, monkeypatch):
    primary = str(tmp_path / "ck")
    tckpt.write_flat(primary, _flat(2), 7, data_state=DATA_STATE)

    def flip(tmp):
        if ".npz." not in os.path.basename(tmp):
            return
        with np.load(tmp) as data:
            arrays = {k: data[k].copy() for k in data.files}
        arrays["tables/wv"].view(np.uint32)[3, 2] ^= 1 << 20
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    monkeypatch.setattr(tckpt, "ckpt_write_fault",
                        lambda tier: flip if tier == "replica" else None)
    with pytest.raises(tckpt.CheckpointDigestError, match="tables/wv"):
        tckpt.mirror_step(primary, str(tmp_path / "rep"), 7)
    assert tckpt.committed_steps(str(tmp_path / "rep")) == []
    assert tckpt.committed_steps(primary) == [7]


def test_ckpt_write_fault_env_contract(monkeypatch, tmp_path):
    from xflow_tpu.testing.faults import ckpt_write_fault as jfault
    from xflow_tpu_torch.testing.faults import ckpt_write_fault

    assert ckpt_write_fault("primary") is None and jfault("primary") is None
    p = tmp_path / "blob"
    p.write_bytes(b"x" * 1000)
    monkeypatch.setenv("XFLOW_FAULT_CKPT_ENOSPC_BYTES", "1500")
    f = ckpt_write_fault("primary")
    f(str(p))
    with pytest.raises(OSError, match="ENOSPC"):
        f(str(p))
    ckpt_write_fault("primary")(str(p))  # a fresh budget a save
    monkeypatch.setenv("XFLOW_FAULT_CKPT_TIER", "replica")
    assert ckpt_write_fault("primary") is None and jfault("primary") is None
    assert ckpt_write_fault("replica") is not None


# ----------------------------------------------- the async writer, vs JAX
LR_PAIRS = {"data.log2_slots": 12, "data.batch_size": 100, "data.max_nnz": 8,
            "model.num_fields": 5, "train.epochs": 2}


@pytest.fixture(scope="module")
def lr_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ckpt_lr")
    jgenerate_shards(str(root / "train"), 1, 600, num_fields=5, ids_per_field=30, seed=0)
    return root


def _both(lr_data, tmp_path, **extra):
    """Run the port's and the JAX trainer on the same config (dirs and
    the metrics path under t/ and j/); returns (port result, JAX result,
    port dir, JAX dir)."""
    out = []
    for side in ("t", "j"):
        d = tmp_path / side
        pairs = {**LR_PAIRS, "data.train_path": str(lr_data / "train"),
                 "train.checkpoint_dir": str(d / "ck"),
                 "train.metrics_path": str(d / "metrics.jsonl")}
        for k, v in extra.items():
            pairs[k] = str(d / v) if k == "train.ckpt_replica_dir" else v
        if side == "t":
            out.append(Trainer(override(Config(), **pairs), device="cpu").fit())
        else:
            out.append(JTrainer(joverride(JConfig(), **pairs, **{
                "train.pred_dump": False})).fit())
    return out[0], out[1], tmp_path / "t", tmp_path / "j"


def _ckpt_recs(d):
    path = d / "metrics.jsonl"
    return [r for r in _read_jsonl(path) if r.get("kind") == "ckpt"] if path.exists() else []


def _trail(recs):
    return sorted({(r["step"], r["tier"], r["event"]) for r in recs})


def test_async_skip_on_busy_under_the_slow_fault(lr_data, tmp_path, monkeypatch, capsys):
    # ~48 KB of state at 60 s/MB: the step-5 save is in flight over the
    # step-10 cadence
    monkeypatch.setenv("XFLOW_FAULT_CKPT_SLOW_S_PER_MB", "60")
    tres, jres, t, j = _both(lr_data, tmp_path, **{"train.checkpoint_every": 5,
                                                   "train.ckpt_async": True})
    assert tres.steps == jres.steps == 12
    assert tckpt.committed_steps(str(t / "ck")) == [12, 5]
    assert jckpt.committed_steps(str(j / "ck")) == [12, 5]
    trecs, jrecs = _ckpt_recs(t), _ckpt_recs(j)
    assert _trail(trecs) == _trail(jrecs) == [(5, "primary", "committed"),
                                              (10, "primary", "skipped"),
                                              (12, "primary", "committed")]
    skipped = next(r for r in trecs if r["event"] == "skipped")
    assert skipped["write_ms"] == 0.0 and skipped["skips"] == 1
    assert skipped["bytes"] == 3 * 4096 * 4  # the state's bytes: w, n, z
    assert {frozenset(r) for r in trecs} == {frozenset(r) for r in jrecs}
    assert "previous save still in flight" in capsys.readouterr().err


def test_enospc_degrades_to_replica_only_saves(lr_data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XFLOW_FAULT_CKPT_ENOSPC_BYTES", "1")
    monkeypatch.setenv("XFLOW_FAULT_CKPT_TIER", "primary")
    tres, _, t, j = _both(lr_data, tmp_path, **{
        "train.checkpoint_every": 5, "train.ckpt_async": True,
        "train.ckpt_replica_dir": "replica"})
    assert tres.steps == 12  # training never stopped
    assert tckpt.committed_steps(str(t / "ck")) == []
    # whether the step-10 cadence finds the step-5 save done is timing
    assert tckpt.committed_steps(str(t / "replica"))[0] == 12
    assert jckpt.committed_steps(str(j / "replica"))[0] == 12
    trecs, jrecs = _ckpt_recs(t), _ckpt_recs(j)
    assert {frozenset(r) for r in trecs} == {frozenset(r) for r in jrecs}
    for recs in (trecs, jrecs):
        assert [r["step"] for r in recs if r["tier"] == "primary"][:1] == [5]
        assert {r["event"] for r in recs if r["tier"] == "primary"} <= {"failed", "skipped"}
        assert (12, "replica", "committed") in _trail(recs)
    assert all(r["degraded"] for r in trecs if r["tier"] == "replica")
    assert "degrading to replica-only" in capsys.readouterr().err
    for name in FAULT_ENVS:
        monkeypatch.delenv(name, raising=False)
    t2 = Trainer(override(Config(), **{**LR_PAIRS, "data.train_path": str(lr_data / "train"),
                                       "train.checkpoint_dir": str(t / "ck"),
                                       "train.ckpt_replica_dir": str(t / "replica")}),
                 device="cpu")
    assert t2.maybe_restore() and t2.state.step == 12


def test_sync_mirror_failure_keeps_the_primary(lr_data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XFLOW_FAULT_CKPT_ENOSPC_BYTES", "1")
    monkeypatch.setenv("XFLOW_FAULT_CKPT_TIER", "replica")
    tres, _, t, j = _both(lr_data, tmp_path, **{"train.ckpt_replica_dir": "replica"})
    assert tres.steps == 12
    assert tckpt.committed_steps(str(t / "ck")) == jckpt.committed_steps(str(j / "ck")) == [12]
    assert tckpt.committed_steps(str(t / "replica")) == []
    assert "the primary commit stands" in capsys.readouterr().err


def test_async_off_writes_no_ckpt_record_and_the_same_artifact(lr_data, tmp_path):
    tres, _, t, j = _both(lr_data, tmp_path, **{"train.ckpt_spans": True})
    assert _ckpt_recs(t) == [] == _ckpt_recs(j)
    spans = [r for r in _read_jsonl(t / "metrics.jsonl") if r.get("name") == "checkpoint_save"]
    assert [s["step"] for s in spans] == [12] and spans[0]["bytes"] == 3 * 4096 * 4
    base = {**LR_PAIRS, "data.train_path": str(lr_data / "train")}
    t2 = Trainer(override(Config(), **base, **{
        "train.checkpoint_dir": str(tmp_path / "async"), "train.ckpt_async": True}), device="cpu")
    t2.fit()
    assert t2._ckpt_writer is None  # fit closed it
    sync_dir, async_dir = str(t / "ck"), str(tmp_path / "async")
    assert tckpt.committed_steps(sync_dir) == tckpt.committed_steps(async_dir) == [12]
    ms, ma = tckpt.read_meta(sync_dir, 12), tckpt.read_meta(async_dir, 12)
    assert ms["digests"] == ma["digests"] and ms["layout"] == ma["layout"]
    assert tckpt.read_data_state(sync_dir, 12) == tckpt.read_data_state(async_dir, 12)


# ------------------------------------------------- the snapshot and its claim
FM_PAIRS = {"model.name": "fm", "model.v_dim": 4, "model.num_fields": 8,
            "data.log2_slots": 14, "data.batch_size": 64, "data.max_nnz": 8, "train.epochs": 1}


@pytest.fixture(scope="module")
def fm_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ckpt_fm")
    (path,) = jgenerate_shards(str(root / "train"), 1, 200, num_fields=8, ids_per_field=40,
                               seed=5)
    return root, path


def _batches(cfg, path, n):
    from xflow_tpu_torch.data.pipeline import batch_iterator
    from xflow_tpu_torch.evaluate import HostDedup, batch_arrays, to_device

    out = []
    for batch in batch_iterator(path, cfg.data):
        out.append(to_device(batch_arrays(batch, cfg, HostDedup(cfg)), "cpu"))
        if len(out) == n:
            break
    return out


def _leaves(state):
    out = {f"tables/{k}": t for k, t in state.tables.items()}
    out.update({f"opt/{k}/{leaf}": v for k, st in state.opt_state.items()
                for leaf, v in st.items()})
    return out


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_no_path_writes_a_state_leaf_in_place(fm_data, tmp_path, fused):
    root, path = fm_data
    cfg = override(Config(), **FM_PAIRS, **{
        "data.train_path": str(root / "train"), "optim.fused_scatter": fused,
        "train.checkpoint_dir": str(tmp_path / "ck")})
    t = Trainer(cfg, device="cpu")
    batches = _batches(cfg, path, 3)
    t.state, _ = t.train_step(t.state, batches[0])
    held = _leaves(t.state)  # references, as the card's snapshot keeps them
    before = {k: v.clone() for k, v in held.items()}
    t._occupancy()
    t.state, _ = t.train_step(t.state, batches[1])
    bad = dict(batches[2], labels=torch.full_like(batches[2]["labels"], float("nan")))
    t.state, m = t.train_step(t.state, bad)  # the guard's skip hands leaves through
    assert not m["update_ok"]
    t.save_checkpoint()
    assert t.maybe_restore()
    t.state, _ = t.train_step(t.state, batches[0])
    for k, v in held.items():
        assert torch.equal(v, before[k]), k


def test_async_and_sync_saves_agree_and_a_snapshot_keeps_its_step(fm_data, tmp_path,
                                                                  monkeypatch):
    root, path = fm_data
    base = {**FM_PAIRS, "data.train_path": str(root / "train")}
    sync = Trainer(override(Config(), **base, **{
        "train.checkpoint_dir": str(tmp_path / "sync")}), device="cpu")
    asyn = Trainer(override(Config(), **base, **{
        "train.checkpoint_dir": str(tmp_path / "async"), "train.ckpt_async": True}),
        device="cpu")
    batches = _batches(sync.cfg, path, 3)
    for tr in (sync, asyn):
        tr.state, _ = tr.train_step(tr.state, batches[0])
        tr._epoch_pos = (0, 1)
    assert sync.save_checkpoint() is True
    # hold the async save in its primary write until the test lets it go
    gate = {"go": False}

    def held(tmp):
        deadline = time.monotonic() + WAIT_S
        while not gate["go"] and time.monotonic() < deadline:
            time.sleep(0.01)

    monkeypatch.setattr(tckpt, "ckpt_write_fault", lambda tier: held)
    cadence = {k: v.clone() for k, v in _leaves(asyn.state).items()}
    assert asyn.save_checkpoint() is True
    for b in batches[1:]:  # the fit loop goes on while the save is in flight
        asyn.state, _ = asyn.train_step(asyn.state, b)
    assert asyn._ckpt_writer.busy()
    assert asyn.save_checkpoint() is False  # busy: a counted skip, no snapshot
    assert asyn._ckpt_writer.skips == 1
    gate["go"] = True
    asyn._ckpt_writer.close()
    a, s = str(tmp_path / "async"), str(tmp_path / "sync")
    assert tckpt.committed_steps(a) == tckpt.committed_steps(s) == [1]
    assert tckpt.read_meta(a, 1)["digests"] == tckpt.read_meta(s, 1)["digests"]
    assert tckpt.read_data_state(a, 1) == tckpt.read_data_state(s, 1)
    with np.load(os.path.join(a, "step_1", "state.npz")) as got:
        for k, v in cadence.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ------------------------------------------------------------ _fused_alias
def _rows(path, n=32):
    with open(path) as f:
        return [next(f).split("\t", 1)[1].strip() for _ in range(n)]


def _pctrs(runner, rows):
    runner.load()
    return np.asarray(runner.predict_rows(rows)[0])


def test_fused_alias_bridges_jax_two_table_fm_both_ways(fm_data, tmp_path):
    _, path = fm_data
    rows = _rows(path)
    # JAX two-table FM, an epoch in, so w, v, n and z are all nonzero
    jcfg = joverride(JConfig(), **FM_PAIRS, **{
        "model.fm_fused": False, "train.checkpoint_dir": str(tmp_path / "j2"),
        "train.pred_dump": False})
    jt = JTrainer(jcfg)
    jt.fit(train_path=path)
    step = jckpt.latest_step(str(tmp_path / "j2"))
    fused = override(Config(), **FM_PAIRS, **{"train.checkpoint_dir": str(tmp_path / "j2")})
    t = Trainer(fused, device="cpu")
    assert t.maybe_restore() and t.state.step == step > 0
    S = 1 << FM_PAIRS["data.log2_slots"]

    def two(tree, leaf=None):
        w, v = (tree[n] if leaf is None else tree[n][leaf] for n in ("w", "v"))
        return np.concatenate([np.asarray(w).reshape(S, 1), np.asarray(v).reshape(S, -1)], 1)

    np.testing.assert_array_equal(t.state.tables["wv"].numpy(), two(jt.state.tables))
    for leaf in ("n", "z"):
        np.testing.assert_array_equal(t.state.opt_state["wv"][leaf].numpy(),
                                      two(jt.state.opt_state, leaf))
    want = _pctrs(JServeRunner(jcfg), rows)
    np.testing.assert_allclose(_pctrs(ServeRunner(fused, device="cpu"), rows), want,
                               rtol=0, atol=PCTR_ATOL)
    # and back: the port's fused checkpoint into JAX's two-table FM and the port's
    t.cfg = override(fused, **{"train.checkpoint_dir": str(tmp_path / "t1")})
    t.save_checkpoint()
    jcfg2 = joverride(jcfg, **{"train.checkpoint_dir": str(tmp_path / "t1")})
    j2 = JTrainer(jcfg2)
    assert j2.maybe_restore() and int(j2.state.step) == step
    np.testing.assert_array_equal(two(j2.state.tables), two(jt.state.tables))
    two_cfg = override(fused, **{"model.fm_fused": False,
                                 "train.checkpoint_dir": str(tmp_path / "t1")})
    t2 = Trainer(two_cfg, device="cpu")
    assert t2.maybe_restore()
    np.testing.assert_array_equal(two(t2.state.tables), two(jt.state.tables))
    np.testing.assert_array_equal(two(t2.state.opt_state, "z"), two(jt.state.opt_state, "z"))
    np.testing.assert_allclose(_pctrs(JServeRunner(jcfg2), rows), want, rtol=0, atol=PCTR_ATOL)
    np.testing.assert_allclose(_pctrs(ServeRunner(two_cfg, device="cpu"), rows), want,
                               rtol=0, atol=PCTR_ATOL)


def test_fused_alias_never_bridges_another_model(tmp_path):
    flat = _flat(3)
    tckpt.write_flat(str(tmp_path), flat, 7)
    with pytest.raises(RuntimeError, match="bridge does not apply"):
        tckpt.restore_step_tables(str(tmp_path), 7, {"w": (64,)})  # LR has no v
    tables = tckpt.restore_step_tables(str(tmp_path), 7, {"w": (64,), "v": (64, 4)})
    np.testing.assert_array_equal(tables["v"], flat["tables/wv"][:, 1:])


# ------------------------------------------- a kill in the middle of a save
def _train_argv(prefix, ck, *sets):
    argv = [sys.executable, "-m", "xflow_tpu_torch", "train", "--train", prefix,
            "--epochs", "2", "--batch-size", "100", "--log2-slots", "12",
            "--checkpoint-dir", ck, "--device", "cpu",
            "--set", "model.num_fields=5", "--set", "data.max_nnz=8",
            "--set", "train.checkpoint_every=5"]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_kill_mid_async_save_then_resume_restores_as_jax(lr_data, tmp_path):
    prefix, ck = str(lr_data / "train"), str(tmp_path / "ck")
    env = {**os.environ, "XFLOW_FAULT_CKPT_SLOW_S_PER_MB": "100",
           "XFLOW_FAULT_CKPT_TIER": "primary"}
    proc = subprocess.Popen(_train_argv(prefix, ck, "train.ckpt_async=true"), cwd=REPO_ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    torn = os.path.join(ck, "step_12")
    try:
        deadline = time.monotonic() + WAIT_S
        # step 5 commits (paced), 10 is skipped, and the end-of-run save of
        # step 12 stages its files slowly: kill it there
        while not os.path.isdir(torn) and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            time.sleep(0.02)
        assert os.path.isdir(torn)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(timeout=WAIT_S)
    assert proc.returncode == -signal.SIGKILL
    assert tckpt.committed_steps(ck) == [5]
    assert not os.path.exists(os.path.join(torn, "COMMITTED"))

    r = subprocess.run(_train_argv(prefix, ck, "train.ckpt_async=true"), cwd=REPO_ROOT,
                       capture_output=True, text=True, timeout=WAIT_S)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 5" in r.stderr
    assert tckpt.committed_steps(ck)[0] == 12
    assert "step_12" in os.listdir(ck)

    # JAX's run of the same stream, its step-5 data_state and resume position
    jck = str(tmp_path / "jck")
    jcfg = joverride(JConfig(), **LR_PAIRS, **{
        "data.train_path": prefix, "train.checkpoint_dir": jck,
        "train.checkpoint_every": 5, "train.pred_dump": False})
    JTrainer(jcfg).fit()
    jck5 = str(tmp_path / "jck5")
    os.makedirs(jck5)
    os.rename(os.path.join(jck, "step_5"), os.path.join(jck5, "step_5"))
    want = jckpt.read_data_state(jck5, 5)
    cfg = override(Config(), **LR_PAIRS, **{"data.train_path": prefix,
                                            "train.checkpoint_dir": ck})
    t = Trainer(cfg, device="cpu")
    # the port's torn-save run restored step 5: its data_state is JAX's
    with open(os.path.join(ck, "step_5", "data_state.json")) as f:
        ds = json.load(f)
    assert ds["quarantined_rows"] == 0
    assert {k: v for k, v in ds.items() if k != "quarantined_rows"} == {
        k: v for k, v in want.items() if k != "quarantined_rows"}
    t._resume_data_state = ds
    j = JTrainer(joverride(jcfg, **{"train.checkpoint_dir": jck5}))
    assert j.maybe_restore() and int(j.state.step) == 5
    jepoch, jskips = j._consume_resume_position()
    assert t._consume_resume_position() == (jepoch, jskips) == (0, {0: 5})


def test_new_config_fields_have_the_jax_defaults():
    fields = {"data": ("stream", "stream_poll_s", "stream_idle_s", "stream_dir"),
              "train": ("metrics_path", "ckpt_spans", "ckpt_on_signal",
                        "keep_checkpoints", "ckpt_async", "keep_replica_checkpoints",
                        "publish_every")}
    for section, names in fields.items():
        for name in names:
            got = getattr(getattr(Config(), section), name)
            assert got == getattr(getattr(JConfig(), section), name), f"{section}.{name}"
            assert type(got) is type(getattr(getattr(JConfig(), section), name))
