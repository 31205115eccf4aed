"""PyTorch port, the multi-slice sync tier on an in-slice mesh (CPU,
gloo ranks), after `xflow_tpu/parallel/multislice.py`, whose syncer
flattens a sharded state to the host and puts each merged leaf back on
its sharding. A slice that is a 2-rank world (the fully-sharded layout
at (2, 1), the table layout at (1, 2) and (2, 1)) and the JAX
`SliceSyncer` on the same state placed over 2 host devices run one round
against the same peer delta: their sync dirs hold the same npz files
(member, dtype, shape and bytes) and markers, the records agree, the
merged blocks are the JAX leaves' rows, and a fresh syncer adopts the
snapshot on every rank. A mesh `train` with `sync.mode` runs (it was
refused before).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import xflow_tpu.parallel.multislice as jms
import xflow_tpu_torch.parallel.multislice as tms
from tests.torch_sync_ranks import run_slice
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.models import get_model
from xflow_tpu.optim import get_optimizer
from xflow_tpu.train import init_state
from xflow_tpu.train.state import TrainState as JState
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.train.state import TrainState as TState

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC = {"sync.mode": "bounded", "sync.staleness_k": 1, "sync.on_stale": "proceed",
        "sync.timeout_s": 0.2, "sync.retries": 0, "sync.backoff_s": 0.0,
        "sync.snapshot_every": 1}
CASES = [("full", (2, 1)), ("table", (1, 2)), ("table", (2, 1))]


def np_state(seed):
    """LR under FTRL at 2^6 slots, every leaf perturbed from a seed."""
    cfg = joverride(JConfig(), **{"data.log2_slots": 6})
    st = init_state(get_model("lr"), get_optimizer("ftrl"), cfg, seed=seed)
    rng = np.random.default_rng(seed)
    tables = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
              for k, v in st.tables.items()}
    opt = {k: {a: np.abs(rng.normal(size=b.shape)).astype(np.float32) for a, b in v.items()}
           for k, v in st.opt_state.items()}
    return tables, opt, int(st.step)


def jstate(np_st, sharding=None):
    tables, opt, step = np_st
    put = (lambda a: jax.device_put(a, sharding)) if sharding is not None else jax.numpy.asarray
    return JState(tables={k: put(v) for k, v in tables.items()},
                  opt_state={k: {a: put(b) for a, b in v.items()} for k, v in opt.items()},
                  step=jax.numpy.asarray(step, jax.numpy.int32))


def jbump(state, d):
    return state._replace(tables={k: v + d for k, v in state.tables.items()},
                          opt_state={k: {a: b + d for a, b in v.items()}
                                     for k, v in state.opt_state.items()},
                          step=state.step + 3)


def tbump(state, d):
    return state._replace(tables={k: v + d for k, v in state.tables.items()},
                          opt_state={k: {a: b + d for a, b in v.items()}
                                     for k, v in state.opt_state.items()},
                          step=state.step + 3)


def npz_contents(path):
    with np.load(path) as z:
        return [(k, z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files]


def peer_delta(root):
    """Slice 1's round-1 delta (and snapshot), by each package's
    single-device syncer, in that package's dir."""
    for pkg, mod in (("jax", jms), ("torch", tms)):
        scfg = (joverride(JConfig(), **SYNC, **{"sync.dir": str(root / pkg)}).sync if pkg == "jax"
                else override(Config(), **SYNC, **{"sync.dir": str(root / pkg)}).sync)
        s = mod.SliceSyncer(scfg, 1, 2)
        if pkg == "jax":
            st = jstate(np_state(1))
            s.attach(st)
            s.sync(jbump(st, 0.25))
        else:
            tables, opt, step = np_state(1)
            st = TState({k: torch.from_numpy(v.copy()) for k, v in tables.items()},
                        {k: {a: torch.from_numpy(b.copy()) for a, b in v.items()}
                         for k, v in opt.items()}, step)
            s.attach(st)
            s.sync(tbump(st, 0.25))


@pytest.mark.parametrize("layout,mesh", CASES)
def test_a_mesh_slice_writes_and_merges_as_the_jax_syncer(tmp_path, layout, mesh):
    root = tmp_path / "sync"
    peer_delta(root)
    # JAX: slice 0's state over 2 host devices, the leaves split on the mesh
    jm = Mesh(np.asarray(jax.devices()[:2]).reshape(mesh), ("data", "table"))
    spec = P(("data", "table")) if layout == "full" else P("table")
    jsync = jms.SliceSyncer(joverride(JConfig(), **SYNC, **{"sync.dir": str(root / "jax")}).sync,
                            0, 2)
    st = jstate(np_state(0), NamedSharding(jm, spec))
    jsync.attach(st)
    jfinal, jrec = jsync.sync(jbump(st, 0.5))
    # the port: slice 0 a 2-rank world
    pairs = {**SYNC, "sync.dir": str(root / "torch"), "mesh.data": mesh[0],
             "mesh.table": mesh[1], "data.log2_slots": 6}
    ranks = run_slice(2, tmp_path, {"pairs": pairs, "layout": layout, "state": np_state(0),
                                    "bump": 0.5, "num_slices": 2})
    names = {p: sorted(os.listdir(root / p)) for p in ("jax", "torch")}
    assert names["torch"] == names["jax"]
    assert "delta_s0_r1.npz" in names["torch"] and "snap_s0_r1.npz" in names["torch"]
    for name in names["jax"]:
        a, b = root / "jax" / name, root / "torch" / name
        if name.endswith(".npz"):
            assert npz_contents(b) == npz_contents(a), name
        elif name.endswith(".ok"):
            ja, jb = json.load(open(a)), json.load(open(b))
            ja.pop("ts"), jb.pop("ts")
            assert jb == ja, name
    jrec = {k: v for k, v in jrec.items() if k not in ("ts", "dur_ms")}
    want = {f"tables/{k}": np.asarray(v) for k, v in jfinal.tables.items()}
    want.update({f"opt/{k}/{a}": np.asarray(b) for k, v in jfinal.opt_state.items()
                 for a, b in v.items()})
    owners = mesh[0] * mesh[1] if layout == "full" else mesh[1]
    with np.load(root / "torch" / "snap_s0_r1.npz") as z:
        snap = {k: z[k] for k in z.files}
    for r, got in enumerate(ranks):
        assert {k: v for k, v in got["record"].items() if k != "dur_ms"} == jrec
        assert got["record"]["applied"] == 1
        o = r if layout == "full" else r % mesh[1]
        for k, w in want.items():
            rows = w.shape[0] // owners
            np.testing.assert_array_equal(got["blocks"][k], w[o * rows:(o + 1) * rows], k)
            np.testing.assert_array_equal(got["adopted_blocks"][k],
                                          snap[k][o * rows:(o + 1) * rows], k)
        assert got["adopted"] == (1, 0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sync_mode_trains_on_a_mesh(tmp_path):
    """Two `train` ranks with `sync.mode` (one slice): rc 0, and the
    rounds' delta files hold the single-device members."""
    generate_shards(str(tmp_path / "t"), 2, 128, num_fields=4, ids_per_field=50)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    coord = f"127.0.0.1:{_free_port()}"
    sync_dir = tmp_path / "sync"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xflow_tpu_torch", "train", "--train", str(tmp_path / "t"),
         "--model", "lr", "--epochs", "1", "--batch-size", "32", "--log2-slots", "10",
         "--device", "cpu", "--set", "model.num_fields=4", "--set", "data.max_nnz=8",
         "--set", "train.pred_dump=false", "--set", "sync.mode=bounded",
         "--set", f"sync.dir={sync_dir}", "--set", "sync.every_steps=2",
         "--coordinator", coord, "--num-processes", "2", "--process-id", str(k)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    deltas = sorted(n for n in os.listdir(sync_dir) if n.endswith(".npz"))
    assert deltas[:2] == ["delta_s0_r1.npz", "delta_s0_r2.npz"]
    with np.load(sync_dir / "delta_s0_r1.npz") as z:
        assert {k: (z[k].dtype.str, z[k].shape) for k in z.files} == {
            "tables/w": ("<f4", (1024,)), "opt/w/n": ("<f4", (1024,)),
            "opt/w/z": ("<f4", (1024,))}
