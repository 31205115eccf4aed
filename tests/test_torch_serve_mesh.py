"""PyTorch port, a serve world on the CPU (gloo ranks): `serve` with
`--coordinator/--num-processes/--process-id` serves a checkpoint written
by one device from a ('data', 'table') mesh behind rank 0's front end,
after `xflow_tpu/launch/cli.py::cmd_serve` and the mesh `ServeRunner`
(`xflow_tpu/serve/runner.py`). At (2, 1) and (1, 2) the pCTRs equal the
JAX mesh runner's (8 host devices, the first 2 in the mesh) and the solo
runner's; a hot reload under traffic answers every request from one
generation, monotone, each batch whole on one step; serve.max_batch that
the data axis does not divide and `--no-mesh` in a world exit 2; SIGTERM
drains every rank to exit 0; a follower that dies ends rank 0 nonzero.
Every wait is bounded, and nothing gates on wall-clock coalescing.
"""

import http.client
import json
import os
import select
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from xflow_tpu.serve.runner import ServeRunner as JServeRunner
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.serve.runner import ServeRunner, max_batch_error
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG2_S, NF, V, B = 12, 8, 4, 64
MAX_BATCH = 16
ROWS = 4 * B
PCTR_ATOL = 1e-5
WAIT_S = 120


def _pairs(ck, **extra):
    return {"model.name": "fm", "model.num_fields": NF, "model.v_dim": V,
            "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NF,
            "train.checkpoint_dir": str(ck), "serve.max_batch": MAX_BATCH, **extra}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _world(ck, mesh, *extra, world=2, ranks=None):
    """Start a serve world of `world` CPU ranks (or only `ranks` of it);
    returns the processes."""
    coord = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "xflow_tpu_torch", "serve", "--checkpoint-dir", str(ck),
         "--model", "fm", "--log2-slots", str(LOG2_S), "--port", "0", "--device", "cpu",
         "--max-batch", str(MAX_BATCH), "--window-ms", "1", "--poll-s", "0.2",
         "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
         "--set", f"data.max_nnz={NF}", "--set", f"mesh.data={mesh[0]}",
         "--set", f"mesh.table={mesh[1]}", "--coordinator", coord,
         "--num-processes", str(world), "--process-id", str(k), *extra],
        cwd=REPO_ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in (range(world) if ranks is None else ranks)]


def _ready(proc):
    if not select.select([proc.stdout], [], [], WAIT_S)[0]:
        raise TimeoutError(f"no ready line within {WAIT_S} s")
    return json.loads(proc.stdout.readline())


def _finish(procs, sig=signal.SIGTERM):
    """Signal every live rank, then collect (rc, stderr) of each."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    out = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        out.append((p.returncode, err))
    return out


def _post(port, rows):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/predict", json.dumps({"rows": rows}))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _train(cfg_pairs, epochs):
    cfg = override(Config(), **cfg_pairs, **{"train.epochs": epochs, "train.log_every": 0,
                                             "train.pred_dump": False})
    t = Trainer(cfg, device="cpu")
    t.maybe_restore()
    return t.fit()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An FM checkpoint one CPU device trained (step 4), its request rows,
    and the solo runner's pCTRs of them."""
    work = tmp_path_factory.mktemp("serve_mesh")
    (path,) = generate_shards(str(work / "train"), 1, ROWS, num_fields=NF, ids_per_field=40,
                              seed=7)
    ck = work / "ck"
    pairs = _pairs(ck, **{"data.train_path": path[: -len("-00000")]})
    assert _train(pairs, 1).steps == 4
    rows = [ln.split("\t", 1)[1].strip() for ln in open(path).read().splitlines()[:40]]
    solo = ServeRunner(override(Config(), **_pairs(ck)), device="cpu")
    assert solo.load().step == 4
    want, _ = solo.predict_rows(rows)
    return {"work": work, "ck": ck, "pairs": pairs, "rows": rows, "solo": want}


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_serve_world_matches_the_jax_mesh_runner_and_the_solo_runner(served, mesh):
    jcfg = joverride(JConfig(), **_pairs(served["ck"]), **{"mesh.data": mesh[0],
                                                          "mesh.table": mesh[1]})
    jrun = JServeRunner(jcfg, mesh=jmake_mesh(jcfg, devices=jax.devices()[:2]))
    jrun.load()
    assert jrun.rungs == (MAX_BATCH,)
    jwant, _ = jrun.predict_rows(served["rows"])
    procs = _world(served["ck"], mesh)
    try:
        ready = _ready(procs[0])
        assert (ready["step"], ready["generation"], ready["world"]) == (4, 1, 2)
        got = []
        for lo, n in ((0, 1), (1, 7), (8, 16), (24, 16)):  # a request of max_batch too
            status, payload = _post(ready["port"], served["rows"][lo:lo + n])
            assert status == 200 and payload["step"] == 4, payload
            got += payload["pctr"]
    finally:
        results = _finish(procs)
    assert [rc for rc, _ in results] == [0, 0], results
    assert "warmed up 1 ladder rung(s)" in results[0][1]
    np.testing.assert_allclose(got, jwant, atol=PCTR_ATOL, rtol=0)
    np.testing.assert_allclose(got, served["solo"], atol=PCTR_ATOL, rtol=0)


def test_hot_reload_in_a_serve_world_never_splits_a_batch(served, tmp_path):
    """Clients post while a second epoch commits step 8: every answer is
    200, each client's generations never go back, and each answer equals
    the solo runner's pCTRs of the step it names, row for row (a batch
    half on each step would not)."""
    ck = tmp_path / "ck"

    shutil.copytree(served["ck"], ck)
    pairs = dict(served["pairs"], **{"train.checkpoint_dir": str(ck)})
    rows = served["rows"]
    procs = _world(ck, (2, 1))
    answers, errors = [], []
    stop = threading.Event()

    def client(k):
        seen = []
        while not stop.is_set():
            lo = (7 * len(seen) + k) % (len(rows) - 5)
            status, payload = _post(port, rows[lo:lo + 5])
            if status != 200:
                errors.append(payload)
                return
            seen.append((payload["generation"], payload["step"], lo, payload["pctr"]))
        answers.append(seen)

    try:
        port = _ready(procs[0])["port"]
        threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        assert _train(pairs, 1).steps == 4  # a continuation epoch commits step 8
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not errors:
            status, payload = _post(port, rows[:1])
            if payload.get("step") == 8:
                break
            time.sleep(0.1)
        time.sleep(0.5)  # traffic on the new generation too
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        stop.set()
        results = _finish(procs)
    assert not errors, errors
    assert [rc for rc, _ in results] == [0, 0], results
    assert payload["step"] == 8 and payload["generation"] == 2
    solo = {}
    for step in (4, 8):
        r = ServeRunner(override(Config(), **_pairs(ck)), device="cpu")
        r.load(step=step)
        solo[step], _ = r.predict_rows(rows)
    for seen in answers:
        gens = [g for g, _, _, _ in seen]
        assert gens == sorted(gens) and set(gens) <= {1, 2}
        for gen, step, lo, pctr in seen:
            assert step == {1: 4, 2: 8}[gen]
            np.testing.assert_allclose(pctr, solo[step][lo:lo + 5], atol=PCTR_ATOL, rtol=0)
    assert sum(len(s) for s in answers) > 0


@pytest.mark.parametrize("case", ["max_batch", "no_mesh"])
def test_serve_world_refusals_exit_2(served, case):
    extra = ("--max-batch", "15") if case == "max_batch" else ("--no-mesh",)
    procs = _world(served["ck"], (2, 1), *extra)
    results = _finish(procs, sig=0)  # signal 0: nothing is sent
    assert [rc for rc, _ in results] == [2, 2], results
    want = (max_batch_error(15, 2) if case == "max_batch"
            else "serve: --no-mesh with a world of several processes")
    assert want in results[0][1]
    assert all("warmed up" not in err for _, err in results)  # no port was bound


@pytest.mark.parametrize("case", ["max_batch", "no_mesh"])
def test_a_refused_serve_world_exits_before_its_rendezvous(served, case):
    """A rank refuses from its flags before it joins the world: rank 0
    of a world of 2 whose rank 1 never starts exits 2 at once. (Refused
    after the rendezvous, a rank could exit while its peer was still
    setting up the mesh's groups, and the peer then died with exit 1 on
    the closed connection instead of refusing.)"""
    extra = ("--max-batch", "15") if case == "max_batch" else ("--no-mesh",)
    (proc,) = _world(served["ck"], (2, 1), *extra, ranks=(0,))
    ((rc, err),) = _finish([proc], sig=0)
    assert rc == 2, err


def test_max_batch_error_is_the_jax_message():
    assert max_batch_error(16, 2) is None
    assert max_batch_error(15, 2) == (
        "serve: serve.max_batch=15 must divide by the mesh data axis (2)")


def test_sigterm_to_every_rank_drains_to_exit_0(served):
    """SIGTERM reaches both ranks (a process group's kill): the follower
    waits for rank 0's drain and stop, and both exit 0."""
    procs = _world(served["ck"], (2, 1))
    try:
        port = _ready(procs[0])["port"]
        assert _post(port, served["rows"][:3])[0] == 200
        procs[1].send_signal(signal.SIGTERM)
        time.sleep(0.5)
        assert procs[1].poll() is None  # the follower still follows
        assert _post(port, served["rows"][:3])[0] == 200
    finally:
        results = _finish(procs)
    assert [rc for rc, _ in results] == [0, 0], results
    assert "serve: shutting down" in results[0][1]


def test_a_dead_follower_ends_rank_0_nonzero(served):
    procs = _world(served["ck"], (2, 1))
    try:
        _ready(procs[0])
        procs[1].kill()
        procs[1].wait(timeout=WAIT_S)
        procs[0].wait(timeout=WAIT_S)  # its next idle round fails
    finally:
        results = _finish(procs)
    assert results[0][0] not in (0, None), results[0]
    assert "the serve world failed" in results[0][1]
