"""PyTorch port, the inference slice end to end against the JAX package:
a checkpoint written by `xflow_tpu.train.checkpoint.save` restores in the
port (digests verified, walk-back past a silently corrupted step), the
port's sorted-window `evaluate` gives the JAX trainer's AUC and logloss
on the same checkpoint and libffm shard, and `ServeRunner.predict_rows`
gives the port's evaluate pctrs (the serve == evaluate pin). The package
imports, and its `evaluate` and `train` commands run (FM, and MVM on
both row sides, and FM's online loop in tail mode with async tiered
saves and publications), with `jax` and `xflow_tpu` blocked: through the native
parser and planner, and from an `.xfc` cache the port packs; so do
`serve` and `serve-fleet` (the fleet's replica too, and torch blocked
in the fleet process, which only routes), and the launchers'
`--help` and `launch-dist --dry-run`.
"""

import http.client
import json
import os
import select
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.serve.runner import parse_rows as jparse_rows
from xflow_tpu.testing.faults import bitflip_npz_array
from xflow_tpu.train import checkpoint as jckpt
from xflow_tpu.train.state import TrainState
from xflow_tpu.train.trainer import Trainer
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.evaluate import evaluate, predict_batches
from xflow_tpu_torch.serve.runner import BadRequest, ServeRunner, parse_rows
from xflow_tpu_torch.train import checkpoint as tckpt

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
S, K = 1 << LOG2_S, 1 + V
ROWS = 200  # three full batches and a padded one


def _pairs(ckpt_dir):
    return {
        "model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
        "data.log2_slots": LOG2_S, "data.batch_size": B, "data.max_nnz": NNZ,
        "train.checkpoint_dir": str(ckpt_dir),
    }


def _wv(seed):
    rng = np.random.default_rng(seed)
    wv = (rng.normal(size=(S, K)) * 0.3).astype(np.float32)
    return wv


def _jax_save(ckpt_dir, wv, step):
    packed = jst.pack_table(jnp.asarray(wv))
    zeros = jnp.zeros_like(packed)
    state = TrainState(
        tables={"wv": packed},
        opt_state={"wv": {"n": zeros, "z": zeros}},
        step=jnp.asarray(step, jnp.int32),
    )
    return jckpt.save(str(ckpt_dir), state, logical_widths={"wv": K})


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_slice")
    (path,) = jgenerate_shards(str(work / "test"), 1, ROWS, num_fields=NF,
                               ids_per_field=40, seed=3)
    ck = work / "ck"
    _jax_save(ck, _wv(10), 3)
    _jax_save(ck, _wv(11), 7)
    jcfg = joverride(JConfig(), **_pairs(ck), **{"train.pred_dump": False})
    t = Trainer(jcfg)
    assert t._sorted, "the JAX evaluate must run the sorted-window engine"
    assert t.maybe_restore()
    jauc, jll = t.evaluate(test_path=path, dump=False)
    return {"work": work, "path": path, "ck": ck, "jauc": jauc, "jll": jll}


def test_synth_shard_matches_jax(tmp_path):
    (mine,) = generate_shards(str(tmp_path / "a"), 1, 50, num_fields=NF,
                              ids_per_field=40, seed=3)
    (theirs,) = jgenerate_shards(str(tmp_path / "b"), 1, 50, num_fields=NF,
                                 ids_per_field=40, seed=3)
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_restore_jax_checkpoint_with_digests(slice_case):
    ck = str(slice_case["ck"])
    assert tckpt.committed_steps(ck) == [7, 3]
    assert tckpt.latest_step(ck) == 7
    meta = tckpt.read_meta(ck, 7)
    assert meta["version"] == tckpt.CHECKPOINT_VERSION
    tables, step = tckpt.restore_tables(ck, {"wv": (S, K)})
    assert step == 7
    np.testing.assert_array_equal(tables["wv"], _wv(11))
    # the digests the JAX writer recorded are the port's digests too
    assert meta["digests"]["tables/wv"] == tckpt.array_digest(_wv(11))


def test_bitflipped_newest_step_walks_back(tmp_path, capsys):
    ck = tmp_path / "ck"
    _jax_save(ck, _wv(20), 3)
    _jax_save(ck, _wv(21), 7)
    bitflip_npz_array(str(ck / "step_7" / "state.npz"), member="tables/wv.npy")
    with pytest.raises(tckpt.CheckpointDigestError):
        tckpt.restore_step_tables(str(ck), 7, {"wv": (S, K)})
    tables, step = tckpt.restore_tables(str(ck), {"wv": (S, K)})
    assert step == 3
    np.testing.assert_array_equal(tables["wv"], _wv(20))
    assert "digest mismatch" in capsys.readouterr().err
    runner = ServeRunner(override(Config(), **_pairs(ck)), device="cpu")
    assert runner.load().step == 3


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    ck = tmp_path / "ck"
    tckpt.save_tables(str(ck), {"wv": _wv(30)}, 5)
    like = TrainState(tables={"wv": jnp.zeros((S // 8, 8 * K))}, opt_state={},
                      step=jnp.zeros((), jnp.int32))
    state = jckpt.restore(str(ck), like)
    np.testing.assert_array_equal(np.asarray(state.tables["wv"]).reshape(S, K), _wv(30))
    assert int(state.step) == 5


def test_evaluate_matches_jax_sorted_engine(slice_case):
    cfg = override(Config(), **_pairs(slice_case["ck"]))
    runner = ServeRunner(cfg, device="cpu")
    gen = runner.load()
    assert gen.step == 7
    auc, ll = evaluate(cfg, gen.tables, slice_case["path"], device="cpu")
    assert auc == slice_case["jauc"]
    assert abs(ll - slice_case["jll"]) <= 1e-6


def test_serve_matches_evaluate(slice_case):
    cfg = override(Config(), **_pairs(slice_case["ck"]), **{"serve.max_batch": 32})
    runner = ServeRunner(cfg, device="cpu")
    gen = runner.load()
    pctrs = np.concatenate([
        p[b.row_mask > 0]
        for b, p in predict_batches(cfg, gen.tables, slice_case["path"], device="cpu")
    ])
    rows = [line.split("\t", 1)[1].strip()
            for line in open(slice_case["path"]).read().splitlines()[:96]]
    got, served = runner.predict_rows(rows)
    assert served is gen
    np.testing.assert_allclose(got, pctrs[:96], atol=1e-5, rtol=0)


def test_parse_rows_hashing_matches_jax():
    rows = ["0:tok1 1:tok2", "1\t3:abc:0.5 7:xyz", "2:1234 junk 5:é"]
    for pairs in ({}, {"data.hash_salt": 77, "data.log2_slots": 18}):
        tcfg, jcfg = override(Config(), **pairs), joverride(JConfig(), **pairs)
        tf, ts = parse_rows(rows, tcfg.data)
        jf, js = jparse_rows(rows, jcfg.data)
        for a, b in zip(tf + ts, jf + js):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(BadRequest, match="no parseable"):
        parse_rows(["nothing here"], Config().data)
    with pytest.raises(BadRequest, match="expected a string"):
        parse_rows([42], Config().data)


_NO_JAX = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['xflow_tpu'] = None\n"
)


def _run_without_jax(code, *args, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX + f"sys.path.insert(0, {REPO_ROOT!r})\n" + code, *args],
        cwd=cwd, capture_output=True, text=True, timeout=240,
    )


def test_port_imports_without_jax():
    r = _run_without_jax(
        "import xflow_tpu_torch, xflow_tpu_torch.evaluate, xflow_tpu_torch.weights\n"
        "import xflow_tpu_torch.serve.runner, xflow_tpu_torch.data.synth\n"
        "import xflow_tpu_torch.ops.kernels, xflow_tpu_torch.__main__\n"
        "import xflow_tpu_torch.optim, xflow_tpu_torch.train.state\n"
        "import xflow_tpu_torch.train.step, xflow_tpu_torch.train.trainer\n"
        "import xflow_tpu_torch.models.mvm, xflow_tpu_torch.ops.lab\n"
        "import xflow_tpu_torch.tools.bench_lab, xflow_tpu_torch.tools.kernel_parity\n"
        "import xflow_tpu_torch.data.native, xflow_tpu_torch.data.pipeline\n"
        "import xflow_tpu_torch.data.shardcache, xflow_tpu_torch.jsonl\n"
        "import xflow_tpu_torch.tools.criteo_convert\n"
        "import xflow_tpu_torch.telemetry, xflow_tpu_torch.tracing\n"
        "import xflow_tpu_torch.serve.coalescer, xflow_tpu_torch.serve.autotune\n"
        "import xflow_tpu_torch.serve.metrics, xflow_tpu_torch.serve.server\n"
        "import xflow_tpu_torch.tools.serve_bench, xflow_tpu_torch.serve.router\n"
        "import xflow_tpu_torch.serve.fleet, xflow_tpu_torch.launch.supervise\n"
        "import xflow_tpu_torch.launch.local, xflow_tpu_torch.testing.faults\n"
        "import xflow_tpu_torch.serve.lifecycle, xflow_tpu_torch.train.checkpoint\n"
        "import xflow_tpu_torch.tools.collisions\n"
        "import xflow_tpu_torch.parallel, xflow_tpu_torch.parallel.mesh\n"
        "import xflow_tpu_torch.parallel.distributed, xflow_tpu_torch.parallel.collectives\n"
        "import xflow_tpu_torch.parallel.train_step, xflow_tpu_torch.parallel.sorted_sharded\n"
        "import xflow_tpu_torch.parallel.sorted_fullshard\n"
        "import xflow_tpu_torch.tools.fullshard_overflow_sim\n"
        "import xflow_tpu_torch.launch.watchdog, xflow_tpu_torch.launch.dist\n"
        "import xflow_tpu_torch.parallel.multislice\n"
        "print('ok')\n"
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_cli_launchers_without_jax(tmp_path):
    """`launch-local --help`, `launch-multislice --help` and `launch-dist
    --dry-run` with jax and xflow_tpu blocked: the port's command lines,
    the XFLOW_* contract."""
    main = "from xflow_tpu_torch.__main__ import main\nsys.exit(main(sys.argv[1:]))\n"
    for cmd, want in (("launch-local", "--allow-shrink"), ("launch-multislice", "{slice}")):
        r = _run_without_jax(main, cmd, "--help")
        assert r.returncode == 0, r.stderr
        assert want in r.stdout and "--max-restarts" in r.stdout
    r = _run_without_jax(main, "launch-dist", "--host", "a", "--host", "b", "--dry-run",
                         "--", "--train", "/d/t", "--device", "cpu", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("-m xflow_tpu_torch train") == 2
    assert "XFLOW_PROCESS_ID=1" in r.stdout and "XFLOW_COORDINATOR=a:29431" in r.stdout


def test_cli_evaluate_without_jax(slice_case):
    r = _run_without_jax(
        "from xflow_tpu_torch.__main__ import main\n"
        "sys.exit(main(sys.argv[1:]))\n",
        "evaluate", "--checkpoint-dir", str(slice_case["ck"]),
        "--test", slice_case["path"], "--device", "cpu", "--model", "fm",
        "--batch-size", str(B), "--log2-slots", str(LOG2_S),
        "--set", f"model.v_dim={V}", "--set", f"data.max_nnz={NNZ}",
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["step"] == 7 and out["device"] == "cpu"
    assert out["auc"] == slice_case["jauc"]
    assert abs(out["logloss"] - slice_case["jll"]) <= 1e-6


def test_cli_train_without_jax(slice_case, tmp_path):
    prefix = slice_case["path"][: -len("-00000")]
    r = _run_without_jax(
        "from xflow_tpu_torch.__main__ import main\n"
        "sys.exit(main(sys.argv[1:]))\n",
        "train", "--train", prefix, "--test", prefix, "--model", "fm", "--epochs", "2",
        "--batch-size", str(B), "--log2-slots", str(LOG2_S),
        "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu",
        "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
        "--set", f"data.max_nnz={NNZ}", cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"steps", "epochs", "examples", "seconds", "examples_per_sec", "last_loss",
            "bad_steps", "auc", "logloss"} <= out.keys()
    # the prediction dump lands in the working directory, a row an example
    assert len(open(tmp_path / "pred_0_0.txt").read().splitlines()) == ROWS
    assert (out["steps"], out["epochs"], out["examples"], out["bad_steps"]) == (8, 2, 2 * ROWS, 0)
    assert out["device"] == "cpu" and 0.0 <= out["auc"] <= 1.0
    assert tckpt.committed_steps(str(tmp_path / "ck")) == [8]


def test_cli_two_rank_train_without_jax(slice_case, tmp_path):
    """Two ranks of `train` with jax and xflow_tpu blocked: `--help` names
    the world's flags, and a 2-rank gloo run over the shard (the second
    rank's shard missing: it pads with empty batches) exits 0 with rank
    0's summary alone."""
    import socket

    main = "from xflow_tpu_torch.__main__ import main\nsys.exit(main(sys.argv[1:]))\n"
    helps = [_run_without_jax(main, "train", "--help") for _ in range(2)]
    for r in helps:
        assert r.returncode == 0, r.stderr
        assert "--num-processes" in r.stdout and "--coordinator" in r.stdout
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    prefix = slice_case["path"][: -len("-00000")]
    code = _NO_JAX + f"sys.path.insert(0, {REPO_ROOT!r})\n" + main
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, "train", "--train", prefix, "--epochs", "1",
         "--batch-size", str(B), "--log2-slots", str(LOG2_S), "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck"), "--set", f"data.max_nnz={NNZ}",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r)], cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "is blocked" not in err
    assert outs[1][0].strip() == ""
    out = json.loads(outs[0][0].strip().splitlines()[-1])
    assert (out["world"], out["rank"], out["steps"], out["examples"]) == (2, 0, 4, ROWS)
    assert tckpt.committed_steps(str(tmp_path / "ck")) == [4]


def test_cli_tail_train_without_jax(slice_case, tmp_path):
    """The online loop through the CLI with jax and xflow_tpu blocked: a
    tail fit over the shard with async tiered saves and publications."""
    prefix = slice_case["path"][: -len("-00000")]
    ck, rep, metrics = tmp_path / "ck", tmp_path / "rep", tmp_path / "m.jsonl"
    r = _run_without_jax(
        "from xflow_tpu_torch.__main__ import main\n"
        "sys.exit(main(sys.argv[1:]))\n",
        "train", "--train", prefix, "--model", "fm", "--batch-size", str(B),
        "--log2-slots", str(LOG2_S), "--checkpoint-dir", str(ck), "--device", "cpu",
        "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
        "--set", f"data.max_nnz={NNZ}", "--set", "data.stream=tail",
        "--set", "data.stream_poll_s=0.02", "--set", "data.stream_idle_s=0.3",
        "--set", f"data.stream_dir={tmp_path / 'spool'}", "--set", "train.ckpt_async=true",
        "--set", f"train.ckpt_replica_dir={rep}", "--set", "train.publish_every=2",
        "--set", "train.keep_checkpoints=1", "--set", f"train.metrics_path={metrics}",
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["steps"], out["examples"], out["epochs"]) == (4, ROWS, 1)
    assert tckpt.committed_steps(str(ck)) == [4]
    assert tckpt.committed_steps(str(rep))[0] == 4
    assert tckpt.read_publication(str(ck), 4)["step"] == 4
    kinds = {json.loads(line).get("kind") for line in open(metrics)}
    assert {"ingest", "ckpt", "publish", "span"} <= kinds


def test_cli_data_tools_and_observed_train_without_jax(tmp_path):
    """gen-data (Zipf, bulk, FFM truth), train with every observability
    flag on and a test shard, export and collisions, with jax and
    xflow_tpu blocked, from a working directory outside the repo: the
    records, the heartbeat, the trace and pred_0_0.txt land there."""
    main = "from xflow_tpu_torch.__main__ import main\nsys.exit(main(sys.argv[1:]))\n"

    def run(*argv):
        r = _run_without_jax(main, *argv, cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        return r.stdout

    common = ("--fields", str(NF), "--ids-per-field", "40", "--zipf-alpha", "1.05")
    assert run("gen-data", "train", "--bulk", "--shards", "1", "--rows", "320",
               "--truth-seed", "3", *common).split() == ["train-00000"]
    assert run("gen-data", "test", "--shards", "1", "--rows", "128", "--seed", "1",
               "--truth-seed", "3", *common).split() == ["test-00000"]
    assert run("gen-data", "ffm", "--shards", "2", "--rows", "10", "--truth", "ffm").split() == [
        "ffm-00000", "ffm-00001"]
    out = run("train", "--train", "train", "--test", "test", "--model", "fm", "--epochs", "2",
              "--batch-size", str(B), "--log2-slots", str(LOG2_S), "--checkpoint-dir", "ck",
              "--device", "cpu", "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
              "--set", f"data.max_nnz={NNZ}", "--set", "train.log_every=1",
              "--set", "train.metrics_path=run/metrics_rank0.jsonl",
              "--set", "train.heartbeat_path=run/heartbeat_rank0.jsonl",
              "--set", "train.heartbeat_every=1", "--set", "train.health_metrics=norms",
              "--set", "train.pipeline_metrics=true", "--set", "train.hang_timeout_s=30",
              "--set", "train.eval_every=1", "--set", "train.profile_dir=prof",
              "--set", "train.trace_start_step=2", "--set", "train.trace_num_steps=2")
    summary = json.loads(out.strip().splitlines()[-1])
    assert (summary["steps"], summary["epochs"]) == (10, 2) and 0.0 <= summary["auc"] <= 1.0
    assert len(open(tmp_path / "pred_0_0.txt").read().splitlines()) == 128
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics_rank0.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 11))
    assert sum("eval_auc" in r for r in recs) == 2 and sum(bool(r.get("final")) for r in recs) == 1
    assert any(r.get("kind") == "pipeline" for r in recs)
    beats = [json.loads(line) for line in open(tmp_path / "run" / "heartbeat_rank0.jsonl")]
    assert beats[0]["event"] == "start" and beats[-1]["event"] == "final"
    assert len(os.listdir(tmp_path / "prof")) == 1
    for table in ("w", "v", "wv"):
        ex = json.loads(run("export", "ck", "--table", table, "--out", f"{table}.tsv"))
        assert ex["step"] == 10 and ex["table"] == table and ex["nonzero"] > 0
    col = json.loads(run("collisions", "train-00000", "test-00000", "--log2-slots", "10"))
    assert col["distinct_tokens"] > 0 and col["log2_slots"] == 10


@pytest.mark.parametrize("exclusive", ["auto", "off"])
def test_cli_mvm_train_and_evaluate_without_jax(slice_case, tmp_path, exclusive):
    prefix = slice_case["path"][: -len("-00000")]
    common = ("--batch-size", str(B), "--log2-slots", str(LOG2_S), "--device", "cpu",
              "--model", "mvm", "--set", f"model.v_dim={V}", "--set", f"model.num_fields={NF}",
              "--set", f"data.max_nnz={NNZ}", "--set", f"model.mvm_exclusive={exclusive}",
              "--set", "model.mvm_plus_one=true", "--set", "data.sorted_sub_batches=2")
    main = "from xflow_tpu_torch.__main__ import main\nsys.exit(main(sys.argv[1:]))\n"
    r = _run_without_jax(main, "train", "--train", prefix, "--epochs", "2",
                         "--checkpoint-dir", str(tmp_path / "ck"), *common)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["steps"], out["epochs"], out["examples"], out["bad_steps"]) == (8, 2, 2 * ROWS, 0)
    assert out["device"] == "cpu" and np.isfinite(out["last_loss"])
    assert set(out["occupancy"]) == {"v"} and 0.0 < out["occupancy"]["v"] < 1.0
    r = _run_without_jax(main, "evaluate", "--checkpoint-dir", str(tmp_path / "ck"),
                         "--test", slice_case["path"], *common)
    assert r.returncode == 0, r.stderr
    ev = json.loads(r.stdout.strip().splitlines()[-1])
    assert ev["step"] == 8 and 0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["logloss"])


def test_cli_reads_through_the_native_plane_without_jax(slice_case, tmp_path):
    """train and evaluate read through the native parser and planner (the
    Python parser's count stays 0), then train again from the `.xfc`
    cache `criteo_convert cache` packs, all with jax blocked."""
    prefix = str(tmp_path / "c")  # a copy: the cache lands beside it
    path = prefix + "-00000"
    with open(slice_case["path"], "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    code = (
        "import json\n"
        "from xflow_tpu_torch.__main__ import main\n"
        "from xflow_tpu_torch.data import pipeline\n"
        "from xflow_tpu_torch.tools import criteo_convert\n"
        "ck, prefix, path = sys.argv[1:4]\n"
        "common = ['--batch-size', '64', '--log2-slots', '14', '--device', 'cpu',\n"
        "          '--model', 'fm', '--set', 'model.v_dim=4', '--set', 'data.max_nnz=8',\n"
        "          '--set', 'model.num_fields=8', '--set', 'data.parser_threads=2']\n"
        "calls = {}\n"
        "for name, argv in (\n"
        "        ('train', ['train', '--train', prefix, '--epochs', '1',\n"
        "                   '--checkpoint-dir', ck + '/a', *common]),\n"
        "        ('evaluate', ['evaluate', '--checkpoint-dir', ck + '/a', '--test', path,\n"
        "                      *common]),\n"
        "        ('pack', None),\n"
        "        ('cached', ['train', '--train', prefix, '--epochs', '1',\n"
        "                    '--checkpoint-dir', ck + '/b', '--set', 'data.cache=on',\n"
        "                    *common])):\n"
        "    pipeline.reset_host_calls()\n"
        "    if argv is None:\n"
        "        rc = criteo_convert.main(['cache', prefix, '--log2-slots', '14',\n"
        "                                  '--max-nnz', '8'])\n"
        "    else:\n"
        "        rc = main(argv)\n"
        "    assert rc == 0, name\n"
        "    calls[name] = pipeline.host_calls()\n"
        "print(json.dumps(calls))\n"
    )
    r = _run_without_jax(code, str(tmp_path), prefix, path)
    assert r.returncode == 0, r.stderr
    calls = json.loads(r.stdout.strip().splitlines()[-1])
    for name in ("train", "evaluate"):
        assert calls[name]["native_stream"] == 4 and calls[name]["native_plan"] == 4, calls
        assert calls[name]["python_rows"] == 0 and calls[name]["cache_batches"] == 0, calls
    assert calls["cached"]["cache_batches"] == 4 and calls["cached"]["native_plan"] == 4
    assert calls["cached"]["native_stream"] == 0 and calls["cached"]["python_rows"] == 0
    assert os.path.exists(path + ".xfc")


def _serve_argv(ck, *extra):
    return [sys.executable, "-c", _NO_JAX + "from xflow_tpu_torch.__main__ import main\n"
            "sys.exit(main(sys.argv[1:]))\n", "serve", "--checkpoint-dir", str(ck),
            "--model", "fm", "--log2-slots", str(LOG2_S), "--set", f"model.v_dim={V}",
            "--set", f"data.max_nnz={NNZ}", *extra]


def _ready_line(proc, timeout_s):
    """The server's first stdout line, waited for at most `timeout_s`."""
    if not select.select([proc.stdout], [], [], timeout_s)[0]:
        raise TimeoutError(f"no ready line within {timeout_s} s")
    return proc.stdout.readline()


def test_cli_serve_without_jax(slice_case, tmp_path):
    """`serve --device cpu` with jax blocked: the ready line, one answer
    equal to `predict_rows`, `/healthz`, the serve stream, exit 0 on
    SIGTERM."""
    metrics = tmp_path / "serve.jsonl"
    proc = subprocess.Popen(
        _serve_argv(slice_case["ck"], "--device", "cpu", "--port", "0", "--max-batch", "32",
                    "--window-ms", "1", "--poll-s", "0.5", "--metrics-path", str(metrics),
                    "--set", "serve.ladder=8,16"),
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(_ready_line(proc, 120))
        assert ready["serving"] and ready["step"] == 7 and ready["generation"] == 1
        assert ready["device"] == "cpu" and ready["pid"] == proc.pid and ready["port"] > 0
        rows = [line.split("\t", 1)[1].strip()
                for line in open(slice_case["path"]).read().splitlines()[:5]]
        conn = http.client.HTTPConnection("127.0.0.1", ready["port"], timeout=30)
        conn.request("POST", "/predict", json.dumps({"rows": rows}))
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200 and payload["step"] == 7
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["step"] == 7
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "warmed up 3 ladder rung(s)" in err
    runner = ServeRunner(override(Config(), **_pairs(slice_case["ck"]), **{"serve.max_batch": 32}),
                         device="cpu")
    runner.load()
    want, _ = runner.predict_rows(rows)
    np.testing.assert_allclose(payload["pctr"], want, atol=1e-5, rtol=0)
    events = [json.loads(line).get("event") for line in metrics.read_text().splitlines()]
    assert events[0] == "start" and events[-1] == "final"


def test_cli_serve_fleet_without_jax(slice_case, tmp_path):
    """`serve-fleet --device cpu` with jax and xflow_tpu blocked in the
    fleet and in its replica (a blocking package first on PYTHONPATH, run
    outside the repository root), and torch blocked in the fleet process,
    which only routes: the ready line, one answer through the router
    equal to `predict_rows`, exit 0 on SIGTERM."""
    block = tmp_path / "block"
    for name in ("jax", "xflow_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(block), REPO_ROOT])}
    code = (_NO_JAX + "sys.modules['torch'] = None\n"
            "from xflow_tpu_torch.__main__ import main\nsys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve-fleet", "--checkpoint-dir", str(slice_case["ck"]),
         "--model", "fm", "--log2-slots", str(LOG2_S), "--set", f"model.v_dim={V}",
         "--set", f"data.max_nnz={NNZ}", "--replicas", "1", "--port", "0", "--device", "cpu",
         "--max-batch", "32", "--run-dir", str(tmp_path / "run")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(_ready_line(proc, 120))
        assert ready["fleet"] and ready["router_port"] > 0
        assert [(r["replica"], r["step"], r["device"]) for r in ready["replicas"]] == [
            (0, 7, "cpu")]
        rows = [line.split("\t", 1)[1].strip()
                for line in open(slice_case["path"]).read().splitlines()[:5]]
        conn = http.client.HTTPConnection("127.0.0.1", ready["router_port"], timeout=30)
        conn.request("POST", "/predict", json.dumps({"rows": rows}))
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and payload["step"] == 7, payload
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "is blocked" not in (tmp_path / "run" / "replica0.log").read_text()
    runner = ServeRunner(override(Config(), **_pairs(slice_case["ck"]), **{"serve.max_batch": 32}),
                         device="cpu")
    runner.load()
    want, _ = runner.predict_rows(rows)
    np.testing.assert_allclose(payload["pctr"], want, atol=1e-5, rtol=0)


def test_cli_serve_on_cuda_without_a_card_exits_with_the_reason(slice_case):
    """No hidden fall back: `--device cuda` where torch sees no CUDA
    device exits non-zero, names the missing device and prints no ready
    line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    r = subprocess.run(_serve_argv(slice_case["ck"], "--device", "cuda", "--port", "0"),
                       cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr and "--device cuda" in r.stderr
