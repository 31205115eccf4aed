"""PyTorch port, the raw Criteo / Avazu converter
(`xflow_tpu_torch/tools/criteo_convert.py`) against the JAX tool's, on
raw rows the test writes itself (dirty values, missing and negative
integers, malformed rows): the shards are byte-equal for both formats,
both header settings and a limit; each row transform and the escape
equal JAX's; the fd budget refuses a shard count before any file opens;
the CLI (stdin, `--cache`) writes JAX's shards and caches; the port's
trainer reads the converted shards.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import xflow_tpu.tools.criteo_convert as jcc
import xflow_tpu_torch.tools.criteo_convert as tcc
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.train.trainer import Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FIELDS = tcc.N_INT + tcc.N_CAT


def raw_criteo(rng, n):
    rows = []
    for i in range(n):
        ints = ["" if rng.random() < 0.2 else str(int(rng.integers(-3, 100_000)))
                for _ in range(tcc.N_INT)]
        cats = ["" if rng.random() < 0.1 else format(int(rng.integers(0, 1 << 32)), "08x")
                for _ in range(tcc.N_CAT)]
        rows.append("\t".join([str(i % 2)] + ints + cats) + "\n")
    rows[3] = "\t".join(["1"] + ["7"] * tcc.N_INT + ["a b:c%\x0bd"] * tcc.N_CAT) + "\n"
    rows[5] = "2\t" + "\t".join([""] * N_FIELDS) + "\n"  # a bad label
    rows[7] = "1\tx" + "\t" * (N_FIELDS - 1) + "\n"  # a non-integer Ii
    rows[9] = "0\tshort row\n"
    return rows


def raw_avazu(rng, n, header):
    rows = ["id,click,hour,C1,banner_pos,site_id\n"] if header else []
    for i in range(n):
        site = "" if rng.random() < 0.2 else ("s %d:x" % rng.integers(0, 50))
        rows.append("%d,%d,%d,%d,%d,%s\n" % (1000 + i, i % 3 == 0, 14102100 + i % 24,
                                             rng.integers(1000, 1010), i % 2, site))
    rows.append("9,2,1,1,1,1\n")  # a bad click
    rows.append("9,1,1\n")  # a short row
    return rows


def shards(prefix, n):
    return [open("%s-%05d" % (prefix, s), "rb").read() for s in range(n)]


@pytest.mark.parametrize("fmt,header,limit", [
    ("criteo", True, 0), ("criteo", True, 17), ("avazu", True, 0), ("avazu", False, 0),
    ("avazu", False, 9)])
def test_convert_writes_the_jax_shards(tmp_path, fmt, header, limit):
    rng = np.random.default_rng(3)
    rows = raw_criteo(rng, 120) if fmt == "criteo" else raw_avazu(rng, 60, header)
    got = {}
    for name, mod in (("jax", jcc), ("torch", tcc)):
        got[name] = mod.convert(iter(rows), str(tmp_path / name), 3, fmt=fmt, limit=limit,
                                header=header)
    assert got["torch"] == got["jax"] and got["torch"]["skipped"] >= (0 if limit else 2)
    assert shards(tmp_path / "torch", 3) == shards(tmp_path / "jax", 3)


def test_row_transforms_and_escape_match_jax():
    rng = np.random.default_rng(4)
    for line in raw_criteo(rng, 40):
        assert tcc.criteo_line_to_libffm(line) == jcc.criteo_line_to_libffm(line)
    for line in raw_avazu(rng, 40, header=False):
        assert tcc.avazu_line_to_libffm(line, 4) == jcc.avazu_line_to_libffm(line, 4)
    for v in ["clean", "a b", "a:b", "a%3Ab", "a\tb", "a%b", "\x0c\r\n"]:
        assert tcc._sanitize(v) == jcc._sanitize(v)


def test_fd_budget_is_checked_before_any_file_opens(tmp_path):
    import resource

    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if soft == resource.RLIM_INFINITY:
        pytest.skip("no open-file limit on this process")
    with pytest.raises(ValueError, match="fd limit"):
        tcc.convert(iter([]), str(tmp_path / "x"), soft)
    assert not os.listdir(tmp_path)


def test_cli_stdin_and_cache_write_the_jax_bytes(tmp_path):
    """Each package's CLI in turn to one prefix (a cache names its shard's
    path): the same stats, shard bytes and cache bytes."""
    rows = "".join(raw_criteo(np.random.default_rng(5), 80))
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out, files = {}, {}
    for pkg in ("xflow_tpu", "xflow_tpu_torch"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.criteo_convert", "-",
                            str(tmp_path / "train"), "--shards", "2", "--cache",
                            "--log2-slots", "12", "--max-nnz", str(N_FIELDS)],
                           input=rows, capture_output=True, text=True, env=env, timeout=240)
        assert r.returncode == 0, r.stderr
        out[pkg] = json.loads(r.stdout)
        files[pkg] = [open("%s-%05d%s" % (tmp_path / "train", s, ext), "rb").read()
                      for s in range(2) for ext in ("", ".xfc")]
    assert out["xflow_tpu_torch"] == out["xflow_tpu"]
    assert files["xflow_tpu_torch"] == files["xflow_tpu"]


def test_port_trainer_reads_converted_shards(tmp_path):
    rows = raw_criteo(np.random.default_rng(6), 200)
    stats = tcc.convert(iter(rows), str(tmp_path / "train"), 2)
    assert stats["rows"] + stats["skipped"] == 200
    cfg = override(Config(), **{
        "data.train_path": str(tmp_path / "train"), "data.log2_slots": 14,
        "data.batch_size": 32, "data.max_nnz": N_FIELDS, "model.name": "fm",
        "model.num_fields": N_FIELDS, "model.v_dim": 4, "train.epochs": 1,
        "train.pred_dump": False})
    res = Trainer(cfg, device="cpu").fit()
    assert res.steps == -(-((stats["rows"] + 1) // 2) // 32) and np.isfinite(res.last_loss)
