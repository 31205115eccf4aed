"""The port's data tools held against the JAX package:

- the writers (`data/synth.py`): the per-row and the bulk writer with
  Zipf ids, the FFM truth, `truth_density`, `truth_seed` and
  `track_seen` write bytes equal to the JAX writers' for the same seeds
  (and the same `seen` map); the cases of JAX's `tests/test_synth_zipf.py`
  on the port's writer and its parser;
- `gen-data`, `export` (a fused and a two-table checkpoint, `w` being
  the fused table's column 0) and `collisions` print what the JAX CLI
  prints and write the same files; `hashing.slots_of` equals JAX's.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from xflow_tpu.data.synth import generate_shards as jgenerate_shards
from xflow_tpu.data.synth import generate_shards_bulk as jgenerate_shards_bulk
from xflow_tpu.hashing import slots_of as jslots_of
from xflow_tpu.launch.cli import main as jmain
from xflow_tpu_torch.__main__ import main as tmain
from xflow_tpu_torch.config import DataConfig
from xflow_tpu_torch.data.pipeline import batch_iterator
from xflow_tpu_torch.data.synth import generate_shards, generate_shards_bulk
from xflow_tpu_torch.hashing import slots_of
from xflow_tpu_torch.train import checkpoint as tckpt

WRITER_CASES = {
    "uniform": {},
    "zipf": {"zipf_alpha": 1.1},
    "ffm_truth": {"truth": "ffm"},
    "sparse_truth": {"truth_density": 0.3, "zipf_alpha": 1.05},
    "truth_seed": {"truth_seed": 7, "seed": 3},
}
BULK_CASES = {
    "uniform": {},
    "zipf_chunks": {"zipf_alpha": 1.05, "chunk_rows": 128},
    "ffm_truth": {"truth": "ffm", "chunk_rows": 100},
    "sparse_truth": {"truth_density": 0.5, "truth_seed": 9},
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_row_writer_bytes_equal_jax(tmp_path, case):
    kw = dict(num_fields=6, ids_per_field=50, **WRITER_CASES[case])
    tpaths = generate_shards(str(tmp_path / "t"), 2, 120, **kw)
    jpaths = jgenerate_shards(str(tmp_path / "j"), 2, 120, **kw)
    assert [os.path.basename(p)[1:] for p in tpaths] == [os.path.basename(p)[1:] for p in jpaths]
    for tp, jp in zip(tpaths, jpaths):
        assert _read(tp) == _read(jp)


@pytest.mark.parametrize("case", sorted(BULK_CASES))
@pytest.mark.parametrize("track_seen", [False, True])
def test_bulk_writer_bytes_and_seen_equal_jax(tmp_path, case, track_seen):
    kw = dict(num_fields=5, ids_per_field=40, seed=4, track_seen=track_seen, **BULK_CASES[case])
    tpaths, tseen = generate_shards_bulk(str(tmp_path / "t"), 2, 300, **kw)
    jpaths, jseen = jgenerate_shards_bulk(str(tmp_path / "j"), 2, 300, **kw)
    for tp, jp in zip(tpaths, jpaths):
        assert _read(tp) == _read(jp)
    if track_seen:
        np.testing.assert_array_equal(tseen, jseen)
    else:
        assert tseen is None and jseen is None


def test_bogus_truth_raises_as_jax(tmp_path):
    for gen in (generate_shards, jgenerate_shards):
        with pytest.raises(ValueError, match="truth"):
            gen(str(tmp_path / "x"), 1, 4, truth="bogus")


def _dup_fraction(path, nf):
    """Occurrences that repeat an earlier id within a 256-row window."""
    rows = [[int(t.split(":")[1]) for t in line.split("\t")[1].split()]
            for line in open(path).read().splitlines()]
    dups = total = 0
    for start in range(0, len(rows), 256):
        seen = set()
        for row in rows[start:start + 256]:
            assert len(row) == nf
            for g in row:
                total += 1
                dups += g in seen
                seen.add(g)
    return dups / total


def test_zipf_mode_is_skewed_and_learnable(tmp_path):
    nf, ids = 6, 500
    (upath,) = generate_shards(str(tmp_path / "u"), 1, 2000, num_fields=nf, ids_per_field=ids)
    (zpath,) = generate_shards(str(tmp_path / "z"), 1, 2000, num_fields=nf, ids_per_field=ids,
                               zipf_alpha=1.1)
    fu, fz = _dup_fraction(upath, nf), _dup_fraction(zpath, nf)
    assert fz > fu + 0.1, (fu, fz)
    labels = [int(line[0]) for line in open(zpath)]
    assert 0.15 < np.mean(labels) < 0.85


def test_bulk_writer_format_and_seen_through_the_native_parser(tmp_path):
    import re

    paths, seen = generate_shards_bulk(str(tmp_path / "bulk"), 1, 500, num_fields=6,
                                       ids_per_field=40, seed=3, zipf_alpha=1.1,
                                       chunk_rows=128, track_seen=True)
    lines = open(paths[0]).read().splitlines()
    assert len(lines) == 500
    pat = re.compile(r"^[01]\t(\d+:\d+:0\.\d{4})( \d+:\d+:0\.\d{4}){5}$")
    assert all(pat.match(ln) for ln in lines[:50])
    labels = []
    for batch in batch_iterator(paths[0], DataConfig(max_nnz=8, batch_size=64, log2_slots=16)):
        rm = batch.row_mask > 0
        labels.extend(batch.labels[rm].tolist())
        assert (batch.mask.sum(axis=1)[rm] == 6).all()
        for row_f, row_m in zip(batch.fields[rm], batch.mask[rm]):
            assert set(row_f[row_m > 0].tolist()) == set(range(6))
    assert 0.1 < np.mean(labels) < 0.9
    gids = {int(tok.split(":")[1]) for ln in lines for tok in ln.split("\t")[1].split(" ")}
    assert set(np.flatnonzero(seen).tolist()) == gids


def _cli(main, argv, cwd):
    """(rc, stdout, stderr) of a CLI main run in `cwd`."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


GEN_ARGV = {
    "rows_zipf_ffm": ["--shards", "2", "--rows", "90", "--fields", "5", "--ids-per-field", "30",
                      "--zipf-alpha", "1.05", "--truth", "ffm", "--seed", "2"],
    "bulk_zipf": ["--bulk", "--shards", "1", "--rows", "400", "--fields", "18",
                  "--ids-per-field", "2000", "--zipf-alpha", "1.05", "--truth-seed", "11"],
    "bulk_ffm_refused": ["--bulk", "--truth", "ffm", "--rows", "10"],
}


@pytest.mark.parametrize("case", sorted(GEN_ARGV))
def test_gen_data_cli_matches_jax(tmp_path, case):
    got = {}
    for side, main in (("t", tmain), ("j", jmain)):
        d = tmp_path / side
        d.mkdir()
        got[side] = _cli(main, ["gen-data", "data", *GEN_ARGV[case]], d)
    assert got["t"] == got["j"]
    rc, out, _ = got["t"]
    if case == "bulk_ffm_refused":
        assert rc == 2 and out == ""
        return
    assert rc == 0
    for name in out.split():
        assert _read(tmp_path / "t" / name) == _read(tmp_path / "j" / name)


def _sparse(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    a[rng.random(shape[0]) < 0.7] = 0.0  # most slots untouched
    return a


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A fused FM checkpoint (wv [S, 1+k]) at step 3 over step 1, and a
    two-table one (w [S], v [S, k])."""
    root = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(0)
    S, k = 256, 4
    fused, two = str(root / "fused"), str(root / "two")
    wv = _sparse(rng, (S, 1 + k))
    tckpt.save_tables(fused, {"wv": _sparse(rng, (S, 1 + k))}, 1)
    tckpt.save_tables(fused, {"wv": wv}, 3)
    w = _sparse(rng, (S, 1))[:, 0]
    tckpt.save_tables(two, {"w": w, "v": _sparse(rng, (S, k))}, 2)
    return {"fused": fused, "two": two, "root": root}


@pytest.mark.parametrize("ck,table", [("fused", "w"), ("fused", "v"), ("fused", "wv"),
                                      ("fused", "z"), ("two", "w"), ("two", "v"),
                                      ("two", "wv")])
def test_export_cli_matches_jax(checkpoints, tmp_path, ck, table):
    got = {}
    for side, main in (("t", tmain), ("j", jmain)):
        d = tmp_path / side
        d.mkdir()
        got[side] = _cli(main, ["export", checkpoints[ck], "--table", table, "--out", "x.tsv"], d)
    assert got["t"] == got["j"]
    rc, out, _ = got["t"]
    if (ck, table) in (("fused", "z"), ("two", "wv")):
        assert rc == 1 and out == ""
        return
    assert rc == 0 and '"nonzero"' in out
    assert _read(tmp_path / "t" / "x.tsv") == _read(tmp_path / "j" / "x.tsv")
    if (ck, table) == ("fused", "w"):
        rows = open(tmp_path / "t" / "x.tsv").read().splitlines()
        assert rows and all(len(r.split("\t")) == 2 for r in rows)  # column 0 only


def test_export_without_a_checkpoint_matches_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    got = [_cli(main, ["export", str(tmp_path / "empty"), "--out", "x"], tmp_path)
           for main in (tmain, jmain)]
    assert got[0] == got[1] and got[0][0] == 1


@pytest.mark.parametrize("log2,salt", [(8, 0), (12, 0), (10, 77)])
def test_collisions_cli_matches_jax(tmp_path, log2, salt):
    paths = jgenerate_shards(str(tmp_path / "c"), 2, 150, num_fields=6, ids_per_field=60,
                             zipf_alpha=1.05)
    argv = ["collisions", *paths, "--log2-slots", str(log2), "--salt", str(salt)]
    t, j = _cli(tmain, argv, tmp_path), _cli(jmain, argv, tmp_path)
    assert t == j and t[0] == 0


def test_slots_of_matches_jax():
    keys = np.random.default_rng(1).integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2)
    for log2 in (1, 14, 22, 30):
        np.testing.assert_array_equal(slots_of(keys, log2), jslots_of(keys, log2))
