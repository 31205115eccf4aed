"""PyTorch port, the `.xfc` packed shard cache (`xflow_tpu_torch/data/
shardcache.py`) against the JAX package's:

- a cache the port writes is byte-identical to the JAX package's for the
  same shard and config, and each package reads the other's cache into
  batches bitwise equal to its own text batches;
- a flipped byte is caught by its section digest, quarantined with the
  JAX package's record, and the shard is read as text;
- a stale cache raises under `data.cache=on` and is passed over under
  "auto"; a missing one raises under "on";
- `criteo_convert cache` packs shards and skips fresh caches.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data import shardcache as jsc
from xflow_tpu.data.pipeline import batch_iterator as jbatch_iterator
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data import pipeline
from xflow_tpu_torch.data import shardcache as tsc
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.tools import criteo_convert

NF, B = 6, 64
CASES = {  # name: data.* overrides; max_nnz 4 cuts every row
    "plain": {"data.log2_slots": 12, "data.max_nnz": 8},
    "cut_salted": {"data.log2_slots": 14, "data.max_nnz": 4, "data.hash_salt": 7},
}


def _shard(tmp_path, name="train", rows=300):
    prefix = str(tmp_path / name)
    (path,) = generate_shards(prefix, 1, rows, num_fields=NF, ids_per_field=50, seed=2)
    with open(path, "a") as f:  # feature-less rows and a bad token ride in the cache too
        f.write("1\tfoo\n0\t1:2:1 junk 3:4:1\n")
    return prefix, path


def _tcfg(case="plain", **extra):
    return override(Config(), **{"data.batch_size": B, **CASES[case], **extra}).data


def _jcfg(case="plain", **extra):
    return joverride(JConfig(), **{"data.batch_size": B, **CASES[case], **extra}).data


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in ("slots", "fields", "mask", "labels", "row_mask"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "run_id")} for r in records]


def _read(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_bytes_equal_jax_and_each_reads_the_other(tmp_path, case):
    prefix, path = _shard(tmp_path)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    st = tsc.build_cache(prefix, _tcfg(case, **{"data.cache_dir": tdir}))
    sj = jsc.build_cache(prefix, _jcfg(case, **{"data.cache_dir": jdir}))
    assert st == sj and st["shards"] == 1 and st["rows"] == 302
    tpath = tsc.cache_path_for(path, tdir)
    jpath = jsc.cache_path_for(path, jdir)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()

    text = list(pipeline.batch_iterator(path, _tcfg(case, **{"data.cache": "off"})))
    jtext = list(jbatch_iterator(path, _jcfg(case, **{"data.cache": "off"})))
    _same_batches(text, jtext)
    tsc.reset_calls()
    # the port reads the JAX cache, the JAX package reads the port's
    from_jax = list(pipeline.batch_iterator(path, _tcfg(case, **{
        "data.cache": "on", "data.cache_dir": jdir})))
    assert tsc.CALLS["batches"] == len(text)
    from_port = list(jbatch_iterator(path, _jcfg(case, **{
        "data.cache": "on", "data.cache_dir": tdir})))
    _same_batches(from_jax, text)
    _same_batches(from_port, text)
    assert isinstance(from_jax[0].slots, np.memmap)  # a full batch is a view


def test_writer_is_byte_stable_and_build_skips_fresh_caches(tmp_path):
    prefix, path = _shard(tmp_path)
    cfg = _tcfg()
    first = tsc.build_cache(prefix, cfg)
    blob = open(tsc.cache_path_for(path), "rb").read()
    assert tsc.build_cache(prefix, cfg) == {"shards": 0, "rows": 0, "bytes": 0, "skipped": 1}
    forced = tsc.build_cache(prefix, cfg, force=True)
    assert forced == first and open(tsc.cache_path_for(path), "rb").read() == blob
    sc = tsc.open_shard_cache(tsc.cache_path_for(path))
    sc.verify()
    assert sc.rows == 302 and sc.max_nnz == 8
    assert set(sc.arrays()) == set(tsc.SECTIONS)


def test_cache_tail_batch_equals_the_texts(tmp_path):
    prefix, path = _shard(tmp_path)
    tsc.build_cache(prefix, _tcfg())
    cfg = _tcfg()
    cached = list(pipeline.batch_iterator(path, dataclasses.replace(cfg, cache="on")))
    text = list(pipeline.batch_iterator(path, dataclasses.replace(cfg, cache="off")))
    _same_batches(cached, text)
    assert len(cached) == -(-302 // B) and cached[-1].num_rows == 302 % B


def test_flipped_byte_is_quarantined_and_falls_back_to_text(tmp_path):
    prefix, path = _shard(tmp_path)
    tsc.build_cache(prefix, _tcfg())
    cpath = tsc.cache_path_for(path)
    with open(cpath, "r+b") as f:
        f.seek(100)  # inside the slots section (it starts at 64)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(tsc.ShardCacheDigestError, match="slots") as ei:
        tsc.open_shard_cache(cpath).verify()
    assert ei.value.section == "slots"
    text = list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "off"})))
    tq, jq = str(tmp_path / "tq.jsonl"), str(tmp_path / "jq.jsonl")
    tsc.reset_calls()
    got = list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "on",
                                                       "data.quarantine_path": tq})))
    assert tsc.CALLS["batches"] == 0
    _same_batches(got, text)
    list(jbatch_iterator(path, _jcfg(**{"data.cache": "on", "data.quarantine_path": jq})))
    recs = _read(tq)
    assert recs[0]["reason"] == "cache_digest_mismatch" and recs[0]["section"] == "slots"
    assert recs[0]["cache"] == cpath
    assert _strip(recs) == _strip(_read(jq))


@pytest.mark.parametrize("damage", ["truncated", "garbage", "bad_magic"])
def test_unreadable_cache_falls_back_to_text(tmp_path, damage):
    prefix, path = _shard(tmp_path, rows=100)
    tsc.build_cache(prefix, _tcfg())
    cpath = tsc.cache_path_for(path)
    blob = open(cpath, "rb").read()
    payload = {"truncated": blob[: len(blob) // 2], "garbage": b"not a cache file at all",
               "bad_magic": b"XXXX" + blob[4:]}[damage]
    open(cpath, "wb").write(payload)
    with pytest.raises(tsc.ShardCacheError):
        tsc.open_shard_cache(cpath).verify()
    q = str(tmp_path / "q.jsonl")
    got = list(pipeline.batch_iterator(path, _tcfg(**{"data.quarantine_path": q})))
    _same_batches(got, list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "off"}))))
    recs = _read(q)  # the cache's record, then the text's feature-less row
    assert [r.get("reason") for r in recs] == ["cache_unreadable", None]
    assert recs[1]["row"] == 100 % B and recs[1]["label"] == 1.0


def test_stale_cache_raises_under_on_and_is_passed_over_under_auto(tmp_path, capsys):
    prefix, path = _shard(tmp_path)
    tsc.build_cache(prefix, _tcfg())
    other = {"data.log2_slots": 13}
    with pytest.raises(tsc.ShardCacheStale, match="log2_slots"):
        list(pipeline.batch_iterator(path, _tcfg(**other, **{"data.cache": "on"})))
    tsc.reset_calls()
    got = list(pipeline.batch_iterator(path, _tcfg(**other)))
    assert tsc.CALLS["batches"] == 0
    assert "ignoring stale shard cache" in capsys.readouterr().err
    _same_batches(got, list(pipeline.batch_iterator(path, _tcfg(**other, **{
        "data.cache": "off"}))))
    with open(path, "a") as f:  # the source changed
        f.write("1\t0:1:1\n")
    with pytest.raises(tsc.ShardCacheStale, match="text shard changed"):
        list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "on"})))


def test_missing_cache_under_on_raises_and_bad_mode_is_refused(tmp_path):
    _, path = _shard(tmp_path, rows=50)
    with pytest.raises(FileNotFoundError, match="criteo_convert cache"):
        list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "on"})))
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        list(pipeline.batch_iterator(path, _tcfg(**{"data.cache": "sometimes"})))


def test_criteo_convert_cache_subcommand(tmp_path, capsys):
    prefix, path = _shard(tmp_path)
    generate_shards(str(tmp_path / "train"), 2, 40, num_fields=NF, ids_per_field=50)
    args = ["cache", prefix, "--log2-slots", "12", "--max-nnz", "8"]
    assert criteo_convert.main(args) == 0
    stats = json.loads(capsys.readouterr().out.strip())
    assert stats["shards"] == 2 and stats["skipped"] == 0 and stats["rows"] == 80
    assert criteo_convert.main(args) == 0
    assert json.loads(capsys.readouterr().out.strip())["skipped"] == 2
    assert os.path.exists(path + ".xfc")
    # without `cache` the argv is the raw converter's, which needs OUT_PREFIX
    with pytest.raises(SystemExit) as e:
        criteo_convert.main([prefix])
    assert e.value.code == 2
