"""PyTorch port, the batch pipeline (`xflow_tpu_torch/data/pipeline.py`)
against the JAX package's, and the trainer reading through it:

- `monitor_bad_rows` counts and quarantines the JAX package's rows, with
  its records, and raises at the same budget;
- `skip_batches` resumes at the JAX package's batch;
- dropping a `prefetch` generator closes its native parser handle, and a
  worker's exception reaches the consumer;
- `Trainer.fit` on the CPU gives identical losses and tables through the
  native parser, the `.xfc` cache and the Python parser (put in the
  native stream's place), for FM and MVM's
  segment row side, and evaluate neither raises on nor quarantines bad
  rows.
"""

import json
import threading

import numpy as np
import pytest

from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data import pipeline as jpipeline
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data import native, pipeline
from xflow_tpu_torch.data.libffm import iter_examples
from xflow_tpu_torch.data.shardcache import build_cache
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.evaluate import evaluate
from xflow_tpu_torch.train.trainer import Trainer

LOG2_S, B, NNZ, V, NF = 14, 64, 8, 4, 8
ROWS = 200  # three full batches and a padded one
BAD = "1\tnothing here\n0\tjunk tokens only\n"


def _shard(tmp_path, rows=ROWS, bad_every=0):
    """`<tmp>/d-00000`: synthetic rows, with two feature-less rows after
    every `bad_every` rows when it is set."""
    prefix = str(tmp_path / "d")
    (path,) = generate_shards(prefix, 1, rows, num_fields=NF, ids_per_field=60, seed=4)
    if bad_every:
        lines = open(path).read().splitlines(keepends=True)
        with open(path, "w") as f:
            for i in range(0, len(lines), bad_every):
                f.write("".join(lines[i:i + bad_every]) + BAD)
    return prefix, path


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """4 KiB parser blocks, the JAX side's `data.block_bytes` below."""
    monkeypatch.setattr(native, "BLOCK_BYTES", 4096)


def _pairs(**extra):
    return {"data.log2_slots": LOG2_S, "data.max_nnz": NNZ, "data.batch_size": B,
            "data.parser_threads": 2, **extra}


def _jconfig(**pairs):
    return joverride(JConfig(), **pairs, **{"data.block_bytes": 4096})


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "run_id")} for r in records]


def _read(path):
    return [json.loads(line) for line in open(path)]


def test_monitor_counts_and_quarantine_records_match_jax(tmp_path, capsys):
    _, path = _shard(tmp_path, bad_every=70)
    tq, jq = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    before = pipeline.COUNTERS["quarantined_rows"]
    got = list(pipeline.batch_iterator(
        path, override(Config(), **_pairs(**{"data.quarantine_path": tq})).data))
    want = list(jpipeline.batch_iterator(
        path, _jconfig(**_pairs(**{"data.quarantine_path": jq})).data))
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    recs = _read(tq)
    assert len(recs) == 6 and pipeline.COUNTERS["quarantined_rows"] - before == 6
    assert _strip(recs) == _strip(_read(jq))
    assert {r["rank"] for r in recs} == {0} and {r["world"] for r in recs} == {1}
    assert sum(len(pipeline.bad_row_indices(b)) for b in got) == 6
    assert "6 row(s) parsed to zero features" in capsys.readouterr().err


@pytest.mark.parametrize("budget", [0, 3])
def test_bad_row_budget_raises_where_jax_raises(tmp_path, budget):
    _, path = _shard(tmp_path, bad_every=70)
    pairs = _pairs(**{"data.max_bad_rows": budget})
    with pytest.raises(pipeline.BadRecordError, match=f"max_bad_rows={budget}"):
        list(pipeline.batch_iterator(path, override(Config(), **pairs).data))
    with pytest.raises(jpipeline.BadRecordError):
        list(jpipeline.batch_iterator(path, _jconfig(**pairs).data))
    # an eval pass counts and warns, never raises, never quarantines
    q = tmp_path / "q.jsonl"
    cfg = override(Config(), **pairs, **{"data.quarantine_path": str(q)}).data
    n = len(list(pipeline.batch_iterator(path, cfg, enforce_bad_rows=False, quarantine=False)))
    assert n == 4 and not q.exists()


@pytest.mark.parametrize("skip", [1, 2, 4])
def test_skip_batches_resumes_at_the_jax_batch(tmp_path, skip):
    _, path = _shard(tmp_path)
    cfg = override(Config(), **_pairs()).data
    every = list(pipeline.batch_iterator(path, cfg))
    rest = list(pipeline.batch_iterator(path, cfg, skip=skip))
    jrest = list(jpipeline.batch_iterator(path, _jconfig(**_pairs()).data,
                                          skip=skip))
    assert len(rest) == len(jrest) == len(every) - skip
    for a, b, c in zip(rest, jrest, every[skip:]):
        assert a.slots.tobytes() == b.slots.tobytes() == c.slots.tobytes()
        assert a.row_mask.tobytes() == b.row_mask.tobytes() == c.row_mask.tobytes()


def test_dropping_a_prefetch_generator_closes_the_native_handle(tmp_path):
    _, path = _shard(tmp_path, rows=2000)
    cfg = override(Config(), **_pairs()).data
    stream = native._NativeBatchStream(path, cfg, 16)
    gen = pipeline.prefetch(iter(stream), depth=1)
    first = next(gen)
    assert first.num_rows == 16 and not stream.closed
    gen.close()  # the consumer drops the stream mid-epoch
    assert stream.closed
    assert not [t for t in threading.enumerate() if t.name == "xflow-prefetch"]


def test_prefetch_raises_the_workers_error_and_keeps_order():
    def items():
        yield from range(5)
        raise OSError("disk went away")

    got = []
    with pytest.raises(OSError, match="disk went away"):
        for x in pipeline.prefetch(items()):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert list(pipeline.prefetch(iter(range(7)), depth=3)) == list(range(7))


FIT_CASES = {
    "fm": {"model.name": "fm"},
    "mvm_segment": {"model.name": "mvm", "model.mvm_exclusive": "off",
                    "data.sorted_sub_batches": 2, "model.mvm_plus_one": True},
}


def _python_stream(path, cfg, batch_size):
    """The Python parser where the pipeline reads the native stream."""
    return pipeline.examples_to_batches(
        iter_examples(path, cfg.log2_slots, cfg.hash_salt), batch_size, cfg.max_nnz)


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_is_identical_through_native_text_cache_and_python(tmp_path, case, monkeypatch):
    prefix, path = _shard(tmp_path)
    build_cache(prefix, override(Config(), **_pairs()).data)
    base = _pairs(**{"model.v_dim": V, "model.num_fields": NF, "train.epochs": 2,
                     "train.log_every": 0, "data.train_path": prefix, **FIT_CASES[case]})
    routes = {
        "native": {"data.cache": "off"},
        "cache": {"data.cache": "on"},
        "python": {"data.cache": "off"},
    }
    out = {}
    for route, extra in routes.items():
        if route == "python":
            monkeypatch.setattr(native, "native_batch_iterator", _python_stream)
        pipeline.reset_host_calls()
        trainer = Trainer(override(Config(), **base, **extra), device="cpu")
        res = trainer.fit()
        calls = pipeline.host_calls()
        out[route] = (res, {k: v.numpy() for k, v in trainer.state.tables.items()},
                      {k: {n: a.numpy() for n, a in d.items()}
                       for k, d in trainer.state.opt_state.items()})
        assert res.steps == 8 and res.examples == 2 * ROWS and np.isfinite(res.last_loss)
        assert calls["native_plan"] == 8 * (2 if case == "mvm_segment" else 1)
        assert (calls["native_stream"] > 0) == (route == "native")
        assert (calls["cache_batches"] > 0) == (route == "cache")
        assert (calls["python_rows"] > 0) == (route == "python")
    res0, tables0, opt0 = out["native"]
    for route in ("cache", "python"):
        res, tables, opt = out[route]
        assert res.last_loss == res0.last_loss, route
        for name, t in tables.items():
            assert t.tobytes() == tables0[name].tobytes(), (route, name)
        for name, d in opt.items():
            for leaf, a in d.items():
                assert a.tobytes() == opt0[name][leaf].tobytes(), (route, name, leaf)


def test_evaluate_neither_raises_on_nor_quarantines_bad_rows(tmp_path):
    prefix, path = _shard(tmp_path, bad_every=70)
    q = tmp_path / "q.jsonl"
    pairs = _pairs(**{"model.name": "fm", "model.v_dim": V, "model.num_fields": NF,
                      "train.epochs": 1, "train.log_every": 0, "data.train_path": prefix,
                      "data.quarantine_path": str(q), "data.max_bad_rows": 100})
    trainer = Trainer(override(Config(), **pairs), device="cpu")
    trainer.fit()
    assert len(_read(q)) == 6  # the training pass quarantines
    ecfg = override(Config(), **{**pairs, "data.max_bad_rows": 0})
    auc, ll = evaluate(ecfg, trainer.state.tables, path, device="cpu")
    assert np.isfinite(auc) and np.isfinite(ll)
    assert len(_read(q)) == 6
