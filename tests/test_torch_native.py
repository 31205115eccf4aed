"""PyTorch port, the native host data plane (`xflow_tpu_torch/data/native.py`
over its copy of `native/parser.cc`) against the JAX package's and against
the port's own plain versions, bitwise:

- batches of the sequential and MT parsers (1, 2 and 4 threads over 4 KiB
  blocks) equal the JAX package's native batches and the port's Python
  parser's, on a shard with malformed rows (feature-less rows, bad tokens
  and field ids, blank and label-only lines, CRLF, rows cut to max_nnz,
  an unterminated last line);
- the row counters agree with the JAX package's;
- the native plan, its wire form and the pooled stacked plans (NS 1, 2, 4,
  with and without fields) equal `plan_sorted_plain` and the JAX plans;
- an out-of-range slot and a table off the window grid raise, a failed
  build raises with g++'s message, and the pipeline never falls back to
  the Python parser.
"""

import os

import numpy as np
import pytest

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data import native as jnative
from xflow_tpu.data.libffm import count_rows as jcount_rows
from xflow_tpu.data.pipeline import batch_iterator as jbatch_iterator
from xflow_tpu.data.pipeline import count_batches as jcount_batches
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data import native, pipeline
from xflow_tpu_torch.data.libffm import count_rows, iter_examples
from xflow_tpu_torch.data.synth import generate_shards
from xflow_tpu_torch.hashing import fnv1a64, slot_of
from xflow_tpu_torch.ops import sorted_table as tst

LOG2_S, NF, NNZ, B = 14, 8, 8, 256
S = 1 << LOG2_S
ROWS = 3000
EDGE = (
    b"1\tfoo bar\n"  # a labeled row with no valid feature: kept, mask all 0
    b"0\t0:5:1\r\n"  # CRLF
    b"1\t0:7:1\t1:8:1\n"  # tab-separated tokens
    b"junk\t0:9:1 nocolon :15:1\n"  # junk label -> 0, a token without ':', an empty field id
    b"1 \n"  # a label with trailing space: not a row
    b"\n   \n"  # blank lines
    b"1\tabc:77:1 3x:12:1 2.9:13:1 inf:16:1 nan:17:1 1e300:18:1 0x10:20:1 1_0:21:1\n"
    b"0\t" + b" ".join(b"%d:%d:1" % (i % NF, 1000 + i) for i in range(20)) + b"\n"  # cut to 8
)


def _shard(tmp_path):
    """A shard of ROWS synthetic rows with EDGE spliced in every 700 lines
    and an unterminated last line; returns its path."""
    (path,) = generate_shards(str(tmp_path / "raw"), 1, ROWS, num_fields=NF,
                              ids_per_field=300, seed=5)
    lines = open(path, "rb").read().splitlines(keepends=True)
    out = b"".join(EDGE + b"".join(lines[i:i + 700]) for i in range(0, len(lines), 700))
    p = str(tmp_path / "edge-00000")
    with open(p, "wb") as f:
        f.write(out + b"0.5\t1:3:1")
    return p


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """4 KiB parser blocks, so the 3,000-row shard spans many of them."""
    monkeypatch.setattr(native, "BLOCK_BYTES", 4096)


def _pairs(**extra):
    return {"data.log2_slots": LOG2_S, "data.max_nnz": NNZ, "data.batch_size": B, **extra}


def _tcfg(**extra):
    return override(Config(), **_pairs(**extra)).data


def _jcfg(**extra):
    return joverride(JConfig(), **_pairs(**{"data.block_bytes": 4096, **extra})).data


def _python_batches(path):
    """The port's Python parser, batched: the plain version."""
    return list(pipeline.examples_to_batches(iter_examples(path, LOG2_S), B, NNZ))


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in ("slots", "fields", "mask", "labels", "row_mask"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_native_batches_equal_jax_native_and_python_parser(tmp_path, threads):
    path = _shard(tmp_path)
    pipeline.reset_host_calls()
    got = list(pipeline.batch_iterator(path, _tcfg(**{"data.parser_threads": threads})))
    calls = pipeline.host_calls()
    assert calls["native_stream"] == len(got) and calls["python_rows"] == 0
    want_jax = list(jnative.native_batch_iterator(
        path, _jcfg(**{"data.parser_threads": threads}), B))
    python = _python_batches(path)
    assert pipeline.host_calls()["python_rows"] == sum(b.num_rows for b in python)
    _same_batches(got, want_jax)
    _same_batches(got, python)
    assert sum(b.num_rows for b in got) == count_rows(path)
    # the malformed rows are where they should be: a feature-less row, a
    # row cut to max_nnz, and the unterminated last line
    assert got[0].mask[0].sum() == 0 and got[0].row_mask[0] == 1.0
    assert (got[0].mask.sum(1) == NNZ).any()
    last = got[-1]
    assert last.labels[last.num_rows - 1] == 1.0 and last.mask[last.num_rows - 1].sum() == 1


def test_native_stream_counts_truncation(tmp_path, capsys):
    path = _shard(tmp_path)
    stream = native._NativeBatchStream(path, _tcfg(**{"data.parser_threads": 4}), B)
    list(stream)
    jstream = jnative._NativeBatchStream(path, _jcfg(**{"data.parser_threads": 4}), B)
    list(jstream)
    assert stream.closed and stream.truncated == jstream.truncated == 5 * (20 - NNZ)
    assert "truncated by data.max_nnz=8" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="single-use"):
        iter(stream)


def test_padded_tail_and_missing_file(tmp_path):
    path = _shard(tmp_path)
    cfg = _tcfg(**{"data.parser_threads": 2})
    got = list(pipeline.batch_iterator(path, cfg))
    want = list(jbatch_iterator(path, _jcfg(**{"data.parser_threads": 2})))
    _same_batches(got, want)
    assert all(b.num_rows == B for b in got[:-1]) and 0 < got[-1].num_rows < B
    assert got[-1].row_mask[got[-1].num_rows:].sum() == 0
    assert len(got) == pipeline.count_batches(path, cfg)
    with pytest.raises(FileNotFoundError):
        native.native_batch_iterator(str(tmp_path / "missing-00000"), cfg, B)


def test_count_rows_equal_jax(tmp_path):
    path = _shard(tmp_path)
    n = count_rows(path)
    assert n == jcount_rows(path) == native.native_count_rows(path)
    assert n == jnative.native_count_rows(path, 4096)
    for use_native in (True, False):  # the JAX package's two counters
        jcfg = _jcfg(**{"data.use_native_parser": use_native})
        assert pipeline.count_batches(path, _tcfg()) == jcount_batches(path, jcfg) == -(-n // B)
    # the C hash and slot fold agree with hashing.py (and the JAX package's)
    for tok, salt in ((b"abc", 7), (b"1000", 0), ("é".encode(), 3)):
        key = native.native_hash(tok, salt)
        assert key == fnv1a64(tok, salt) == jnative.native_hash(tok, salt)
        assert native.native_slot(key, LOG2_S) == slot_of(key, LOG2_S)


def _batch(seed, rows=B, fields_hi=NF):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, (rows, NNZ)).astype(np.int32)
    slots[:4] = slots[40:44]  # repeated slots: the sort must stay stable
    slots[5, 0] = S - 1
    mask = (rng.random((rows, NNZ)) < 0.8).astype(np.float32)
    mask[-3:] = 0.0
    fields = rng.integers(0, fields_hi, (rows, NNZ)).astype(np.int32)
    return slots, mask, fields


def _same_plan(got, want, names=("sorted_slots", "sorted_row", "sorted_mask", "win_off",
                                 "sorted_fields")):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("with_fields", [False, True])
def test_native_plan_equals_plain_and_jax(monkeypatch, with_fields):
    slots, mask, fields = _batch(1)
    f = fields if with_fields else None
    native.reset_calls()
    got = tst.plan_sorted_batch(slots, mask, S, fields=f)
    assert native.CALLS["plan"] == 1
    _same_plan(got, tst.plan_sorted_plain(slots, mask, S, fields=f))
    ss, row, m, jf, off = jnative.native_plan_sorted(slots, mask, f, S, tst.WINDOW,
                                                     tst.padded_len(slots.size))
    _same_plan(got, tst.SortedPlan(ss, row, m, off, jf))
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)
    monkeypatch.setenv("XFLOW_NO_NATIVE_PLAN", "1")
    _same_plan(got, jst.plan_sorted_batch(slots, mask, S, fields=f))
    monkeypatch.setattr(jst, "_NATIVE_PLAN", None)


@pytest.mark.parametrize("with_fields", [False, True])
def test_native_wire_plan_equals_compacted_plain_and_jax(with_fields):
    slots, mask, fields = _batch(2)
    f = fields if with_fields else None
    got = tst.plan_sorted_batch(slots, mask, S, fields=f, wire=True)
    assert got.sorted_row.dtype == np.uint16 and got.sorted_mask.dtype == np.uint8
    plain = tst.plan_sorted_plain(slots, mask, S, fields=f)
    arrays = {k: v for k, v in plain._asdict().items() if v is not None}
    want = tst.compact_plan_wire(arrays, rows_bound=B, fields_bound=NF if with_fields else 0)
    _same_plan(got, tst.SortedPlan(**want))
    jgot = jst.plan_sorted_batch(slots, mask, S, fields=f, wire=True)
    _same_plan(got, jgot)
    # compact arrays pass compact_plan_wire untouched
    again = tst.compact_plan_wire(got._asdict(), rows_bound=B,
                                  fields_bound=NF if with_fields else 0)
    for k, v in got._asdict().items():
        assert again[k] is v, k


@pytest.mark.parametrize("ns", [1, 2, 4])
@pytest.mark.parametrize("with_fields", [False, True])
@pytest.mark.parametrize("wire", [False, True])
def test_pooled_stacked_plans_equal_plain_and_jax(ns, with_fields, wire):
    slots, mask, fields = _batch(10 + ns)
    f = fields if with_fields else None
    native.reset_calls()
    got = tst.plan_sorted_stacked(slots, mask, S, fields=f, num_sub=ns, always_stack=True,
                                  wire=wire)
    assert native.CALLS["plan"] == ns
    bs = B // ns
    subs = []
    for i in range(ns):
        p = tst.plan_sorted_plain(slots[i * bs:(i + 1) * bs], mask[i * bs:(i + 1) * bs], S,
                                  fields=None if f is None else f[i * bs:(i + 1) * bs])
        a = {k: v for k, v in p._asdict().items() if v is not None}
        if wire:
            a = tst.compact_plan_wire(a, rows_bound=bs, fields_bound=NF if with_fields else 0)
        subs.append(a)
    want = tst.SortedPlan(**{k: np.stack([a[k] for a in subs]) for k in subs[0]})
    _same_plan(got, want)
    _same_plan(got, jst.plan_sorted_stacked(slots, mask, S, fields=f, num_sub=ns,
                                            always_stack=True, wire=wire))
    assert (got.win_off[:, -1] == got.sorted_slots.shape[1]).all()


def test_pool_runs_plans_in_order_on_threads():
    import threading

    seen = []

    def fn(i):
        seen.append(threading.current_thread().name)
        return i * i

    assert tst.map_host_parallel(fn, 6) == [0, 1, 4, 9, 16, 25]
    assert all(name.startswith("xflow-plan") for name in seen)
    assert tst.map_host_parallel(fn, 1) == [0]
    assert tst._plan_pool() is tst._plan_pool()


def test_plan_counter_loses_no_update_on_the_pool():
    """More concurrent plans than cores, with a short switch interval: the
    native planner's call count must see every one."""
    import sys

    slots, mask, _ = _batch(8, rows=64)
    n = 8 * max(len(os.sched_getaffinity(0)), 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        native.reset_calls()
        plans = tst.map_host_parallel(lambda i: tst.plan_sorted_batch(slots, mask, S), n)
    finally:
        sys.setswitchinterval(old)
    assert native.CALLS["plan"] == n and len(plans) == n
    for p in plans[1:]:
        _same_plan(p, plans[0])


@pytest.mark.parametrize("bad", [S, -1])
def test_plan_rejects_out_of_range_slot(bad):
    slots, mask, fields = _batch(3)
    slots[7, 2] = bad
    for fn in (tst.plan_sorted_batch, tst.plan_sorted_plain):
        with pytest.raises(ValueError, match="out of range"):
            fn(slots, mask, S)
    with pytest.raises(ValueError, match="out of range"):
        tst.plan_sorted_batch(slots, mask, S, wire=True)


def test_wire_plan_refuses_a_batch_over_its_bounds():
    slots, mask, fields = _batch(4, fields_hi=300)
    with pytest.raises(ValueError, match="wire contract"):
        tst.plan_sorted_batch(slots, mask, S, fields=fields, wire=True)
    half = mask * np.float32(0.5)
    with pytest.raises(ValueError, match="wire contract"):
        tst.plan_sorted_batch(slots, half, S, wire=True)


def test_plan_of_a_table_off_the_window_grid_raises():
    slots, mask, _ = _batch(6)
    odd = S + 8  # not a multiple of WINDOW, which every plan kernel refuses
    native.reset_calls()
    with pytest.raises(ValueError, match="not a multiple of WINDOW"):
        tst.plan_sorted_batch(slots, mask, odd)
    with pytest.raises(ValueError, match="not a multiple of WINDOW"):
        tst.plan_sorted_stacked(slots, mask, odd, num_sub=2)
    assert native.CALLS["plan"] == 0


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "parser.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build") as ei:
        native.get_lib()
    assert "error" in str(ei.value)
    assert not [p for p in os.listdir(tmp_path / "_build")]  # no temp file left
    # no fall back: the pipeline and the planner raise too
    (path,) = generate_shards(str(tmp_path / "s"), 1, 10, num_fields=NF, ids_per_field=30)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list(pipeline.batch_iterator(path, _tcfg()))
    slots, mask, _ = _batch(7)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tst.plan_sorted_batch(slots, mask, S)


def test_parser_threads_resolve_to_the_usable_cores():
    cores = len(os.sched_getaffinity(0))
    assert native.resolve_threads(0) == max(1, min(cores, native.MAX_THREADS))
    assert native.resolve_threads(3) == 3
    assert _tcfg().parser_threads == 0  # the default: one thread a usable core
