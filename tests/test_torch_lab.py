"""PyTorch port, the Hopper lab (`xflow_tpu_torch/tools/bench_lab.py`,
`xflow_tpu_torch/ops/lab.py`) on the CPU, against what the JAX lab's own
suites check against: the JAX kernels #7-#11 are closures compiled only
for the TPU, so the plain versions are held against the numpy slices and
``2 * table`` (`suite_mosaic`), `np.add.at` and `jax.ops.segment_sum`
(`suite_rowsum`). The CLI's core record has the JAX record's keys; the
windowed scatter's host planner is bit-identical to the JAX one.

Tolerances: the slice probes bitwise (copies); the row sums within 1e-4
relative over a 1e-2 floor and within the float32 reorder bound
(`reorder_err` < 1): at B 512, Np 8,192 a row sums 16 unit-scale terms,
and `np.add.at` itself is more than 1e-5 from the exact float64 sum over
that floor (seeds 0 and 1), so 1e-5 would fail any summation order but numpy's
own.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.tools import bench_lab as jlab
from xflow_tpu_torch.ops import lab
from xflow_tpu_torch.tools import bench_lab

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, FLOOR = 1e-4, 1e-2
W, C, K, S, N, GRID = 512, 512, 11, 1 << 14, 1 << 13, 4  # suite_mosaic's shapes


def _probe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "table": rng.standard_normal((S, K), dtype=np.float32),
        "d_t": rng.standard_normal((K, N), dtype=np.float32),
        "sl": rng.integers(-(1 << 31), 1 << 31, (1, N)).astype(np.int32),
        "d_rows": rng.standard_normal((N, K), dtype=np.float32),
        "off": rng.integers(1, N - C + 1, S // W + 1).astype(np.int32),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def test_plain_block_scale_is_twice_the_table():
    x = _probe_inputs()
    got = lab.block_scale(_t(x["table"]), W, 2.0)
    assert torch.equal(got, _t(x["table"] * np.float32(2.0)))
    with pytest.raises(ValueError, match="blocks"):
        lab.block_scale(_t(x["table"][:-1]), W)


@pytest.mark.parametrize("key", ["d_t", "sl"])
def test_plain_col_slices_match_numpy_slices(key):
    x = _probe_inputs(1)
    src, off = x[key], x["off"]
    assert (off[:GRID] // C > 0).any(), "the slices must not all start at 0"
    tiles, scalars = lab.col_slices(_t(src), _t(off), C, GRID)
    want = np.stack([src[:, s:s + C] for s in (off[:GRID] // C) * C])
    assert tiles.dtype == _t(src).dtype and tiles.numpy().tobytes() == want.tobytes()
    assert scalars.numpy().tobytes() == want[:, 0, 0].tobytes()
    assert scalars[-1].item() == src[0, (off[GRID - 1] // C) * C]  # the TPU kernel's value


def test_plain_row_slices_match_numpy_slices():
    x = _probe_inputs(2)
    src, off = x["d_rows"], x["off"]
    assert (off[:GRID] % 4 != 0).any(), "some slice must start at an unaligned row"
    tiles, scalars = lab.row_slices(_t(src), _t(off), C, GRID)
    want = np.stack([src[o:o + C] for o in off[:GRID]])
    assert tiles.numpy().tobytes() == want.tobytes()
    assert scalars.numpy().tobytes() == want[:, 0, 0].tobytes()


def test_plain_slices_leaving_the_array_read_as_zeros():
    x = _probe_inputs(3)
    off = x["off"].copy()
    off[1], off[2] = N, -5
    for tiles, scalars in (lab.col_slices(_t(x["d_t"]), _t(off), C, GRID),
                           lab.row_slices(_t(x["d_rows"]), _t(off), C, GRID)):
        assert (tiles[1:3] == 0).all() and (scalars[1:3] == 0).all()
        assert (tiles[0] != 0).any()
    off[0] = N - C + 1  # one row too far for a row slice
    tiles, _ = lab.row_slices(_t(x["d_rows"]), _t(off), C, GRID)
    assert (tiles[0] == 0).all()


def _rowsum_case(seed=0, B=512, CH=24, Np=8192):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, B, Np).astype(np.int32)
    vals = rng.normal(size=(CH, Np)).astype(np.float32)
    return rows, vals


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + FLOOR)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_rowsum_matches_np_add_at_and_segment_sum(seed):
    rows, vals = _rowsum_case(seed)
    got = lab.lab_rowsum(_t(vals), _t(rows), 512)
    want = np.zeros((512, 24), np.float32)
    np.add.at(want, rows, vals.T)
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(vals.T), jnp.asarray(rows), num_segments=512))
    for ref in (want, seg):
        assert _rel(got.numpy(), ref) <= RTOL
        assert bench_lab.reorder_err(got, _t(ref), _t(vals), _t(rows), 512) < 1.0


def test_plain_rowsum_sums_even_and_odd_apart_and_skips_rows_out_of_range():
    rows, vals = _rowsum_case(2, B=16, Np=64)
    rows[[3, 10]] = [-1, 16]
    got = lab.rowsum_plain(_t(vals), _t(rows), 16)
    keep = (rows >= 0) & (rows < 16)
    halves = []
    for parity in (0, 1):
        sel = keep & (np.arange(64) % 2 == parity)
        h = np.zeros((16, 24), np.float32)
        for j in np.flatnonzero(sel):
            h[rows[j]] += vals[:, j]
        halves.append(h)
    assert got.numpy().tobytes() == (halves[0] + halves[1]).tobytes()


@pytest.mark.parametrize("ch, np_, num_rows, zero_share, out_share", [
    (24, 8192, 512, 0.0, 0.0),  # the suite's kind of input: every quad counts
    (24, 8192, 512, 0.3, 0.0),
    (4, 5000, 65536, 0.5, 0.1),
    (136, 2048, 512, 0.2, 0.2),
    (8, 1000, 3, 0.0, 0.5),
    (4, 1, 1, 1.0, 0.0),  # one occurrence, all zero: nothing to send
])
def test_rowsum_l2_reductions_count_nonzero_quads_in_range(ch, np_, num_rows, zero_share,
                                                         out_share):
    """#11's computed L2 reduction count: one a quad of an occurrence
    with a nonzero channel and its row in [0, num_rows)."""
    rng = np.random.default_rng(ch + np_)
    vals = rng.normal(size=(ch, np_)).astype(np.float32)
    vals[rng.random((ch, np_)) < zero_share] = 0.0
    vals[:, rng.random(np_) < zero_share / 2] = 0.0  # whole zero occurrences
    rows = rng.integers(0, num_rows, np_).astype(np.int32)
    out = rng.random(np_) < out_share
    rows[out] = np.where(rng.random(int(out.sum())) < 0.5, -1, num_rows + 7)
    quads = (vals.reshape(ch // 4, 4, np_) != 0).any(axis=1)
    want = int((quads & ((rows >= 0) & (rows < num_rows))[None, :]).sum())
    assert lab.rowsum_l2_reductions(_t(vals), _t(rows), num_rows) == want


def test_reorder_err_flags_a_lost_term():
    rows, vals = _rowsum_case(3)
    want = lab.rowsum_plain(_t(vals), _t(rows), 512)
    lost = lab.rowsum_plain(_t(vals[:, 1:]), _t(rows[1:]), 512)
    assert bench_lab.reorder_err(want, want, _t(vals), _t(rows), 512) == 0.0
    assert bench_lab.reorder_err(lost, want, _t(vals), _t(rows), 512) > 100.0


@pytest.mark.parametrize("log2_s, n, c, w", [(14, 5000, 64, 128), (12, 3000, 1024, 2048),
                                             (10, 1 << 12, 16, 32)])
def test_host_sort_plan_bitwise_equal_to_jax(log2_s, n, c, w):
    slots = np.random.default_rng(log2_s).integers(0, 1 << log2_s, n).astype(np.int32)
    got = bench_lab.host_sort_plan(slots, 1 << log2_s, c, w)
    want = jlab.host_sort_plan(slots, 1 << log2_s, c, w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_windowed_scatter_matches_index_add():
    S_, N_, K_, C_, W_ = 1 << 12, 1 << 11, 11, 64, 128
    rng = np.random.default_rng(0)
    slots = rng.integers(0, S_, N_).astype(np.int32)
    d = rng.normal(size=(N_, K_)).astype(np.float32)
    perm, srt, bases = bench_lab.host_sort_plan(slots, S_, C_, W_)
    got = bench_lab.windowed_scatter(_t(d), _t(perm), _t(srt.reshape(-1, C_)), _t(bases), S_, W_,
                                     onehot_bytes=C_ * W_ * 4 * 5)  # groups of 5 chunks
    want = torch.zeros((S_, K_)).index_add_(0, _t(slots).long(), _t(d))
    assert _rel(got.numpy(), want.numpy()) <= RTOL


def _run_lab(*args, **env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run([sys.executable, "-m", "xflow_tpu_torch.tools.bench_lab", *args],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=240, env=env)


def test_cli_core_sweep_writes_the_jax_record_keys(tmp_path):
    out = tmp_path / "BENCH_LAB_TORCH.json"
    r = _run_lab("--suite", "core", "--device", "cpu", "--table-log2", "8,9", "--nnz-log2", "7",
                 "--row-width", "4", "--iters", "1", "--inner", "2", "--round", "3",
                 "--out", str(out))
    assert r.returncode == 0, r.stderr
    d = json.loads(out.read_text())
    assert d["kind"] == "bench_lab" and d["device"] == "cpu"
    assert d["metric"] == "lab_gather_ns_per_element"
    assert d["unit"] == "ns/element" and d["value"] > 0 and d["round"] == 3
    # the full matrix: 3 ops x 2 table sizes x 1 nnz
    assert len(d["cells"]) == 6
    assert {c["op"] for c in d["cells"]} == {"gather", "scatter_add", "segment_sum"}
    assert d["headline_cell"] == "lab_gather_s9_n7_f32"
    for c in d["cells"]:
        assert c["ns_per_element"] > 0 and c["time_ms"] > 0
        assert c["bytes_accessed"] == bench_lab.core_bytes(
            c["op"], 1 << c["table_log2"], 1 << c["nnz_log2"], 4, 4)
        assert c["achieved_gbps"] > 0

    # the JAX record's keys, less the XLA cost analysis's
    jout = tmp_path / "BENCH_LAB.json"
    assert jlab.main(["--suite", "core", "--table-log2", "8,9", "--nnz-log2", "7",
                      "--row-width", "4", "--iters", "1", "--inner", "2", "--round", "3",
                      "--out", str(jout)]) == 0
    jd = json.loads(jout.read_text())
    assert set(d) == set(jd)
    assert set(d["cells"][0]) == set(jd["cells"][0]) - {"compile_time_s", "flops"}
    assert [(c["op"], c["table_log2"], c["nnz_log2"], c["dtype"]) for c in d["cells"]] == [
        (c["op"], c["table_log2"], c["nnz_log2"], c["dtype"]) for c in jd["cells"]]


def test_cli_core_default_out_is_not_the_jax_record(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bench_lab.suite_core(["--table-log2", "6", "--nnz-log2", "5", "--row-width", "2",
                          "--iters", "1", "--inner", "1", "--ops", "gather"], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["BENCH_LAB_TORCH.json"]


def test_cli_core_sweeps_bf16_cells(tmp_path):
    out = tmp_path / "b.json"
    r = _run_lab("--suite", "core", "--device", "cpu", "--table-log2", "7", "--nnz-log2", "6",
                 "--dtypes", "f32,bf16", "--ops", "gather,scatter_add", "--row-width", "2",
                 "--iters", "1", "--inner", "1", "--out", str(out))
    assert r.returncode == 0, r.stderr
    cells = json.loads(out.read_text())["cells"]
    assert [c["dtype"] for c in cells] == ["f32", "bf16", "f32", "bf16"]
    bf16 = [c for c in cells if c["dtype"] == "bf16"][0]
    assert bf16["bytes_accessed"] == bench_lab.core_bytes("gather", 1 << 7, 1 << 6, 2, 2)


@pytest.mark.parametrize("suite", ["nope", "Hostplane"])  # every JAX suite is ported
def test_cli_unknown_suite_exits_2(suite):
    r = _run_lab("--suite", suite)
    assert r.returncode == 2
    assert "invalid choice" in r.stderr


def test_hostplane_suite_runs_on_the_cpu_with_the_jax_record_keys(capsys):
    argv = ["--rows", "3000", "--batch", "1024", "--log2-slots", "12", "--num-sub", "2",
            "--caps", "1,2"]
    rec = bench_lab.suite_hostplane(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec and rec["host_cores"] >= 1
    assert all(v > 0 for k, v in rec.items() if k.endswith("w"))
    assert jlab.suite_hostplane(argv) == 0
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == set(jrec)


def test_cli_asks_for_the_card_by_default():
    r = _run_lab("--suite", "mosaic", CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_mosaic_suite_runs_on_the_cpu(capsys):
    rec = bench_lab.suite_mosaic(device="cpu", transpose_log2=10, iters=1, inner=1)
    out = capsys.readouterr().out
    assert rec["ok"] and all(rec["probes_ok"].values())
    assert any(o > 0 for o in rec["off"])
    for line in ("A block (512,11) f32: OK", "B dma [11,512] of [11,N] f32: OK",
                 "C dma [1,512] of [1,N] i32: OK", "D dma [512,11] of [N,11] f32 dyn-row: OK",
                 "not run (no CUDA device)", "E transpose [1024,11]->[11,1024]"):
        assert line in out
    assert set(rec["kernels"]) == {"a", "b", "c", "d"}
    assert all(k["ms"] > 0 and k["plain_ms"] > 0 and k["library_ms"] > 0
               and k["ms_by"] == "perf_counter" and k["host_ms"]["kernel"] == k["ms"]
               for k in rec["kernels"].values())


def test_mosaic_probe_reports_a_wrong_copy_as_fail(monkeypatch, capsys):
    monkeypatch.setattr(lab, "row_slices", lambda src, off, c, g: lab.row_slices_plain(
        src, off + 1, c, g))
    rec = bench_lab.suite_mosaic(device="cpu", transpose_log2=10, iters=1, inner=1)
    assert not rec["ok"] and rec["probes_ok"] == {"a": True, "b": True, "c": True, "d": False}
    assert "D dma [512,11] of [N,11] f32 dyn-row: FAIL" in capsys.readouterr().out


def test_rowsum_suite_runs_on_the_cpu(capsys):
    rec = bench_lab.suite_rowsum(device="cpu", batch=512, np_occ=8192, num_batches=2, iters=1)
    out = capsys.readouterr().out
    assert rec["ok"] and rec["errors"]["bound_np"] < 1 and rec["errors"]["bound_plain"] == 0
    assert set(rec["ms"]) == {"lab rowsum (red.v4)", "row_sums (#2)", "zeros + index_add_",
                              "plain"}
    assert rec["l2_reductions"] == 8192 * 6  # every quad nonzero, every row in range
    assert "correctness: max abs err" in out and "ns/occurrence" in out


@pytest.mark.parametrize("suite, kwargs", [
    ("micro", {"log2_slots": 10, "log2_nnz": 9, "dedup_log2": (6,), "iters": 1, "inner": 1}),
    ("layout", {"log2_slots": 10, "log2_nnz": 9, "iters": 1, "inner": 1}),
    ("scatter", {"log2_slots": 12, "log2_nnz": 10, "chunk": 64, "window": 128, "iters": 1}),
])
def test_other_suites_run_on_the_cpu(suite, kwargs, capsys):
    rec = bench_lab.SUITES[suite]((), device="cpu", **kwargs)
    assert rec["ok"] and rec["device"] == "cpu"
    if suite == "scatter":
        assert rec["max_abs_err"] <= 1e-4
    else:
        assert all(v > 0 for v in rec["ms"].values())
    assert "# device=cpu" in capsys.readouterr().out or suite == "scatter"
