"""PyTorch port, the kernel parity gate (`xflow_tpu_torch/tools/kernel_parity.py`)
on the CPU: the gate's checks hold the plain versions against its
oracles at a small size, the plain gather and scatter give the JAX
package's `_gather_xla` and `jax.ops.segment_sum` on the gate's own kind
of inputs (a table scaled by e^U(-8,8), and the aligned width k = 16),
and `main` refuses to report on a machine with no CUDA device.

Tolerances: gathers bitwise; scatters 1e-4 relative over a 1e-2 floor
(the JAX gate's).
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

import xflow_tpu.ops.sorted_table as jst
from xflow_tpu_torch.ops import sorted_table as st
from xflow_tpu_torch.tools import kernel_parity

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gate_holds_the_plain_versions_on_the_cpu():
    res = kernel_parity.check_kernel_parity(log2_slots=12, n_occ=1 << 13, batch=1024,
                                            device="cpu")
    assert res["backend"] == "cpu"
    assert set(res["checks"]) == set(kernel_parity.TOLERANCES)
    assert not {"gather_packed", "scatter_packed"} & set(res["checks"])
    over = {n: e for n, e in res["checks"].items() if not e <= kernel_parity.TOLERANCES[n]}
    assert res["ok"] and not over, over
    assert res["checks"]["gather_bf16"] > 0  # bf16 rounds: the check is not vacuous
    assert set(res["rel_floor"]) == {"rowsum", "lab_rowsum"}


def _plan_case(k, seed=0, log2_s=12, batch=512, nnz=8):
    rng = np.random.default_rng(seed)
    S = 1 << log2_s
    slots = rng.integers(0, S, (batch, nnz)).astype(np.int32)
    mask = (rng.random((batch, nnz)) < 0.9).astype(np.float32)
    table = rng.standard_normal((S, k)).astype(np.float32)
    table *= np.exp(rng.uniform(-8, 8, (S, 1))).astype(np.float32)
    plan = st.plan_sorted_batch(slots, mask, S)
    d = (rng.standard_normal((st._k8(k), plan.sorted_slots.shape[0])).astype(np.float32)
         * plan.sorted_mask[None, :])
    return S, table, plan, d


@pytest.mark.parametrize("k", [11, 16])
def test_plain_gather_and_scatter_match_jax(k):
    S, table, plan, d = _plan_case(k)
    got = st.gather_sorted_plain(torch.from_numpy(table), torch.from_numpy(plan.sorted_slots))
    want = np.asarray(jax.jit(jst._gather_xla)(jnp.asarray(table), jnp.asarray(plan.sorted_slots),
                                               jnp.asarray(plan.win_off)))
    assert got.shape == want.shape and got.numpy().tobytes() == want.tobytes()

    got_s = st.scatter_sorted_plain(torch.from_numpy(d), torch.from_numpy(plan.sorted_slots), S, k)
    want_s = np.asarray(jax.ops.segment_sum(jnp.asarray(d[:k].T), jnp.asarray(plan.sorted_slots),
                                            num_segments=S))
    rel = np.max(np.abs(got_s.numpy().astype(np.float64) - want_s)
                 / (np.abs(want_s.astype(np.float64)) + 1e-2))
    assert rel <= 1e-4


def test_main_exits_2_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "xflow_tpu_torch.tools.kernel_parity"],
                       cwd=REPO_ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 2
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] is False and out["backend"] == "cpu" and out["checks"] == {}
    assert "no CUDA device" in r.stderr
