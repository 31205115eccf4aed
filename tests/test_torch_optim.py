"""PyTorch port, the optimizers (xflow_tpu_torch/optim) and the table
init held against the JAX package (`xflow_tpu/optim/{ftrl,sgd}.py`) and
the per-key numpy oracle (`tests/oracles.py::FTRLOracle`):

- FTRL `update_one` and `apply`, SGD `apply`, on the same numpy state:
  n bitwise; w and z within 1e-3 relative over a 1e-4 floor
  (kernel_parity's FTRL class: XLA's float32 chain lands an ulp away
  from torch's in the (sqrt(n') - sqrt(n)) / alpha * w term, and z's
  subtraction cancels), and w bitwise kept where the lazy-init guard
  holds;
- "FTRL is the identity where the gradient is zero": for any state that
  `update_one` produced, a second update with g = 0 returns (w, n, z)
  bitwise, in the port and in JAX's `_update_one` (the precondition of a
  touched-only scatter+FTRL kernel);
- `init_tables` under FTRL and SGD.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracles import FTRLOracle
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.optim.ftrl import _update_one as jupdate_one
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.optim.ftrl import update_one

HP = (5e-2, 1.0, 5e-5, 10.0)  # alpha, beta, lambda1, lambda2 (the defaults)
SHAPE = (4096, 5)


def _state(seed):
    """(w, n, z, g) with untouched slots (n = 0), zero gradients, and
    both at once (the lazy-init guard)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(SHAPE) * 0.01).astype(np.float32)
    n = (np.abs(rng.standard_normal(SHAPE)) * 0.1).astype(np.float32)
    z = (rng.standard_normal(SHAPE) * 1e-3).astype(np.float32)
    g = (rng.standard_normal(SHAPE) * 0.1).astype(np.float32)
    n[::3] = 0.0
    z[::3] = 0.0
    g[::2] = 0.0
    return w, n, z, g


def _close(got, want, rtol=1e-3, floor=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want) / (np.abs(want) + floor)) <= rtol


def test_ftrl_update_one_matches_jax():
    w, n, z, g = _state(0)
    want = jupdate_one(*(jnp.asarray(a) for a in (w, n, z, g)), *HP)
    got = update_one(*(torch.from_numpy(a) for a in (w, n, z, g)), *HP)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kept = (g == 0) & (n == 0)
    assert kept.any()
    np.testing.assert_array_equal(got[0].numpy()[kept], w[kept])
    assert np.all(got[0].numpy()[(g != 0) & (np.abs(got[2].numpy()) <= HP[2])] == 0)


@pytest.mark.parametrize("name", ["ftrl", "sgd"])
def test_apply_matches_jax(name):
    w, n, z, g = _state(1)
    jcfg = joverride(JConfig(), **{"optim.name": name})
    tcfg = override(Config(), **{"optim.name": name})
    jopt, topt = jget_optimizer(name), get_optimizer(name)
    jst = jopt.init_state({"wv": jnp.asarray(w)})
    tst = topt.init_state({"wv": torch.from_numpy(w)})
    if name == "ftrl":
        jst = {"wv": {"n": jnp.asarray(n), "z": jnp.asarray(z)}}
        tst = {"wv": {"n": torch.from_numpy(n), "z": torch.from_numpy(z)}}
    assert tst.keys() == jst.keys() and tst["wv"].keys() == jst["wv"].keys()
    jt, jo = jopt.apply({"wv": jnp.asarray(w)}, jst, {"wv": jnp.asarray(g)}, jcfg)
    tt, to = topt.apply({"wv": torch.from_numpy(w)}, tst, {"wv": torch.from_numpy(g)}, tcfg)
    _close(tt["wv"].numpy(), np.asarray(jt["wv"]))
    for leaf in to["wv"]:
        _close(to["wv"][leaf].numpy(), np.asarray(jo["wv"][leaf]))


def test_ftrl_matches_per_key_oracle():
    """A few keys pushed nonzero gradients step after step: the dense
    update equals the reference's per-key state machine."""
    rng = np.random.default_rng(2)
    oracle = FTRLOracle(dim=(SHAPE[1],))
    w = n = z = torch.zeros((3, SHAPE[1]))
    for _ in range(6):
        g = rng.standard_normal((3, SHAPE[1])).astype(np.float32) * 0.3
        w, n, z = update_one(w, n, z, torch.from_numpy(g), *HP)
        for key in range(3):
            oracle.push(key, g[key])
    for key in range(3):
        _close(w[key].numpy(), oracle.pull(key), rtol=1e-5, floor=1e-7)
        _close(n[key].numpy(), oracle.store[key]["n"], rtol=1e-5, floor=1e-7)
        _close(z[key].numpy(), oracle.store[key]["z"], rtol=1e-5, floor=1e-7)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_ftrl_is_the_identity_where_the_gradient_is_zero(package):
    w, n, z, g = _state(3)
    if package == "port":
        step = lambda *a: tuple(t.numpy() for t in update_one(  # noqa: E731
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in a), *HP))
    else:
        step = lambda *a: tuple(np.asarray(t) for t in jupdate_one(  # noqa: E731
            *(jnp.asarray(x) for x in a), *HP))
    state = (w, n, z)
    rng = np.random.default_rng(4)
    for i in range(3):  # states update_one produced, some slots never touched
        gi = g * (rng.random(SHAPE) < 0.5) if i else g
        state = step(*state, gi.astype(np.float32))
    again = step(*state, np.zeros(SHAPE, np.float32))
    for name, a, b in zip("wnz", again, state):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (state[1] == 0).any() and (state[1] > 0).any()


@pytest.mark.parametrize("optim", ["ftrl", "sgd"])
def test_init_tables(optim):
    cfg = override(Config(), **{
        "model.name": "fm", "model.v_dim": 4, "data.log2_slots": 12, "optim.name": optim,
    })
    wv = get_model("fm")(cfg).init_tables(torch.Generator().manual_seed(0), "cpu")["wv"]
    assert tuple(wv.shape) == (1 << 12, 5) and torch.all(wv[:, 0] == 0)
    if optim == "sgd":
        assert torch.all(wv[:, 1:] == np.float32(cfg.optim.v_init_sgd))
    else:
        assert abs(float(wv[:, 1:].std()) - cfg.optim.v_init_scale) < 1e-3


def test_unknown_optimizer():
    with pytest.raises(KeyError, match="unknown optimizer"):
        get_optimizer("adam")
