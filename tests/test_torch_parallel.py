"""PyTorch port, the multi-device engines (`xflow_tpu_torch/parallel/`)
held against the JAX package's on the CPU.

The port's ranks are gloo processes started by the spawn method
(`tests/torch_parallel_ranks.py`: a FileStore under the test's tmp dir,
one start a world size, every case inside it); the JAX engines run in
this process over the forced CPU devices (root `conftest.py`), on the
same mesh shape, from the same initial state (JAX's `init_state`, carried
across with `weights.state_from_jax`), on the same three seeded batches
(B = 64, F = 10, 5 fields, `log2_slots` 14, FFM at v_dim 3):

- the fully-sharded engine at meshes (2,1), (1,2), (2,2) and (4,1) for
  FM, MVM's segment side, MVM's product side and FFM, against JAX's
  `make_fullshard_train_step` and the port's single-device two-pass
  step: losses within 2e-5 relative, the tables and FTRL n gathered whole
  within 2e-4 relative over 1e-6 (tests/test_sorted_fullshard.py's
  tolerances). The (1,2) and (2,2) cases hold the table-axis backward
  (an all_reduce whose backward summed over T would scale every
  gradient by T);
- the replicated engine (FM at (2,1), (1,2), (2,2)) against
  `make_sorted_sharded_train_step`, and the row-major sharded step (LR,
  and FM) against `make_sharded_train_step`;
- both eval steps' predictions against JAX's eval steps within 1e-5;
- host pieces with no ranks: `fullshard_buffers` and
  `plan_fullshard_batch` bitwise against JAX's, the overflow error and a
  slack that absorbs it, every validation message equal in text,
  `assign_shards` over a grid, `fullshard_overflow_sim --quick`'s output,
  the mesh shape rules and the collectives' backward rules.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parallel_ranks import collective_grads, coordinate_batch, spawn_world
from xflow_tpu.config import Config as JConfig
from xflow_tpu.config import override as joverride
from xflow_tpu.data.pipeline import assign_shards as jassign_shards
from xflow_tpu.models import get_model as jget_model
from xflow_tpu.ops import sorted_table as jst
from xflow_tpu.optim import get_optimizer as jget_optimizer
from xflow_tpu.parallel import sorted_fullshard as jfs
from xflow_tpu.parallel import sorted_sharded as jss
from xflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from xflow_tpu.parallel.train_step import (
    make_sharded_eval_step as jmake_sharded_eval_step,
)
from xflow_tpu.parallel.train_step import (
    make_sharded_train_step as jmake_sharded_train_step,
)
from xflow_tpu.parallel.train_step import shard_state as jshard_state
from xflow_tpu.train.state import init_state as jinit_state
from xflow_tpu_torch.config import Config, override
from xflow_tpu_torch.data.pipeline import assign_shards
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops import sorted_table as tst
from xflow_tpu_torch.optim import get_optimizer
from xflow_tpu_torch.parallel import sorted_fullshard as tfs
from xflow_tpu_torch.parallel import sorted_sharded as tss
from xflow_tpu_torch.parallel.mesh import Mesh, mesh_shape, slot_range
from xflow_tpu_torch.train.state import TrainState
from xflow_tpu_torch.train.step import make_train_step
from xflow_tpu_torch.weights import state_from_jax

B, F, NF, LOG2 = 64, 10, 5, 14
S = 1 << LOG2
STEPS = 3
LOSS_RTOL, RTOL, ATOL, PCTR_ATOL = 2e-5, 2e-4, 1e-6, 1e-5

SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1)]
CASES = (
    [("fullshard", m, s) for m in ("fm", "mvm", "mvm_product", "ffm") for s in SHAPES]
    + [("replicated", "fm", s) for s in SHAPES[:3]]
    + [("rowmajor", "lr", s) for s in SHAPES[:3]]
    + [("rowmajor", "fm", s) for s in ((1, 2), (2, 2))]
)
EVAL_CASES = {("fullshard", "fm", (2, 2)), ("fullshard", "ffm", (2, 1)),
              ("fullshard", "mvm_product", (1, 2)), ("rowmajor", "lr", (2, 2)),
              ("replicated", "fm", (1, 2))}


def _model(key: str) -> str:
    return "mvm" if key == "mvm_product" else key


def _pairs(key: str, d: int, t: int, engine: str) -> dict:
    """The port's overrides: each data coordinate's batch is B / D rows."""
    p = {"model.name": _model(key), "model.num_fields": NF, "data.log2_slots": LOG2,
         "data.batch_size": B // d, "data.max_nnz": F, "mesh.data": d, "mesh.table": t,
         "optim.fused_scatter": "off"}
    if key == "ffm":
        p["model.v_dim"] = 3
    if engine == "replicated":
        p["data.sorted_mesh"] = "replicated"
    return p


def _jcfg(key: str, d: int, t: int):
    p = {"model.name": _model(key), "model.num_fields": NF, "data.log2_slots": LOG2,
         "data.batch_size": B, "data.max_nnz": F, "mesh.data": d, "mesh.table": t}
    if key == "ffm":
        p["model.v_dim"] = 3
    return joverride(JConfig(), **p)


def _batches(key: str) -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = {"slots": rng.integers(0, S, (B, F)).astype(np.int32),
             "fields": rng.integers(0, NF, (B, F)).astype(np.int32),
             "mask": (rng.random((B, F)) < 0.8).astype(np.float32),
             "labels": (rng.random(B) < 0.4).astype(np.float32),
             "row_mask": np.ones((B,), np.float32)}
        if key == "mvm_product":
            # one occurrence a field: 5 live columns over the 5 fields
            b["fields"] = np.broadcast_to(np.arange(F, dtype=np.int32) % NF, (B, F)).copy()
            b["mask"] = b["mask"] * (np.arange(F) < NF)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _init(key: str):
    """JAX's initial state for the model (mesh-free), as (JAX state,
    the port's logical numpy state)."""
    jcfg = _jcfg(key, 1, 1)
    jstate = jinit_state(jget_model(_model(key)), jget_optimizer("ftrl"), jcfg)
    pcfg = override(Config(), **_pairs(key, 1, 1, "fullshard"))
    port = state_from_jax(jstate.tables, jstate.opt_state, 0, pcfg, device="cpu")
    # host copies: the JAX steps donate their input state
    return jax.tree.map(np.asarray, jstate), {
        "tables": {n: t.numpy() for n, t in port.tables.items()},
        "opt": {n: {k: v.numpy() for k, v in s.items()} for n, s in port.opt_state.items()},
    }


def _case_dict(engine, key, shape) -> dict:
    d, t = shape
    return {"engine": engine, "pairs": _pairs(key, d, t, engine), "batches": _batches(key),
            "state": _init(key)[1], "eval": (engine, key, shape) in EVAL_CASES,
            "with_fields": key == "mvm"}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every case's result from the port's ranks: one spawn for the
    world of 2 and one for the world of 4."""
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c[2][0] * c[2][1] == world]
        got = spawn_world(world, tmp_path_factory.mktemp(f"world{world}"),
                          [_case_dict(*c) for c in cases])
        out.update(zip(cases, got))
    return out


def _single_device(key: str) -> tuple:
    """The port's single-device two-pass step on the global batches from
    the same initial state: (losses, tables, opt)."""
    pcfg = override(Config(), **{**_pairs(key, 1, 1, "fullshard"), "data.batch_size": B})
    st = _init(key)[1]
    state = TrainState({n: torch.from_numpy(a.copy()) for n, a in st["tables"].items()},
                       {n: {k: torch.from_numpy(a.copy()) for k, a in s.items()}
                        for n, s in st["opt"].items()}, 0)
    step = make_train_step(get_model(_model(key))(pcfg), get_optimizer("ftrl"), pcfg)
    losses = []
    for b in _batches(key):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, {n: t.numpy() for n, t in state.tables.items()}, {
        n: {k: v.numpy() for k, v in s.items()} for n, s in state.opt_state.items()}


def _jax_run(engine, key, shape) -> tuple:
    """JAX's engine on the same mesh shape: (losses, logical tables, opt,
    per-batch pctrs before each step)."""
    d, t = shape
    jcfg = _jcfg(key, d, t)
    mesh = jmake_mesh(jcfg, devices=jax.devices()[: d * t])
    model, opt = jget_model(_model(key)), jget_optimizer("ftrl")
    jstate = jax.tree.map(jnp.asarray, _init(key)[0])
    want_eval = (engine, key, shape) in EVAL_CASES
    if engine == "fullshard":
        from tests.test_sorted_fullshard import _place_fullshard

        state = jshard_state(jstate, mesh)
        step = jfs.make_fullshard_train_step(opt, jcfg, mesh)
        ev = jfs.make_fullshard_eval_step(jcfg, mesh)
        with_fields = key in ("mvm", "ffm")
        place = lambda b: _place_fullshard(b, jcfg, mesh, with_fields)  # noqa: E731
        place_eval = place
    else:
        rowmajor = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
        ev = jmake_sharded_eval_step(model, jcfg, mesh)
        place_eval = rowmajor
        if engine == "replicated":
            state = jss.shard_sorted_state(jstate, mesh)
            step = jss.make_sorted_sharded_train_step(opt, jcfg, mesh)

            def place(b):
                plan = jst.plan_sorted_stacked(b["slots"], b["mask"], S, num_sub=d,
                                               always_stack=True)
                return {"labels": jnp.asarray(b["labels"]),
                        "row_mask": jnp.asarray(b["row_mask"]),
                        "sorted_slots": jnp.asarray(plan.sorted_slots),
                        "sorted_row": jnp.asarray(plan.sorted_row),
                        "sorted_mask": jnp.asarray(plan.sorted_mask),
                        "win_off": jnp.asarray(plan.win_off)}
        else:
            state = jshard_state(jstate, mesh)
            step = jmake_sharded_train_step(model, opt, jcfg, mesh)
            place = rowmajor
    losses, preds = [], []
    for b in _batches(key):
        if want_eval:
            preds.append(np.asarray(ev(state.tables, place_eval(b))))
        state, m = step(state, place(b))
        losses.append(float(m["loss"]))
    pcfg = override(Config(), **_pairs(key, 1, 1, "fullshard"))
    port = state_from_jax({n: np.asarray(v) for n, v in state.tables.items()},
                          {n: {k: np.asarray(v) for k, v in s.items()}
                           for n, s in state.opt_state.items()}, 0, pcfg, device="cpu")
    return (losses, {n: t.numpy() for n, t in port.tables.items()},
            {n: {k: v.numpy() for k, v in s.items()} for n, s in port.opt_state.items()},
            preds)


def _close(got: dict, want: dict, what: str) -> None:
    for name in want["tables"]:
        np.testing.assert_allclose(got["tables"][name], want["tables"][name], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: table {name}")
        np.testing.assert_allclose(got["opt"][name]["n"], want["opt"][name]["n"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: n of {name}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}")
def test_engine_matches_jax_and_single_device(case, port_results):
    engine, key, shape = case
    got = port_results[case]
    assert tuple(got["mesh"]) == shape
    jl, jt, jo, jp = _jax_run(*case)
    np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL, err_msg=f"{case} vs JAX")
    _close(got, {"tables": jt, "opt": jo}, f"{case} vs JAX")
    sl, stab, sopt = _single_device(key)
    np.testing.assert_allclose(got["losses"], sl, rtol=LOSS_RTOL,
                               err_msg=f"{case} vs the single-device step")
    _close(got, {"tables": stab, "opt": sopt}, f"{case} vs the single-device step")
    if case in EVAL_CASES:
        assert len(got["preds"]) == len(jp) == STEPS
        for g, w in zip(got["preds"], jp):
            np.testing.assert_allclose(g, w, rtol=0, atol=PCTR_ATOL, err_msg=f"{case} pctr")


# ------------------------------------------------------------ host pieces

@pytest.mark.parametrize("D,T", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("with_fields", [False, True])
def test_fullshard_buffers_bitwise(D, T, with_fields):
    rng = np.random.default_rng(D * 10 + T)
    rows = 64
    slots = rng.integers(0, S, (rows, F)).astype(np.int32)
    mask = (rng.random((rows, F)) < 0.7).astype(np.float32)
    fields = rng.integers(0, NF, (rows, F)).astype(np.int32) if with_fields else None
    tplan = tst.plan_sorted_batch(slots, mask, S, fields=fields)
    jplan = jst.plan_sorted_batch(slots, mask, S, fields=fields)
    cap = 2048
    got = tfs.fullshard_buffers(tplan, D, T, cap, S // (D * T), 2.0, with_fields,
                                n_real=slots.size)
    want = jfs.fullshard_buffers(jplan, D, T, cap, S // (D * T), 2.0, with_fields,
                                 n_real=slots.size)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    one = tfs.fullshard_buffers(tplan, D, T, cap, S // (D * T), 2.0, with_fields,
                                n_real=slots.size, columns=(T - 1,))
    for k in want:
        assert np.array_equal(one[k][0], want[k][T - 1]), k


@pytest.mark.parametrize("D,T", [(2, 1), (2, 2), (4, 1)])
def test_plan_fullshard_batch_matches_jax_slices(D, T):
    jcfg = joverride(JConfig(), **{"model.name": "ffm", "model.num_fields": NF,
                                   "data.log2_slots": LOG2, "data.batch_size": B,
                                   "data.max_nnz": F, "mesh.data": D, "mesh.table": T})
    jmesh = jmake_mesh(jcfg, devices=jax.devices()[: D * T])
    b = _batches("ffm")[0]
    want = jfs.plan_fullshard_batch(b["slots"], b["mask"], jcfg, jmesh, fields=b["fields"])
    tcfg = override(Config(), **_pairs("ffm", D, T, "fullshard"))
    for d in range(D):
        cb = coordinate_batch(b, d, D)
        got = tfs.plan_fullshard_batch(cb.slots, cb.mask, tcfg, Mesh(D, T), fields=cb.fields)
        for k in want:
            assert np.array_equal(got[k], want[k][d]), (d, k)
        for t in range(T):
            col = tfs.plan_fullshard_batch(cb.slots, cb.mask, tcfg, Mesh(D, T),
                                           fields=cb.fields, column=t)
            for k in want:
                assert np.array_equal(col[k], want[k][d, t]), (d, t, k)


def test_overflow_raises_and_higher_slack_absorbs_it():
    slots = np.full((128, 10), 7, np.int32)  # 1,280 occurrences in one block
    mask = np.ones((128, 10), np.float32)
    plan = tst.plan_sorted_batch(slots, mask, S)
    with pytest.raises(tfs.FullshardOverflowError, match="fullshard_slack") as e:
        tfs.fullshard_buffers(plan, D=4, T=2, cap=512, s_local=S // 8, slack=2.0, n_real=1280)
    with pytest.raises(ValueError) as je:
        jfs.fullshard_buffers(jst.plan_sorted_batch(slots, mask, S), D=4, T=2, cap=512,
                              s_local=S // 8, slack=2.0, n_real=1280)
    assert str(e.value) == str(je.value)
    # a data coordinate's 128 x 10 batch on one slot: 1,280 occurrences in
    # block 0, over the (4, 2) capacity of 1,024 at slack 2
    cfg = override(Config(), **{**_pairs("fm", 4, 2, "fullshard"), "data.batch_size": 128,
                                "data.fullshard_slack": 16.0})
    got = tfs.plan_fullshard_batch(slots, mask, cfg, Mesh(4, 2))
    assert float(got["fs_mask"].sum()) == float(mask.sum())
    low = override(cfg, **{"data.fullshard_slack": 2.0})
    assert tfs.fullshard_capacity(low, Mesh(4, 2)) == 1024
    with pytest.raises(tfs.FullshardOverflowError):
        tfs.plan_fullshard_batch(slots, mask, low, Mesh(4, 2))


BAD_FULLSHARD = [
    {"data.log2_slots": 12},
    {"model.name": "lr"},
    {"model.fm_fused": False},
    {"data.sorted_sub_batches": 2},
    {"data.fullshard_slack": 0.5},
]
BAD_SHARDED = [
    {"data.log2_slots": 12},
    {"model.name": "mvm"},
    {"data.sorted_sub_batches": 2},
]


@pytest.mark.parametrize("which,extra", [("fullshard", e) for e in BAD_FULLSHARD]
                         + [("sharded", e) for e in BAD_SHARDED])
def test_validation_messages_equal_jax(which, extra):
    """At a (1, T) mesh, one data coordinate, the JAX package's single
    process plans exactly what the port's coordinate plans, so every
    message must read the same."""
    T = 4
    base = {"model.name": "fm", "model.num_fields": NF, "data.log2_slots": LOG2,
            "data.batch_size": B, "data.max_nnz": F, "mesh.data": 1, "mesh.table": T}
    jcfg = joverride(JConfig(), **{**base, **extra})
    tcfg = override(Config(), **{**base, **extra})
    jmesh = jmake_mesh(jcfg, devices=jax.devices()[:T])
    jval = jfs.validate_sorted_fullshard if which == "fullshard" else jss.validate_sorted_sharded
    tval = tfs.validate_sorted_fullshard if which == "fullshard" else tss.validate_sorted_sharded
    with pytest.raises(ValueError) as je:
        jval(jcfg, jmesh)
    with pytest.raises(ValueError) as te:
        tval(tcfg, Mesh(1, T))
    assert str(te.value) == str(je.value)
    assert tfs.fullshard_capacity(tcfg, Mesh(1, T)) == jfs.fullshard_capacity(jcfg, jmesh)


def test_assign_shards_matches_jax():
    for world in range(1, 6):
        for num in (0, 1, 2, 3, 5, 8):
            for rank in range(world):
                assert assign_shards("p", rank, world, num) == jassign_shards(
                    "p", rank, world, num)


def test_overflow_sim_quick_matches_jax(capsys):
    from xflow_tpu.tools import fullshard_overflow_sim as jsim
    from xflow_tpu_torch.tools import fullshard_overflow_sim as tsim

    assert tsim.main(["--quick"]) == 0
    got = capsys.readouterr().out
    assert jsim.main(["--quick"]) == 0
    want = capsys.readouterr().out
    assert got == want and got.count("\n") == 12


def test_mesh_shape_and_slot_ranges():
    cfg = Config()
    assert mesh_shape(cfg, 4) == (4, 1)
    assert mesh_shape(override(cfg, **{"mesh.table": 2}), 4) == (2, 2)
    assert mesh_shape(override(cfg, **{"mesh.data": 1, "mesh.table": -1}), 4) == (1, 4)
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        mesh_shape(override(cfg, **{"mesh.data": 3}), 4)
    full = [slot_range(Mesh(2, 2, rank=r), 64, "full") for r in range(4)]
    assert full == [(0, 16), (16, 32), (32, 48), (48, 64)]
    table = [slot_range(Mesh(2, 2, rank=r), 64, "table") for r in range(4)]
    assert table == [(0, 32), (32, 64), (0, 32), (32, 64)]
    with pytest.raises(ValueError, match="not divisible by the mesh size"):
        slot_range(Mesh(3, 1), 64, "full")


def test_collective_backward_rules(tmp_path):
    """The backward rules on a loss every rank holds whole: d/dx of
    sum_r (r+1) * (reduce_scatter(x_0^2 + x_1^2))_r is 2 x_q (r+1) for the
    rows rank r receives, on every rank q; an all_reduce passes its
    cotangent through (a sum-backward would double it); the byte exchange
    moves int16 chunks in rank order."""
    import torch.multiprocessing as mp

    out = str(tmp_path / "res")
    mp.spawn(collective_grads, args=(2, str(tmp_path / "store"), out), nprocs=2, join=True)
    got = [torch.load(f"{out}.{r}") for r in range(2)]
    for q, g in enumerate(got):
        want = torch.tensor([[1.0], [1.0], [2.0], [2.0]]) * 2 * (q + 1)
        assert torch.equal(g["grad"], want.expand(4, 2))
        assert float(g["loss"]) == 60.0  # 4 elements of 1 + 4, times 1 and 2
    assert got[0]["ex"].tolist() == [0, 1, 10, 11] and got[1]["ex"].tolist() == [2, 3, 12, 13]
