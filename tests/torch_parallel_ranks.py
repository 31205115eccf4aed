"""Spawned CPU ranks for the port's mesh tests (no jax import here: the
ranks start by the spawn method and import only torch and the port).

`spawn_world(world, tmp, cases)` starts `world` gloo ranks joined over a
`FileStore` under `tmp`, runs every case in order inside that one start
and returns rank 0's results (each case's losses, the tables and
optimizer leaves gathered whole, predictions). A case is a dict:

- ``engine``: "fullshard", "replicated" or "rowmajor";
- ``pairs``: config overrides (the mesh shape among them);
- ``state``: whole initial tables and optimizer leaves (numpy);
- ``batches``: the global row-major batches, split over the data
  coordinates by rows (coordinate d takes block d);
- ``eval``: whether to run the engine's eval step on each batch first.
"""

from __future__ import annotations

import os
import pickle
import types

import numpy as np


def spawn_world(world: int, tmp, cases: list) -> list:
    import torch.multiprocessing as mp

    tmp = str(tmp)
    job = os.path.join(tmp, f"job{world}.pkl")
    with open(job, "wb") as f:
        pickle.dump(cases, f)
    store = os.path.join(tmp, f"store{world}")
    mp.spawn(_rank_entry, args=(world, store, job), nprocs=world, join=True)
    with open(job + ".out", "rb") as f:
        return pickle.load(f)


def _rank_entry(rank: int, world: int, store_path: str, job: str) -> None:
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.parallel.distributed import init_world, shutdown

    torch.set_num_threads(1)
    init_world(rank, world, "cpu", store=dist.FileStore(store_path, world))
    with open(job, "rb") as f:
        cases = pickle.load(f)
    out = [run_case(c) for c in cases]
    if rank == 0:
        with open(job + ".out", "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    shutdown()


def coordinate_batch(b: dict, d: int, D: int):
    """Data coordinate d's rows of a global batch, as a SparseBatch-like
    namespace."""
    B = b["labels"].shape[0]
    r = B // D
    sl = slice(d * r, (d + 1) * r)
    return types.SimpleNamespace(**{k: np.ascontiguousarray(v[sl]) for k, v in b.items()})


def run_case(case: dict) -> dict:
    import torch

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.evaluate import to_device
    from xflow_tpu_torch.models import get_model
    from xflow_tpu_torch.optim import get_optimizer
    from xflow_tpu_torch.parallel import sorted_fullshard as fs
    from xflow_tpu_torch.parallel import sorted_sharded as ss
    from xflow_tpu_torch.parallel import train_step as ts
    from xflow_tpu_torch.parallel.mesh import make_mesh, shard_tensor
    from xflow_tpu_torch.train.state import TrainState

    cfg = override(Config(), **case["pairs"])
    mesh = make_mesh(cfg)
    engine = case["engine"]
    layout = "table" if engine == "replicated" else "full"
    model = get_model(cfg.model.name)(cfg)
    opt = get_optimizer(cfg.optim.name)
    st = case["state"]
    put = lambda a: shard_tensor(torch.from_numpy(np.array(a)), mesh, layout)  # noqa: E731
    state = TrainState({n: put(a) for n, a in st["tables"].items()},
                       {n: {k: put(a) for k, a in s.items()} for n, s in st["opt"].items()}, 0)
    mvm_fields = case.get("with_fields", False)
    if engine == "fullshard":
        step = fs.make_fullshard_train_step(opt, cfg, mesh)
        ev = fs.make_fullshard_eval_step(cfg, mesh)
        with_fields = cfg.model.name == "ffm" or mvm_fields

        def host(b):
            return fs.fullshard_arrays(b, cfg, mesh, with_fields)
    elif engine == "replicated":
        step = ss.make_sorted_sharded_train_step(opt, cfg, mesh)
        ev = ts.make_sharded_eval_step(model, cfg, mesh, layout="table")

        def host(b):
            return ss.sorted_arrays(b, cfg)
    else:
        step = ts.make_sharded_train_step(model, opt, cfg, mesh)
        ev = ts.make_sharded_eval_step(model, cfg, mesh)

        def host(b):
            return ts.row_share(vars(b), mesh)
    losses, preds = [], []
    for gb in case["batches"]:
        b = coordinate_batch(gb, mesh.d, mesh.data)
        arrays = to_device(host(b), "cpu")
        if case.get("eval"):
            if engine == "replicated":
                p = ev(state.tables, to_device(ts.row_share(vars(b), mesh), "cpu"))
            else:
                p = ev(state.tables, arrays)
            from xflow_tpu_torch.parallel import collectives as C

            p = C.all_gather(p[: b.labels.shape[0]].contiguous(), mesh.data_group)
            preds.append(p.numpy())
        state, m = step(state, arrays)
        losses.append(float(m["loss"]))
    whole = ts.gather_state(state, mesh, layout)
    return {
        "losses": losses,
        "preds": preds,
        "tables": {n: t.numpy() for n, t in whole.tables.items()},
        "opt": {n: {k: v.numpy() for k, v in s.items()} for n, s in whole.opt_state.items()},
        "mesh": (mesh.data, mesh.table),
    }


def collective_grads(rank: int, world: int, store: str, out: str) -> None:
    """A rank of test_collective_backward_rules: a loss every rank holds
    whole through reduce_scatter and all_reduce, its gradient, and a byte
    exchange of int16 chunks."""
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.parallel import collectives as C
    from xflow_tpu_torch.parallel.distributed import init_world, shutdown

    init_world(rank, world, "cpu", store=dist.FileStore(store, world))
    x = torch.full((4, 2), float(rank + 1), requires_grad=True)
    part = C.reduce_scatter(x * x)  # this rank's 2 rows of the sum over ranks
    loss = C.all_reduce((part * (rank + 1)).sum())
    loss.backward()
    ex = C.exchange(torch.arange(4, dtype=torch.int16) + 10 * rank)
    torch.save({"grad": x.grad, "loss": loss.detach(), "ex": ex}, f"{out}.{rank}")
    shutdown()


def fit_world(world: int, tmp, pairs: dict) -> list:
    """`Trainer(cfg, mesh).fit()` on `world` gloo ranks; per rank its step
    count, examples and the engine of every step it ran ("fullshard" for
    a batch with the fully-sharded buffers, else "row_major")."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    job = os.path.join(tmp, "fit.pkl")
    with open(job, "wb") as f:
        pickle.dump(pairs, f)
    mp.spawn(_fit_entry, args=(world, os.path.join(tmp, "fitstore"), job), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with open(f"{job}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _fit_entry(rank: int, world: int, store: str, job: str) -> None:
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.parallel.distributed import init_world, shutdown
    from xflow_tpu_torch.parallel.mesh import make_mesh
    from xflow_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    init_world(rank, world, "cpu", store=dist.FileStore(store, world))
    with open(job, "rb") as f:
        cfg = override(Config(), **pickle.load(f))
    trainer = Trainer(cfg, device="cpu", mesh=make_mesh(cfg))
    log = []
    inner = trainer.train_step

    def logged(state, batch):
        log.append("fullshard" if "fs_slots" in batch else "row_major")
        return inner(state, batch)

    trainer.train_step = logged
    res = trainer.fit()
    with open(f"{job}.{rank}", "wb") as f:
        pickle.dump({"steps": res.steps, "examples": res.examples, "log": log,
                     "engine": trainer._mesh_engine}, f)
    shutdown()
