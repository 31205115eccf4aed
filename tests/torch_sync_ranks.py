"""Spawned CPU ranks of one slice for the port's in-slice mesh sync test
(no jax import here: the ranks start by the spawn method and import only
torch and the port).

`run_slice(world, tmp, job)` starts `world` gloo ranks joined over a
`FileStore` under `tmp`. Each holds its block of the job's whole state
on the job's mesh and layout, attaches a `SliceSyncer`, moves every leaf
by `bump` and runs one round; then a second syncer on a zeroed state
adopts the freshest snapshot. Returns each rank's blocks, record and
adoption, in rank order.
"""

from __future__ import annotations

import os
import pickle


def run_slice(world: int, tmp, job: dict) -> list:
    import torch.multiprocessing as mp

    tmp = str(tmp)
    path = os.path.join(tmp, "sync_job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    mp.spawn(_rank_entry, args=(world, os.path.join(tmp, "sync_store"), path), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with open(f"{path}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_entry(rank: int, world: int, store_path: str, path: str) -> None:
    import torch
    import torch.distributed as dist

    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.parallel.distributed import init_world, shutdown
    from xflow_tpu_torch.parallel.mesh import make_mesh, shard_tensor
    from xflow_tpu_torch.parallel.multislice import SliceSyncer
    from xflow_tpu_torch.train.state import TrainState

    torch.set_num_threads(1)
    init_world(rank, world, "cpu", store=dist.FileStore(store_path, world))
    with open(path, "rb") as f:
        job = pickle.load(f)
    cfg = override(Config(), **job["pairs"])
    mesh = make_mesh(cfg, device="cpu")
    layout = job["layout"]

    def state_of(tables, opt, step, scale=1.0):
        def put(a):
            return shard_tensor(torch.from_numpy(a.copy() * scale), mesh, layout)

        return TrainState({k: put(v) for k, v in tables.items()},
                          {k: {a: put(b) for a, b in v.items()} for k, v in opt.items()}, step)

    def blocks(state):
        out = {f"tables/{k}": v.numpy().copy() for k, v in state.tables.items()}
        out.update({f"opt/{k}/{a}": b.numpy().copy() for k, v in state.opt_state.items()
                    for a, b in v.items()})
        return out

    state = state_of(*job["state"])
    syncer = SliceSyncer(cfg.sync, 0, job["num_slices"], mesh=mesh, layout=layout)
    syncer.attach(state)
    d = job["bump"]
    state = state._replace(tables={k: v + d for k, v in state.tables.items()},
                           opt_state={k: {a: b + d for a, b in v.items()}
                                      for k, v in state.opt_state.items()},
                           step=state.step + 3)
    state, record = syncer.sync(state)
    fresh = SliceSyncer(cfg.sync, 0, job["num_slices"], mesh=mesh, layout=layout)
    adopted_state, adopted = fresh.adopt_latest_snapshot(state_of(*job["state"], scale=0.0))
    out = {"blocks": blocks(state), "record": record, "adopted": adopted,
           "adopted_blocks": blocks(adopted_state)}
    with open(f"{path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    shutdown()
