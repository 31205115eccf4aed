"""Multi-process start-up (`xflow_tpu/parallel/distributed.py`): every
process is one SPMD rank driving one device, joined by
`torch.distributed.init_process_group` over a `TCPStore` at the
coordinator (rank 0 hosts it).

The environment contract is the JAX package's:

- ``XFLOW_COORDINATOR``: ``host:port`` of rank 0's store;
- ``XFLOW_NUM_PROCESSES``: the world size;
- ``XFLOW_PROCESS_ID``: this rank;

or the `train` flags ``--coordinator``, ``--num-processes`` and
``--process-id``, which win over the environment.

The backend follows the device the caller asked for and nothing else:
NCCL for ``cuda`` (after `torch.cuda.set_device` to the rank's local
card), gloo for ``cpu``. There is no probe and no swap of one for the
other. NCCL drives one card a rank: a world above 1 on a host with fewer
cards than local ranks (``LOCAL_WORLD_SIZE``, by default the whole
world) raises here, before NCCL would fail on a duplicate device.

The rendezvous retries with bounded backoff and jitter
(`launch/supervise.retry_call`): ``XFLOW_RENDEZVOUS_RETRIES`` (default
3) retries after the first failure, ``XFLOW_RENDEZVOUS_BACKOFF_S``
(default 1.0) the base delay, doubling per attempt up to 30 s. A failed
attempt's half-formed process group is destroyed before the next.

The JAX package's ``XFLOW_AUTO_DIST`` (a TPU pod publishing its own
topology to a no-argument `jax.distributed.initialize`) has no
counterpart: nothing on a GPU host publishes one, so the world is always
named by the contract above.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


def _rendezvous_retry_env() -> tuple[int, float]:
    """(retries, backoff base) from the environment; a junk value falls
    back to the default instead of killing the launch."""
    try:
        retries = int(os.environ.get("XFLOW_RENDEZVOUS_RETRIES", "3") or 3)
    except ValueError:
        retries = 3
    try:
        base = float(os.environ.get("XFLOW_RENDEZVOUS_BACKOFF_S", "1.0") or 1.0)
    except ValueError:
        base = 1.0
    return max(retries, 0), max(base, 0.0)


def backend_for(device) -> str:
    """The process-group backend of `device`: nccl for CUDA, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"device {device!r}: the mesh runs on cuda (NCCL) or cpu (gloo)")


def local_device(device, rank: int, world: int):
    """The device this rank drives: for CUDA its local card
    (``LOCAL_RANK``, by default the rank), after checking that the host
    has one card per local rank (NCCL puts no two ranks of a communicator
    on one device). The CPU as given."""
    if torch.device(device).type != "cuda":
        return torch.device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    local_rank = int(os.environ.get("LOCAL_RANK", rank) or 0)
    cards = torch.cuda.device_count()
    if world > 1 and cards < local_world:
        raise RuntimeError(
            f"a world of {world} rank(s), {local_world} on this host, needs one CUDA device "
            f"a local rank, and this host has {cards}: NCCL runs one device a rank and refuses "
            "two ranks of one communicator on the same device. Run fewer ranks a host, or "
            "the CPU (gloo) for a multi-rank run on one card"
        )
    dev = torch.device("cuda", local_rank % max(cards, 1))
    torch.cuda.set_device(dev)
    return dev


def init_world(rank: int, world: int, device="cuda", coordinator: Optional[str] = None,
               store=None) -> torch.device:
    """Join rank `rank` of a world of `world` processes over `store` (a
    `torch.distributed.Store`), or a `TCPStore` at `coordinator`
    (``host:port``; rank 0 hosts it), with the backend of `device`
    (`backend_for`), under the rendezvous retry. Checks that the world
    formed. Returns the device this rank drives."""
    from xflow_tpu_torch.launch.supervise import retry_call

    backend = backend_for(device)
    dev = local_device(device, rank, world)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)

    def attempt():
        st = store
        if st is None:
            if not coordinator or ":" not in coordinator:
                raise ValueError(f"coordinator {coordinator!r}: expected host:port")
            host, port = coordinator.rsplit(":", 1)
            st = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=st, rank=rank, world_size=world,
                                timeout=timeout, **kwargs)

    def cleanup():
        if dist.is_initialized():
            dist.destroy_process_group()

    retries, base = _rendezvous_retry_env()
    retry_call(attempt, what="rendezvous", retries=retries, base_s=base, cap_s=30.0,
               cleanup=cleanup)
    if dist.get_world_size() != world:
        raise RuntimeError(
            f"distributed world failed to form: world size {dist.get_world_size()} != "
            f"num_processes={world} (backend {backend})"
        )
    return dev


def maybe_initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> int:
    """Join the world the flags or the ``XFLOW_*`` environment name, when
    it holds more than one process; returns this process's rank (0 for a
    single process, which starts no process group)."""
    coordinator = coordinator or os.environ.get("XFLOW_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("XFLOW_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("XFLOW_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if not (coordinator and num_processes > 1):
        return 0
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process id {process_id!r} is not a rank of a world of {num_processes}: "
            "pass --process-id or XFLOW_PROCESS_ID"
        )
    init_world(process_id, num_processes, device, coordinator=coordinator)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the world, when one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
