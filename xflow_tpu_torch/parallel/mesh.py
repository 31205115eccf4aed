"""The ('data', 'table') mesh (`xflow_tpu/parallel/mesh.py`) over
`torch.distributed` ranks.

The reference's topology, N async workers pulling from and pushing to M
key-range-sharded servers (ps-lite), maps onto a 2-D mesh of D x T
ranks, one process a device:

- the ``data`` axis is the worker tier: each data coordinate reads its
  own shards and trains on its own rows;
- the ``table`` axis is the server tier: the table's slot range is split
  across it.

Rank ``r`` sits at ``(d, t) = divmod(r, T)``. The ``data`` group holds
the D ranks of one ``t``, the ``table`` group the T ranks of one ``d``;
the engines' collectives run over one of them (or the world). A data
coordinate plays the part of a JAX process: its T ranks read the same
shards (`data/pipeline.assign_shards(prefix, d, D)`) and the same
per-process batch of ``data.batch_size`` rows, and each builds the
buffers of its own column ``t``. With T = 1, the default
(``MeshConfig(data=-1, table=1)``), that is exactly the JAX package's
multi-process contract: one device a process, one shard a process.

Two table layouts (`slot_range`):

- ``full`` (``P(('data','table'))``, the fully-sharded engine, LR and
  the row-major step): rank ``o = d*T + t`` owns slots
  ``[o*S/W, (o+1)*S/W)``, W = D*T;
- ``table`` (``P('table', None)``, the replicated engine): rank
  ``(d, t)`` owns ``t``'s range ``[t*S/T, (t+1)*S/T)``, repeated across
  ``d``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TABLE_AXIS = "table"
LAYOUTS = ("full", "table")


@dataclass
class Mesh:
    """A D x T mesh seen from one rank: its coordinates, its device and
    the process groups of its two axes (None when no world is joined:
    the host-side planners need only the shape)."""

    data: int
    table: int
    rank: int = 0
    device: Any = "cpu"
    data_group: Optional[Any] = None
    table_group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.data * self.table

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, TABLE_AXIS: self.table}

    @property
    def d(self) -> int:
        return self.rank // self.table

    @property
    def t(self) -> int:
        return self.rank % self.table

    def owners(self, layout: str) -> int:
        """How many ranks a table's slot range is split over."""
        return self.size if _layout(layout) == "full" else self.table

    def owner_index(self, layout: str) -> int:
        """This rank's block of a table in `layout`."""
        return self.rank if _layout(layout) == "full" else self.t

    def owner_group(self, layout: str):
        """The group whose ranks split a table in `layout` (None: the world)."""
        return None if _layout(layout) == "full" else self.table_group


def _layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"table layout {layout!r}: expected one of {LAYOUTS}")
    return layout


def mesh_shape(cfg, n: int) -> tuple[int, int]:
    """(D, T) of `cfg.mesh` on `n` ranks: -1 infers an axis; D x T must
    be n."""
    d, t = cfg.mesh.data, cfg.mesh.table
    if d == -1 and t == -1:
        d, t = n, 1
    elif d == -1:
        d = n // t
    elif t == -1:
        t = n // d
    if d * t != n:
        raise ValueError(f"mesh {d}x{t} != {n} devices")
    return d, t


def make_mesh(cfg, world: Optional[int] = None, rank: Optional[int] = None,
              device="cpu") -> Mesh:
    """The mesh of `cfg.mesh` over the joined world (or `world` ranks,
    without groups, when no world is joined). Every rank of a joined
    world must call it: it creates the axes' process groups, all of them
    on every rank, in one order."""
    joined = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if joined else 1
    if rank is None:
        rank = dist.get_rank() if joined else 0
    D, T = mesh_shape(cfg, world)
    mesh = Mesh(data=D, table=T, rank=rank, device=torch.device(device))
    if joined:
        for t in range(T):
            g = dist.new_group([d * T + t for d in range(D)])
            if t == mesh.t:
                mesh.data_group = g
        for d in range(D):
            g = dist.new_group([d * T + t for t in range(T)])
            if d == mesh.d:
                mesh.table_group = g
    return mesh


def slot_range(mesh: Mesh, num_slots: int, layout: str) -> tuple[int, int]:
    """[lo, hi) of the slots this rank owns in `layout`."""
    n = mesh.owners(layout)
    check_divisible(num_slots, mesh)
    per = num_slots // n
    o = mesh.owner_index(layout)
    return o * per, (o + 1) * per


def check_divisible(num_slots: int, mesh: Mesh) -> None:
    """The divisibility rule of `state_shardings`: every table's slot
    count splits evenly over the whole mesh."""
    if num_slots % mesh.size != 0:
        raise ValueError(
            f"table slot count {num_slots} is not divisible by the mesh size "
            f"{mesh.size} ({dict(mesh.shape)}); pick data.log2_slots "
            "so 2^log2_slots is a multiple of data*table"
        )


def shard_tensor(x: torch.Tensor, mesh: Mesh, layout: str) -> torch.Tensor:
    """This rank's rows of a whole table or optimizer leaf (a scalar leaf
    whole)."""
    if x.ndim == 0:
        return x
    lo, hi = slot_range(mesh, x.shape[0], layout)
    return x[lo:hi].clone()
