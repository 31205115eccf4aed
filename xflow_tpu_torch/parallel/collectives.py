"""The `lax` collectives of the JAX engines over `torch.distributed`
(the port's counterpart of `xflow_tpu/parallel/compat.py` and of
`shard_map`'s collectives), one `torch.autograd.Function` each:

| JAX, over one mesh axis | here, over that axis's group |
|---|---|
| `psum`                  | `all_reduce`      (`dist.all_reduce`)         |
| `all_to_all(tiled)`     | `all_to_all`      (`dist.all_to_all_single`)  |
| `psum_scatter(tiled)`   | `reduce_scatter`  (`dist.reduce_scatter_tensor`) |
| `all_gather(tiled)`     | `all_gather`      (`dist.all_gather_single`)  |

The tiled forms split or join dimension 0 in group-rank order.

The backward rules are chosen for a loss that every rank holds whole:
each rank seeds its own copy of the (replicated) loss with 1, and every
collective's backward turns the cotangent this rank holds of its output
into the cotangent of its input:

- `all_reduce`: the identity. Every rank downstream of a sum computes
  the same values from it, so each already holds the sum's whole
  cotangent, and a sum passes it to each addend unchanged.
  (`torch.distributed.nn.functional.all_reduce` sums the cotangents over
  the ranks instead, which scales every gradient under a `table`-axis
  sum by T.)
- `all_to_all`: the same all_to_all (a tiled exchange is its own
  inverse permutation);
- `reduce_scatter`: `all_gather` of the cotangents;
- `all_gather`: this rank's own slice (the gathered rows are used the
  same way on every rank of the group).

`None` as a group means the world. `exchange` moves integer plan buffers
as bytes: NCCL has no 16-bit integer type, so a compact wire array
(uint16 rows, uint8 mask) crosses as uint8 and is viewed back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_into(out, x.contiguous(), group)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not split over {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x.contiguous(), group=group)
    return out


def _a2a0(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not split over {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a0(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.m = group, x.shape[0]
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[i * ctx.m : (i + 1) * ctx.m].contiguous(), None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group (`psum`); backward: the identity."""
    return _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tiled all_to_all on dim 0: chunk j goes to group rank j, and chunk
    j of the output came from group rank j."""
    return _AllToAll.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tiled `psum_scatter` on dim 0: this group rank's chunk of the sum."""
    return _ReduceScatter.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tiled all_gather on dim 0, in group-rank order."""
    return _AllGather.apply(x, group)


def exchange(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_to_all` of an integer or mask buffer, moved as bytes (NCCL
    takes no 16-bit integers) and viewed back to its dtype. Not
    differentiable: plans carry no gradient."""
    x = x.contiguous()
    return _a2a0(x.view(torch.uint8), group).view(x.dtype)


def all_to_all_v(x: torch.Tensor, send: list, recv: list, group=None) -> torch.Tensor:
    """All_to_all with uneven splits on dim 0: `send[j]` rows to group
    rank j, `recv[j]` rows from it (the caller exchanged the counts),
    moved as bytes like `exchange`. Not differentiable."""
    x = x.contiguous()
    inner = tuple(x.shape[1:])
    width = x.element_size()
    for n in inner:
        width *= n
    raw = x.view(torch.uint8).reshape(x.shape[0], width)
    out = torch.empty((sum(recv), width), dtype=torch.uint8, device=x.device)
    dist.all_to_all_single(out, raw, output_split_sizes=[int(v) for v in recv],
                           input_split_sizes=[int(v) for v in send], group=group)
    return out.view(x.dtype).reshape((sum(recv),) + inner)


def reduce_host(values, op: str = "max", group=None, device="cpu") -> list:
    """Elementwise MAX (or SUM) of a short list of host integers over the
    group: one small collective, the same answer on every rank (the
    trainer's per-batch and per-epoch agreements)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return [int(v) for v in t.cpu().tolist()]


def reduce_sum_tensor(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """A non-differentiable sum over the group (statistics, norms)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out
