"""Carry parameter tables and training state across from the JAX package.

The JAX package may hold a vector table packed ``[S/8, 8K]`` (a layout
that exists for the TPU's (8, 128) memory tiling); the port holds every
table logical ``[S, K]``. The unpack is a free reshape on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.ops.sorted_table import pack_of


def table_shapes(cfg: Config) -> dict:
    """{table name: logical shape} of the configured model."""
    S = cfg.num_slots
    return {
        name: (S,) if trailing == () else (S, trailing[0])
        for name, trailing in get_model(cfg.model.name).table_specs(cfg).items()
    }


def _logical_tensor(arr, name: str, shape: tuple, device) -> torch.Tensor:
    arr = np.asarray(arr, np.float32)
    if len(shape) == 2 and pack_of(arr, shape[1]) != 1:
        arr = arr.reshape(shape)
    if arr.shape != shape:
        raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a jax array
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def tables_from_jax(tables: dict, cfg: Config, device="cuda") -> dict:
    """{name: host array in either layout} -> {name: float32 tensor in the
    logical layout on `device`}. Raises on a missing table or a shape
    that fits neither layout."""
    out = {}
    for name, shape in table_shapes(cfg).items():
        if name not in tables:
            raise KeyError(f"table {name!r} missing (have {sorted(tables)})")
        out[name] = _logical_tensor(tables[name], f"table {name!r}", shape, device)
    return out


def state_from_jax(tables: dict, opt_state: dict, step, cfg: Config, device="cuda"):
    """A JAX `TrainState`'s arrays (tables and optimizer leaves, packed
    or logical) -> the port's `TrainState` on `device`, every leaf
    logical. Raises on a missing table or leaf and on a shape that fits
    neither layout."""
    from xflow_tpu_torch.train.state import TrainState

    shapes = table_shapes(cfg)
    opt = {}
    for name, st in opt_state.items():
        if name not in shapes:
            raise KeyError(f"optimizer state for unknown table {name!r}")
        opt[name] = {
            leaf: _logical_tensor(v, f"opt/{name}/{leaf}", shapes[name], device)
            for leaf, v in st.items()
        }
    return TrainState(tables_from_jax(tables, cfg, device), opt, int(np.asarray(step)))
