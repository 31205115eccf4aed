"""Training state (`xflow_tpu/train/state.py`): parameter tables, the
optimizer state and the step counter, as plain dicts of tensors on one
device. Steps return a new state; they do not update tensors in place.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.models.base import Model
from xflow_tpu_torch.optim.base import Optimizer


class TrainState(NamedTuple):
    tables: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]  # {table: {leaf: tensor}}
    step: int


def init_state(model: Model, optimizer: Optimizer, cfg: Config, device="cuda") -> TrainState:
    """Fresh tables from `train.seed` (a torch.Generator: not JAX's
    bits) and the optimizer's initial state, on `device`."""
    tables = model.init_tables(torch.Generator().manual_seed(cfg.train.seed), device=device)
    return TrainState(tables=tables, opt_state=optimizer.init_state(tables), step=0)
