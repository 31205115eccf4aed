"""The one pCTR forward that offline evaluation and online serving share
(`xflow_tpu/models/predict.py`): ``reference_pctr(model(tables, batch))``.
`evaluate.py` feeds it sorted-plan batches, `serve/runner.py` row-major
ones; the model dispatches on the batch's keys.
"""

from __future__ import annotations

from typing import Callable

import torch

from xflow_tpu_torch.metrics import reference_pctr
from xflow_tpu_torch.models.base import Model


def predict_fn(tables: dict, batch: dict, model: Model) -> torch.Tensor:
    """(tables, batch tensors) -> pctr [B] (the reference's clamped σ)."""
    with torch.no_grad():
        return reference_pctr(model(tables, batch))


def make_predict_fn(model: Model) -> Callable:
    """pctr_step(tables, batch) -> pctr [B], bound to `model`."""

    def step(tables: dict, batch: dict) -> torch.Tensor:
        return predict_fn(tables, batch, model)

    return step
