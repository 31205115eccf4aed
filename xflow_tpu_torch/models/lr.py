"""Sparse logistic regression (`xflow_tpu/models/lr.py`): logit = Σᵢ wᵢ
over the row's masked occurrences, one gather-sum through `batch_rows`
(the host-deduped two-level gather when the batch carries it, see
`data.dedup`). LR has no sorted-layout path, in the JAX package either:
its batches are row-major, its gather is advanced indexing
(`table[slots.long()]`) and its gradient that indexing's backward,
`index_put_` with accumulate, so it runs no hand-written kernel.
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.models.base import Model, register_model
from xflow_tpu_torch.ops.sorted_table import batch_rows


@register_model
class LR(Model):
    name = "lr"

    @staticmethod
    def table_specs(cfg):
        return {"w": ()}

    def forward(self, tables: dict, batch: dict) -> torch.Tensor:
        return (batch_rows(tables["w"], batch) * batch["mask"]).sum(dim=-1)
