"""Sparse batch schema: fixed-capacity padded COO on the host.

- ``slots``  int32 ``[B, F]`` — table slot per feature occurrence (pad 0)
- ``fields`` int32 ``[B, F]`` — libffm field id (pad 0)
- ``mask``   float32 ``[B, F]`` — 1.0 for real occurrences
- ``labels`` float32 ``[B]`` — {0.0, 1.0}
- ``row_mask`` float32 ``[B]`` — 1.0 for real rows (a short last batch
  is padded and masked, not dropped)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SparseBatch(NamedTuple):
    slots: np.ndarray
    fields: np.ndarray
    mask: np.ndarray
    labels: np.ndarray
    row_mask: np.ndarray


def make_batch(
    rows_fields: list,
    rows_slots: list,
    labels: list,
    batch_size: int,
    max_nnz: int,
) -> SparseBatch:
    """Pack ragged rows into one padded SparseBatch. Rows longer than
    ``max_nnz`` keep their first ``max_nnz`` features."""
    n = len(labels)
    if n > batch_size:
        raise ValueError(f"{n} rows do not fit a batch of {batch_size}")
    slots = np.zeros((batch_size, max_nnz), dtype=np.int32)
    fields = np.zeros((batch_size, max_nnz), dtype=np.int32)
    mask = np.zeros((batch_size, max_nnz), dtype=np.float32)
    lab = np.zeros((batch_size,), dtype=np.float32)
    row_mask = np.zeros((batch_size,), dtype=np.float32)
    for i in range(n):
        k = min(len(rows_slots[i]), max_nnz)
        slots[i, :k] = rows_slots[i][:k]
        fields[i, :k] = rows_fields[i][:k]
        mask[i, :k] = 1.0
        lab[i] = labels[i]
        row_mask[i] = 1.0
    return SparseBatch(slots=slots, fields=fields, mask=mask, labels=lab, row_mask=row_mask)
