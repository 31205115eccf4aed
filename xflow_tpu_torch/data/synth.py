"""Deterministic synthetic libffm shards (numpy only): the per-row writer
of `xflow_tpu/data/synth.py::generate_shards`, with the same random
stream, so one seed gives the same file from either package.

Rows have one feature per field; feature ids are globalized per field
(``field * ids_per_field + id``) and labels follow a planted sparse-LR
truth plus Gaussian noise, so a trained model beats AUC 0.5.
"""

from __future__ import annotations

import os

import numpy as np


def generate_shards(
    out_prefix: str,
    num_shards: int,
    rows_per_shard: int,
    num_fields: int = 18,
    ids_per_field: int = 500,
    seed: int = 0,
    noise: float = 1.0,
) -> list[str]:
    """Write `<out_prefix>-%05d` libffm shards; returns their paths."""
    rng = np.random.default_rng(seed)
    truth_rng = np.random.default_rng(seed)
    w_truth = truth_rng.normal(0.0, 1.0, size=(num_fields, ids_per_field))
    value = 1.0 / np.sqrt(num_fields)
    paths = []
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for shard in range(num_shards):
        path = "%s-%05d" % (out_prefix, shard)
        with open(path, "w") as f:
            for _ in range(rows_per_shard):
                ids = rng.integers(0, ids_per_field, size=num_fields)
                logit = w_truth[np.arange(num_fields), ids].sum() + rng.normal(0.0, noise)
                label = 1 if logit > 0 else 0
                toks = " ".join(
                    "%d:%d:%.4f" % (fg, fg * ids_per_field + ids[fg], value)
                    for fg in range(num_fields)
                )
                f.write("%d\t%s\n" % (label, toks))
        paths.append(path)
    return paths
