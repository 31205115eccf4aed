"""Deterministic synthetic libffm shards (numpy only): the per-row writer
of `xflow_tpu/data/synth.py::generate_shards`, with the same random
stream, so one seed gives the same file from either package.

Rows have one feature per field; feature ids are globalized per field
(``field * ids_per_field + id``) and labels follow a planted sparse-LR
truth plus Gaussian noise, so a trained model beats AUC 0.5.

`generate_shards_bulk` is the chunked writer of
`xflow_tpu/data/synth.py::generate_shards_bulk` for large shards (its
uniform-id, linear-truth case, the same random stream): whole chunks are
sampled at once and formatted by numpy's string kernels.
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


def generate_shards_bulk(
    out_prefix: str,
    num_shards: int,
    rows_per_shard: int,
    num_fields: int = 18,
    ids_per_field: int = 500,
    seed: int = 0,
    noise: float = 1.0,
    chunk_rows: int = 200_000,
) -> tuple[list[str], None]:
    """Write `<out_prefix>-%05d` shards chunk by chunk; returns (paths,
    None), the JAX writer's return with no id tracking."""
    rng = np.random.default_rng(seed)
    w_truth = np.random.default_rng(seed).normal(0.0, 1.0, size=(num_fields, ids_per_field))
    value_suffix = ":%.4f" % (1.0 / np.sqrt(num_fields))
    offsets = (np.arange(num_fields) * ids_per_field)[None, :]
    prefixes = ["%d:" % fg if fg == 0 else " %d:" % fg for fg in range(num_fields)]
    gid_width = len(str(num_fields * ids_per_field - 1))
    add = np.strings.add if hasattr(np, "strings") else np.char.add
    paths = []
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for shard in range(num_shards):
        path = "%s-%05d" % (out_prefix, shard)
        with open(path, "w") as f:
            left = rows_per_shard
            while left > 0:
                c = min(chunk_rows, left)
                left -= c
                ids = rng.integers(0, ids_per_field, size=(c, num_fields))
                logit = w_truth[np.arange(num_fields)[None, :], ids].sum(axis=1)
                logit = logit + rng.normal(0.0, noise, size=c)
                labels = (logit > 0).astype(np.int64)
                gids = ids + offsets
                lines = add(labels.astype("U1"), "\t")
                for fg in range(num_fields):
                    lines = add(lines, prefixes[fg])
                    lines = add(lines, gids[:, fg].astype(f"U{gid_width}"))
                    lines = add(lines, value_suffix)
                f.write("\n".join(lines.tolist()))
                f.write("\n")
        paths.append(path)
    return paths, None
