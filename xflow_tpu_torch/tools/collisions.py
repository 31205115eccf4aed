"""Hash-collision measurement, after `xflow_tpu/tools/collisions.py`.

For libffm files and a slot budget it reports the distinct feature-id
tokens, their distinct 64-bit hashes (collisions before the fold), the
distinct slots after the fold into ``2**log2_slots``, the table's
occupancy and the collision rate 1 - distinct_slots / distinct_tokens,
through the port's hashing (`xflow_tpu_torch/hashing.py`), which is the
JAX package's function.

    python -m xflow_tpu_torch collisions FILE [FILE ...] [--log2-slots N] [--salt N]
"""

from __future__ import annotations

import numpy as np

from xflow_tpu_torch.hashing import fnv1a64, slots_of


def measure(paths: list[str], log2_slots: int, salt: int = 0) -> dict:
    tokens: set[str] = set()
    for path in paths:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t", 1)
                if len(parts) < 2:
                    parts = line.rstrip("\n").split(" ", 1)
                    if len(parts) < 2:
                        continue
                for tok in parts[1].split():
                    pieces = tok.split(":")
                    if len(pieces) >= 2:
                        tokens.add(pieces[1])
    hashes = np.array([fnv1a64(t.encode(), salt) for t in tokens], dtype=np.uint64)
    slots = slots_of(hashes, log2_slots)
    n_tok = len(tokens)
    n_slot = len(np.unique(slots))
    return {
        "distinct_tokens": n_tok,
        "distinct_hash64": len(np.unique(hashes)),
        "distinct_slots": n_slot,
        "log2_slots": log2_slots,
        "table_occupancy": n_slot / float(1 << log2_slots),
        "collision_rate": 1.0 - (n_slot / n_tok) if n_tok else 0.0,
    }
