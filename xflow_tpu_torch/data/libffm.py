"""libffm reader: ``label<TAB>field:feature:value ...`` lines into padded
batches, with the token rules of `xflow_tpu/data/libffm.py` so both
packages parse a file to the same slots and fields:

- the label is C-`strtod`-parsed; label = 1 iff > 1e-7;
- each ``field:feature[:value]`` token gives (field id, slot of the hashed
  feature-id string); the value is never read (features are binary);
- tokens without a ``:`` are skipped; a line without a label separator
  yields nothing.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional

import numpy as np

from xflow_tpu_torch.data.schema import SparseBatch, make_batch
from xflow_tpu_torch.hashing import fnv1a64, slot_of

_NUM_PREFIX = re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_HEX_PREFIX = re.compile(r"^[+-]?0[xX][0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?(?:[pP][+-]?\d+)?")
_INFNAN_PREFIX = re.compile(r"^[+-]?(?:infinity|inf|nan(?:\([a-zA-Z0-9_]*\))?)", re.IGNORECASE)
_ASCII_WS = " \t\r\n\v\f"
_TOKEN_SEP = re.compile(r"[ \t\r\v\f]+")


def _strtod(tok: str) -> float:
    """C strtod semantics: the longest numeric prefix, 0.0 for junk
    (hex floats parse; underscore digit groups stop the number)."""
    tok = tok.strip(_ASCII_WS)
    if "_" not in tok:
        try:
            return float(tok)
        except ValueError:
            pass
    m = _HEX_PREFIX.match(tok)
    if m:
        return float.fromhex(m.group(0))
    m = _INFNAN_PREFIX.match(tok)
    if m:
        return float(re.sub(r"\(.*\)", "", m.group(0)))
    m = _NUM_PREFIX.match(tok)
    return float(m.group(0)) if m else 0.0


def _fgid_i32(x: float) -> int:
    """Field id as int32: nan -> 0, saturating at the int32 range."""
    if x != x:
        return 0
    if x >= 2147483647.0:
        return 2147483647
    if x <= -2147483648.0:
        return -2147483648
    return int(x)


def _split_label(line: str) -> Optional[list[str]]:
    """[label, features] of a libffm line, or None when the line is not an
    example (empty, or no label separator). The one rule of what counts
    as an example: parsing and a resumed run's skip both read it."""
    line = line.strip(_ASCII_WS)
    if not line:
        return None
    parts = line.split("\t", 1)
    if len(parts) == 1:
        parts = line.split(" ", 1)
        if len(parts) == 1:
            return None
    return parts


def parse_line(
    line: str, log2_slots: int, salt: int = 0
) -> Optional[tuple[float, np.ndarray, np.ndarray]]:
    """One libffm line -> (label, fields int32, slots int32), or None for a
    line with no label separator."""
    parts = _split_label(line)
    if parts is None:
        return None
    label = 1.0 if _strtod(parts[0]) > 1e-7 else 0.0
    fields = []
    slots = []
    for tok in _TOKEN_SEP.split(parts[1]):
        pieces = tok.split(":")
        if len(pieces) < 2:
            continue
        fields.append(_fgid_i32(_strtod(pieces[0])))
        slots.append(slot_of(fnv1a64(pieces[1].encode("utf-8"), salt), log2_slots))
    return (
        label,
        np.asarray(fields, dtype=np.int32),
        np.asarray(slots, dtype=np.int32),
    )


def shard_path(prefix: str, rank: int) -> str:
    """Shard naming of the reference and the JAX package: `<prefix>-%05d`."""
    return "%s-%05d" % (prefix, rank)


def iter_examples(
    path: str, log2_slots: int, salt: int = 0, skip: int = 0
) -> Iterator[tuple[float, np.ndarray, np.ndarray]]:
    """Stream (label, fields, slots) examples from a libffm file, after
    passing over its first `skip` examples unparsed."""
    with open(path, "r") as f:
        for line in f:
            if skip > 0:
                skip -= _split_label(line) is not None
                continue
            ex = parse_line(line, log2_slots, salt)
            if ex is not None:
                yield ex


def iter_batches(path: str, dcfg, skip: int = 0) -> Iterator[SparseBatch]:
    """Padded ``[batch_size, max_nnz]`` batches of a libffm file; the last
    partial batch is padded and row-masked. `skip` passes over the first
    `skip` batches (a resumed run's consumed prefix)."""
    bs = dcfg.batch_size
    labels: list = []
    fields: list = []
    slots: list = []
    for label, f, s in iter_examples(path, dcfg.log2_slots, dcfg.hash_salt, skip * bs):
        labels.append(label)
        fields.append(f)
        slots.append(s)
        if len(labels) == bs:
            yield make_batch(fields, slots, labels, bs, dcfg.max_nnz)
            labels, fields, slots = [], [], []
    if labels:
        yield make_batch(fields, slots, labels, bs, dcfg.max_nnz)
