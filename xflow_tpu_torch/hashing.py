"""Feature hashing: salted FNV-1a 64 over the feature-id token bytes, then
a splitmix-style mix folded into ``2**log2_slots``. The same function as
`xflow_tpu/hashing.py` and its native parser, so a feature lands in the
same table slot in both packages."""

from __future__ import annotations

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
_FINALIZE_MUL = 0xD6E8FEB86659FD93


def fnv1a64(data: bytes, salt: int = 0) -> int:
    """Salted FNV-1a 64-bit hash."""
    h = (FNV_OFFSET ^ (salt & _MASK64)) & _MASK64
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & _MASK64
    return h


def slot_of(key: int, log2_slots: int) -> int:
    """Map a 64-bit key to a table slot (xor-shift, multiply, xor-shift,
    then mask), so every bit of the hash reaches the slot index."""
    x = (key ^ (key >> 32)) & _MASK64
    x = (x * _FINALIZE_MUL) & _MASK64
    x ^= x >> 32
    return x & ((1 << log2_slots) - 1)
