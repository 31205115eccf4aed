"""ctypes bindings of the port's C++ host data plane (`native/parser.cc`,
a copy of the JAX package's): the sequential and multithreaded libffm
parsers, the row counter, and the O(n) radix-sort planner, after
`xflow_tpu/data/native.py`.

The shared library is built at first use with g++ into
`xflow_tpu_torch/_build/` (gitignored), named by a digest of the source,
written under a temporary name and moved into place with `os.replace`,
so processes racing to build it do no harm. There is no fall back: a
failed build raises with g++'s message. The parsers read `BLOCK_BYTES`
of the file at a time.

`XFLOW_NATIVE_SANITIZE=thread` (or `address,undefined`, any list g++'s
`-fsanitize=` takes) builds it under those sanitizers, with `-g
-fno-omit-frame-pointer`; the value joins the digest, so sanitized and
plain builds never collide. The MT parser's pool is the one concurrent
C++ component. A Python process loads a sanitized library only with the
matching runtime preloaded (`LD_PRELOAD`).

`CALLS` counts the batches the native stream yields and the native
planner's calls, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from typing import TYPE_CHECKING, Iterator

import numpy as np

from xflow_tpu_torch.data.schema import SparseBatch

if TYPE_CHECKING:  # the config type only
    from xflow_tpu_torch.config import DataConfig

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "parser.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_FLAGS = ["-O3", "-std=c++17", "-pthread", "-shared", "-fPIC"]
MAX_THREADS = 16  # the MT parser's cap, as in the C source
BLOCK_BYTES = 2 << 20  # the JAX package's data.block_bytes default
_LIB = None
_LIB_LOCK = threading.Lock()

CALLS = {"stream": 0, "plan": 0}
_CALLS_LOCK = threading.Lock()  # the planning pool's threads count at once


def _count(key: str) -> None:
    with _CALLS_LOCK:
        CALLS[key] += 1


def reset_calls() -> None:
    with _CALLS_LOCK:
        for k in CALLS:
            CALLS[k] = 0


def build_flags() -> list:
    """g++'s flags: `_FLAGS`, after the sanitizers XFLOW_NATIVE_SANITIZE
    names (with debug info and frame pointers) when it is set."""
    sanitize = os.environ.get("XFLOW_NATIVE_SANITIZE", "")
    extra = [f"-fsanitize={sanitize}", "-g", "-fno-omit-frame-pointer"] if sanitize else []
    return extra + _FLAGS


def _build_lib() -> str:
    """Path of the built library, building it when its digest is new.
    Raises RuntimeError with g++'s output when the build fails."""
    flags = build_flags()
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"libxfparser_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        try:
            r = subprocess.run(["g++", *flags, "-o", tmp, _SRC],
                               capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building {_SRC} needs g++: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC} (exit {r.returncode}):\n"
                               f"{r.stderr.strip()}")
        os.replace(tmp, so_path)  # atomic: concurrent builds race benignly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_L, _I, _U64, _VP = ctypes.c_long, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p
_SIGNATURES = {  # name: (restype, argtypes)
    "xf_hash64": (_U64, [ctypes.c_char_p, _L, _U64]),
    "xf_slot": (_U64, [_U64, _I]),
    "xf_parser_open": (_VP, [ctypes.c_char_p, _L]),
    "xf_parser_next_batch": (_L, [_VP, _L, _L, _I, _U64, _I32P, _I32P, _F32P, _F32P, _F32P]),
    "xf_parser_truncated": (_L, [_VP]),
    "xf_parser_close": (None, [_VP]),
    "xf_count_rows": (_L, [ctypes.c_char_p, _L]),
    "xf_mt_open": (_VP, [ctypes.c_char_p, _L, _I, _L, _I, _U64]),
    "xf_mt_next_batch": (_L, [_VP, _L, _I32P, _I32P, _F32P, _F32P, _F32P]),
    "xf_mt_truncated": (_L, [_VP]),
    "xf_mt_close": (None, [_VP]),
    "xf_plan_sorted": (_L, [_I32P, _F32P, _I32P, _L, _L, _L, _L, _L,
                            _I32P, _I32P, _F32P, _I32P, _I32P]),
    "xf_plan_sorted_wire": (_L, [_I32P, _F32P, _I32P, _L, _L, _L, _L, _L,
                                 _I32P, _U16P, _U8P, _U8P, _I32P]),
}


def get_lib() -> ctypes.CDLL:
    """The loaded library with its C signatures (built on first call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIB = lib
    return _LIB


def _plan_sorted_call(slots, mask, fields, num_slots: int, window: int,
                      np_len: int, wire: bool):
    """The marshalling both C plan emitters share; only the output dtypes
    and the entry point differ."""
    lib = get_lib()
    slots = np.ascontiguousarray(slots, np.int32)
    mask_flat = np.ascontiguousarray(mask, np.float32).ravel()
    B, F = slots.shape
    n = B * F
    # C reads n entries from each buffer: a size mismatch must raise here,
    # not become an out-of-bounds read
    if mask_flat.size != n:
        raise ValueError(f"mask size {mask_flat.size} != slots size {n}")
    if fields is not None and np.asarray(fields).size != n:
        raise ValueError(f"fields size {np.asarray(fields).size} != slots size {n}")
    row_dt, mask_dt, f_dt = (
        (np.uint16, np.uint8, np.uint8) if wire else (np.int32, np.float32, np.int32)
    )
    out_slots = np.empty(np_len, np.int32)
    out_row = np.empty(np_len, row_dt)
    out_mask = np.empty(np_len, mask_dt)
    out_fields = np.empty(np_len, f_dt) if fields is not None else None
    win_off = np.empty(num_slots // window + 1, np.int32)
    rowp, maskp, fp = (_U16P, _U8P, _U8P) if wire else (_I32P, _F32P, _I32P)
    fields_c = (np.ascontiguousarray(fields, np.int32) if fields is not None else None)
    fn = lib.xf_plan_sorted_wire if wire else lib.xf_plan_sorted
    rc = fn(
        slots.ctypes.data_as(_I32P), mask_flat.ctypes.data_as(_F32P),
        fields_c.ctypes.data_as(_I32P) if fields_c is not None else None,
        n, F, num_slots, window, np_len,
        out_slots.ctypes.data_as(_I32P), out_row.ctypes.data_as(rowp),
        out_mask.ctypes.data_as(maskp),
        out_fields.ctypes.data_as(fp) if out_fields is not None else None,
        win_off.ctypes.data_as(_I32P),
    )
    _count("plan")
    if rc == -1 and n and (int(slots.min()) < 0 or int(slots.max()) >= num_slots):
        raise ValueError(f"slot out of range [0, {num_slots}): "
                         f"min={int(slots.min())} max={int(slots.max())}")
    if rc == -2:
        raise ValueError(
            "xf_plan_sorted_wire: data violated the wire contract (row >= 2^16, "
            "field >= 2^8, or a non-0/1 mask): the caller's config-derived bounds "
            "disagree with the batch")
    if rc < 0:
        raise ValueError(f"{'xf_plan_sorted_wire' if wire else 'xf_plan_sorted'} "
                         f"failed (rc={rc})")
    return out_slots, out_row, out_mask, out_fields, win_off, int(rc)


def native_plan_sorted(slots, mask, fields, num_slots: int, window: int, np_len: int):
    """The C radix-sort plan (xf_plan_sorted): (sorted_slots, sorted_row,
    sorted_mask, sorted_fields | None, win_off, distinct), the arrays
    bit-identical to the numpy stable argsort plan; `distinct` is the
    number of distinct slots among the unpadded occurrences, counted in
    the same pass. ctypes releases the GIL during the call,
    so stacked sub-batch plans run in parallel host threads."""
    return _plan_sorted_call(slots, mask, fields, num_slots, window, np_len, wire=False)


def native_plan_sorted_wire(slots, mask, fields, num_slots: int, window: int,
                            np_len: int):
    """The C plan emitting the wire dtypes directly (xf_plan_sorted_wire):
    uint16 rows, uint8 mask and fields. The caller has checked the config
    bounds (rows <= 2^16, fields < 2^8); a batch that breaks them, or a
    mask that is not 0/1, raises."""
    return _plan_sorted_call(slots, mask, fields, num_slots, window, np_len, wire=True)


def native_count_rows(path: str) -> int:
    """Rows the native parser produces for `path` (the same line
    predicate, no token parsing); raises on a missing file or read error."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    n = int(get_lib().xf_count_rows(path.encode(), BLOCK_BYTES))
    if n < 0:
        raise OSError(f"xf_count_rows failed for {path}")
    return n


def native_hash(token: bytes, salt: int = 0) -> int:
    return int(get_lib().xf_hash64(token, len(token), salt))


def native_slot(key: int, log2_slots: int) -> int:
    return int(get_lib().xf_slot(key, log2_slots))


def resolve_threads(parser_threads: int) -> int:
    """Parser threads for `data.parser_threads`: the value itself when > 0,
    else one a usable core of this process, capped at MAX_THREADS."""
    if parser_threads > 0:
        return parser_threads
    return max(1, min(len(os.sched_getaffinity(0)), MAX_THREADS))


class _NativeBatchStream:
    """An eagerly opened batch stream (a missing file or a failed build
    raises at construction). One resolved thread takes the sequential
    block-buffered parser; more open the MT parser pool (workers over
    newline-aligned blocks, reassembled in file order: byte-identical
    batches)."""

    def __init__(self, path: str, cfg: DataConfig, batch_size: int):
        self.lib = get_lib()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        threads = resolve_threads(cfg.parser_threads)
        self.mt = threads > 1
        if self.mt:
            self.handle = self.lib.xf_mt_open(path.encode(), BLOCK_BYTES, threads,
                                              cfg.max_nnz, cfg.log2_slots, cfg.hash_salt)
        else:
            self.handle = self.lib.xf_parser_open(path.encode(), BLOCK_BYTES)
        if not self.handle:
            raise OSError(f"native parser open failed for {path}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.closed = False
        self.started = False
        self.truncated = 0

    def __iter__(self) -> Iterator[SparseBatch]:
        # single-shot: iterating again would call into the freed C handle
        if self.started or self.closed:
            raise RuntimeError("native batch stream is single-use; re-open the file")
        self.started = True
        return self._generate()

    def _generate(self) -> Iterator[SparseBatch]:
        cfg, B, F = self.cfg, self.batch_size, self.cfg.max_nnz
        try:
            while True:
                slots = np.zeros((B, F), np.int32)
                fields = np.zeros((B, F), np.int32)
                mask = np.zeros((B, F), np.float32)
                labels = np.zeros((B,), np.float32)
                row_mask = np.zeros((B,), np.float32)
                ptrs = (slots.ctypes.data_as(_I32P), fields.ctypes.data_as(_I32P),
                        mask.ctypes.data_as(_F32P), labels.ctypes.data_as(_F32P),
                        row_mask.ctypes.data_as(_F32P))
                if self.mt:
                    n = self.lib.xf_mt_next_batch(self.handle, B, *ptrs)
                else:
                    n = self.lib.xf_parser_next_batch(self.handle, B, F, cfg.log2_slots,
                                                      cfg.hash_salt, *ptrs)
                if n < 0:
                    raise OSError("native parser I/O error reading batches (ferror)")
                if n == 0:
                    return
                _count("stream")
                yield SparseBatch(slots, fields, mask, labels, row_mask)
                if n < B:
                    return
        finally:
            self.close()

    def close(self) -> None:
        if self.closed:
            return
        if self.mt:
            self.truncated = int(self.lib.xf_mt_truncated(self.handle))
            self.lib.xf_mt_close(self.handle)
        else:
            self.truncated = int(self.lib.xf_parser_truncated(self.handle))
            self.lib.xf_parser_close(self.handle)
        self.closed = True
        if self.truncated:
            print(f"xflow: warning: {self.truncated} feature occurrence(s) truncated by "
                  f"data.max_nnz={self.cfg.max_nnz}", file=sys.stderr)


def native_batch_iterator(path: str, cfg: DataConfig, batch_size: int) -> Iterator[SparseBatch]:
    """Padded `[batch_size, max_nnz]` batches of libffm file `path` by the
    native parser (`cfg.parser_threads` workers); the last partial batch
    is padded and row-masked."""
    return iter(_NativeBatchStream(path, cfg, batch_size))
