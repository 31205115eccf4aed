"""Packed shard cache, `.xfc` format v1, after `xflow_tpu/data/shardcache.py`:
a text shard parsed and hashed once, its padded rows written beside it,

    text shard <prefix>-NNNNN   --write-->   <prefix>-NNNNN.xfc

so batch assembly becomes an offset computation over `np.memmap` views:
no parsing and no hashing on the training path. The cached rows are the
rows the parser produces (the same truncation and padding, feature-less
rows kept), so cache batches are bitwise equal to text batches, and a
cache written by either package is byte-identical to the other's and
readable by it (tests/test_torch_shardcache.py).

On-disk format v1 (integers little-endian):

    [0:4]   magic  b"XFSC"
    [4:8]   u32 version (1)
    [64:]   sections, each 64-byte aligned, row-major:
              slots  int32   [rows, max_nnz]
              fields int32   [rows, max_nnz]
              mask   float32 [rows, max_nnz]
              labels float32 [rows]
    [tail]  footer JSON (sorted keys), then u32 footer length, then
            magic b"XFSC"; the last 8 bytes locate the footer, so the
            writer streams the sections in one pass and still records
            their crc32 digests.

The footer carries the hash parameters the slots were folded with
(`log2_slots`, `hash_salt`, `max_nnz`), the source shard's byte size
(the staleness check) and one crc32 digest a section. A digest mismatch
raises `ShardCacheDigestError`; the pipeline quarantines the cache and
reads the shard as text (`data/pipeline.py`). Nothing run-local is
written into the file: converting the same input twice gives the same
bytes.

`CALLS["batches"]` counts the batches read from caches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import struct
import sys
import zlib
from typing import TYPE_CHECKING, Iterator, Optional

import numpy as np

from xflow_tpu_torch.data.schema import SparseBatch

if TYPE_CHECKING:  # the config type only
    from xflow_tpu_torch.config import DataConfig

MAGIC = b"XFSC"
VERSION = 1
ALIGN = 64
CACHE_SUFFIX = ".xfc"
# section order is part of the format: the writer streams them at
# fixed offsets computed from the row count alone
SECTIONS = ("slots", "fields", "mask", "labels")
_DTYPES = {
    "slots": np.int32,
    "fields": np.int32,
    "mask": np.float32,
    "labels": np.float32,
}
_CRC_CHUNK = 4 << 20  # digest verification reads 4 MiB at a time

CALLS = {"batches": 0}


def reset_calls() -> None:
    CALLS["batches"] = 0


class ShardCacheError(RuntimeError):
    """A cache file that cannot be used (truncated, bad magic/version,
    unreadable footer). The pipeline treats this like a digest
    mismatch: quarantine + text fallback, never a crash."""


class ShardCacheDigestError(ShardCacheError):
    """A section's bytes no longer match the crc32 digest the footer
    recorded at write time — silent corruption (bit rot, torn copy).
    Carries `section` so the quarantine record can name it."""

    def __init__(self, msg: str, section: str = "?"):
        super().__init__(msg)
        self.section = section


class ShardCacheStale(ShardCacheError):
    """The cache does not match the current config or source file
    (different hash parameters, the text shard changed size) — not
    corruption, but not usable either. `reason` says why."""


def cache_path_for(text_path: str, cache_dir: str = "") -> str:
    """Where `text_path`'s cache lives: an `.xfc` sibling by default,
    or `<cache_dir>/<basename>-<pathhash>.xfc` when `data.cache_dir`
    is set (a fast local disk for caches of shards on slow shared
    storage). The short hash of the ABSOLUTE source path keys caches
    from different datasets apart — every converter emits
    `<prefix>-NNNNN` names, so a shared cache dir keyed on basename
    alone would let /data/a/train-00000 and /data/b/train-00000
    clobber (or, at equal byte sizes, silently serve) each other. The
    cost: the same dataset reached via a different mount/symlink path
    rebuilds rather than reuses — the safe direction."""
    if cache_dir:
        import hashlib

        tag = hashlib.sha1(
            os.path.abspath(text_path).encode("utf-8")
        ).hexdigest()[:10]
        base = os.path.basename(text_path)
        return os.path.join(cache_dir, f"{base}-{tag}{CACHE_SUFFIX}")
    return text_path + CACHE_SUFFIX


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _layout(rows: int, max_nnz: int) -> tuple[dict, int]:
    """{section: (offset, shape, nbytes)}, data end — from the row
    count alone, which is what lets the writer stream."""
    out = {}
    off = ALIGN  # sections start past the 8-byte prologue, aligned
    for name in SECTIONS:
        shape = (rows,) if name == "labels" else (rows, max_nnz)
        nbytes = int(np.prod(shape, dtype=np.int64)) * 4
        out[name] = (off, shape, nbytes)
        off = _align(off + nbytes)
    return out, off


def _crc(running: int, arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes(), running)


def write_shard_cache(
    text_path: str, cfg: DataConfig, cache_path: str = ""
) -> dict:
    """Parse one libffm text shard ONCE and write its packed cache;
    returns {'rows': n, 'bytes': total}.

    Streaming and constant-memory: the row count is taken up front with
    the parser-matched counter (`native_count_rows`), section offsets
    follow from it, and parsed chunks are written straight into an `np.memmap` over
    the target region while the per-section crc32 digests accumulate.
    The write is atomic (temp + rename): a crashed build never leaves a
    file `open_shard_cache` would accept.

    Parsing goes through the exact `_raw_batch_iterator` path the
    trainer uses (the native parser) with the cache branch forced off,
    so the stored rows ARE the rows a text-path run would have trained
    on, padding and truncation included.
    """
    from xflow_tpu_torch.data.native import native_count_rows
    from xflow_tpu_torch.data.pipeline import _raw_batch_iterator

    cache_path = cache_path or cache_path_for(text_path, cfg.cache_dir)
    # force the text path (no cache recursion) and parse in
    # writer-sized chunks regardless of the train batch size
    wcfg = dataclasses.replace(cfg, cache="off")
    chunk = 8192
    rows = native_count_rows(text_path)
    layout, data_end = _layout(rows, cfg.max_nnz)
    parent = os.path.dirname(cache_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = "%s.tmp.%d" % (cache_path, os.getpid())
    crcs = {name: 0 for name in SECTIONS}
    pos = 0
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", VERSION))
            f.truncate(data_end)
        mms = {
            name: np.memmap(
                tmp, dtype=_DTYPES[name], mode="r+",
                offset=layout[name][0], shape=layout[name][1],
            )
            for name in SECTIONS
        } if rows else {}
        for batch in _raw_batch_iterator(text_path, wcfg, batch_size=chunk):
            n = int(np.asarray(batch.row_mask).sum())
            if n == 0:
                continue
            if pos + n > rows:
                raise ShardCacheError(
                    f"{text_path!r}: parser produced more rows than the "
                    f"counter predicted ({pos + n} > {rows}) — the file "
                    "changed mid-build, or the counter/parser predicates "
                    "disagree (bug)"
                )
            for name in SECTIONS:
                arr = np.asarray(getattr(batch, name))[:n]
                mms[name][pos : pos + n] = arr
                crcs[name] = _crc(crcs[name], arr)
            pos += n
        if pos != rows:
            raise ShardCacheError(
                f"{text_path!r}: counted {rows} row(s) but the parser "
                f"produced {pos} — the file changed mid-build, or the "
                "counter/parser predicates disagree (bug)"
            )
        for mm in mms.values():
            mm.flush()
        del mms
        footer = {
            "version": VERSION,
            "rows": rows,
            "max_nnz": int(cfg.max_nnz),
            "log2_slots": int(cfg.log2_slots),
            "hash_salt": int(cfg.hash_salt),
            "source": os.path.basename(text_path),
            "source_bytes": os.path.getsize(text_path),
            "sections": [
                {
                    "name": name,
                    "dtype": np.dtype(_DTYPES[name]).name,
                    "shape": list(layout[name][1]),
                    "offset": layout[name][0],
                    "nbytes": layout[name][2],
                    "crc32": "crc32:%08x" % (crcs[name] & 0xFFFFFFFF),
                }
                for name in SECTIONS
            ],
        }
        blob = json.dumps(footer, sort_keys=True, separators=(",", ":")).encode()
        with open(tmp, "r+b") as f:
            f.seek(data_end)
            f.write(blob)
            f.write(struct.pack("<I", len(blob)))
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cache_path)  # atomic commit
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"rows": rows, "bytes": os.path.getsize(cache_path)}


def build_cache(prefix: str, cfg: DataConfig, force: bool = False) -> dict:
    """Cache every existing `<prefix>-NNNNN` text shard. Shards whose
    cache is already fresh for this config are skipped unless `force`
    (incremental rebuilds after appending shards). Returns
    {'shards': n, 'rows': total, 'bytes': total, 'skipped': m}."""
    from xflow_tpu_torch.data.libffm import available_shards

    paths = available_shards(prefix)
    if not paths:
        raise FileNotFoundError(
            f"{prefix!r}: no <prefix>-NNNNN text shards to cache"
        )
    shards = rows = total = skipped = 0
    for p in paths:
        cpath = cache_path_for(p, cfg.cache_dir)
        if not force and os.path.exists(cpath):
            try:
                sc = open_shard_cache(cpath)
                sc.check_compatible(cfg, text_path=p)
                # digests too: an explicit cache build is the operator's
                # REPAIR path for a bit-rotted cache — skipping on
                # staleness alone would report a corrupt file as fresh
                # and leave every train run on the quarantine fallback
                sc.verify()
                skipped += 1
                continue
            except ShardCacheError:
                pass  # stale/corrupt: rebuild
        stats = write_shard_cache(p, cfg, cpath)
        shards += 1
        rows += stats["rows"]
        total += stats["bytes"]
    return {"shards": shards, "rows": rows, "bytes": total, "skipped": skipped}


class ShardCache:
    """An open cache file: parsed footer + lazily-created memmaps.

    `verify()` streams every section through crc32 once (GB/s — noise
    against the parse it replaces) and raises `ShardCacheDigestError`
    on the first mismatch; `iter_batches` then yields zero-copy
    `SparseBatch` views."""

    def __init__(self, path: str, footer: dict):
        self.path = path
        self.footer = footer
        self.rows = int(footer["rows"])
        self.max_nnz = int(footer["max_nnz"])
        self._sections = {s["name"]: s for s in footer["sections"]}
        self._mms: Optional[dict] = None

    # ------------------------------------------------------------ access
    def arrays(self) -> dict:
        if self._mms is None:
            self._mms = {
                name: np.memmap(
                    self.path,
                    dtype=np.dtype(sec["dtype"]),
                    mode="r",
                    offset=int(sec["offset"]),
                    shape=tuple(sec["shape"]),
                )
                for name, sec in self._sections.items()
            }
        return self._mms

    # ------------------------------------------------------- validation
    def check_compatible(
        self, cfg: DataConfig, text_path: str = ""
    ) -> None:
        """Raise ShardCacheStale unless this cache was written with the
        run's hash parameters and still matches its source file. The
        slots were folded at write time — a different `log2_slots` or
        `hash_salt` would need a re-hash, which is exactly the work the
        cache exists to not do; `max_nnz` fixes the padded row shape.
        Staleness: the source's byte size is compared when the text
        shard is still present (the normal layout — the text file is
        both the fallback and the shard-existence marker); a cache
        whose source grew or shrank is stale, not corrupt."""
        f = self.footer
        for key in ("log2_slots", "hash_salt", "max_nnz"):
            want = int(getattr(cfg, key))
            got = int(f.get(key, -1))
            if got != want:
                raise ShardCacheStale(
                    f"{self.path!r}: cache {key}={got} != config "
                    f"{key}={want}; rebuild with "
                    "`python -m xflow_tpu_torch.tools.criteo_convert cache ...`"
                )
        if text_path and os.path.exists(text_path):
            size = os.path.getsize(text_path)
            if size != int(f.get("source_bytes", -1)):
                raise ShardCacheStale(
                    f"{self.path!r}: source {text_path!r} is "
                    f"{size} bytes but the cache was built from "
                    f"{f.get('source_bytes')} — the text shard changed; "
                    "rebuild the cache"
                )

    def verify(self) -> None:
        """Stream every section through crc32 against the footer digests
        (the checkpoints' convention). One full sequential read per open,
        far cheaper than the parse it replaces."""
        with open(self.path, "rb") as fh:
            for name, sec in self._sections.items():
                fh.seek(int(sec["offset"]))
                left = int(sec["nbytes"])
                running = 0
                while left > 0:
                    block = fh.read(min(left, _CRC_CHUNK))
                    if not block:
                        raise ShardCacheDigestError(
                            f"{self.path!r}: section {name!r} truncated "
                            f"({left} byte(s) missing)",
                            section=name,
                        )
                    running = zlib.crc32(block, running)
                    left -= len(block)
                got = "crc32:%08x" % (running & 0xFFFFFFFF)
                if got != sec.get("crc32"):
                    raise ShardCacheDigestError(
                        f"{self.path!r}: section {name!r} digest mismatch "
                        f"(stored {sec.get('crc32')}, computed {got}) — "
                        "silent corruption; the shard will be quarantined "
                        "and the text path used instead",
                        section=name,
                    )

    # -------------------------------------------------------- iteration
    def iter_batches(self, batch_size: int, profiler=None) -> Iterator[SparseBatch]:
        """Padded SparseBatches as zero-copy memmap slices: a full batch is
        five views into the file; the last partial batch is the one copy,
        padded as `make_batch` pads it, so cache batches are bitwise equal
        to text batches. `profiler` times each batch's slicing as the
        `cache_read` stage."""
        mms = self.arrays()
        slots, fields, mask, labels = (
            mms["slots"], mms["fields"], mms["mask"], mms["labels"],
        )
        B = int(batch_size)
        full, rem = self.rows // B, self.rows % B
        ones = np.ones((B,), np.float32)
        stage = profiler.stage if profiler is not None else (lambda _: contextlib.nullcontext())
        for i in range(full):
            with stage("cache_read"):
                s = slice(i * B, (i + 1) * B)
                CALLS["batches"] += 1
                b = SparseBatch(slots[s], fields[s], mask[s], labels[s], ones)
            if profiler is not None:
                profiler.count_batch(B)
            yield b
        if rem:
            with stage("cache_read"):
                CALLS["batches"] += 1
                b = self._tail_batch(B, full * B, rem)
            if profiler is not None:
                profiler.count_batch(rem)
            yield b

    def _tail_batch(self, B: int, start: int, n: int) -> SparseBatch:
        mms = self.arrays()
        F = self.max_nnz
        slots = np.zeros((B, F), np.int32)
        fields = np.zeros((B, F), np.int32)
        mask = np.zeros((B, F), np.float32)
        labels = np.zeros((B,), np.float32)
        row_mask = np.zeros((B,), np.float32)
        end = start + n
        slots[:n] = mms["slots"][start:end]
        fields[:n] = mms["fields"][start:end]
        mask[:n] = mms["mask"][start:end]
        labels[:n] = mms["labels"][start:end]
        row_mask[:n] = 1.0
        return SparseBatch(slots, fields, mask, labels, row_mask)


def open_shard_cache(path: str) -> ShardCache:
    """Parse prologue + footer; raise ShardCacheError on anything that
    is not a committed v1 cache file."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) < 8 or head[:4] != MAGIC:
                raise ShardCacheError(f"{path!r}: not a shard cache (bad magic)")
            (version,) = struct.unpack("<I", head[4:8])
            if version != VERSION:
                raise ShardCacheError(
                    f"{path!r}: cache format v{version} (this build reads "
                    f"v{VERSION}); rebuild the cache"
                )
            if size < 16:
                raise ShardCacheError(f"{path!r}: truncated cache file")
            fh.seek(size - 8)
            tail = fh.read(8)
            (flen,) = struct.unpack("<I", tail[:4])
            if tail[4:8] != MAGIC or flen <= 0 or size - 8 - flen < 8:
                raise ShardCacheError(
                    f"{path!r}: missing/garbled footer (interrupted write?)"
                )
            fh.seek(size - 8 - flen)
            footer = json.loads(fh.read(flen).decode("utf-8"))
    except ShardCacheError:
        raise
    except (OSError, ValueError, struct.error, UnicodeDecodeError) as e:
        raise ShardCacheError(f"{path!r}: unreadable cache: {e}") from e
    if not isinstance(footer, dict) or not isinstance(footer.get("sections"), list):
        raise ShardCacheError(f"{path!r}: malformed footer")
    names = {s.get("name") for s in footer["sections"] if isinstance(s, dict)}
    if names != set(SECTIONS):
        raise ShardCacheError(
            f"{path!r}: footer sections {sorted(names)} != {sorted(SECTIONS)}"
        )
    # geometry cross-check: the crc32 digests cover the SECTION bytes,
    # not the footer itself — a flipped digit in a shape/offset/rows
    # field would otherwise survive open+verify and blow up later as a
    # bare ValueError inside the prefetch thread's np.memmap, outside
    # the quarantine net (the 'corruption degrades, never crashes'
    # contract)
    try:
        rows = int(footer.get("rows", -1))
        nnz = int(footer.get("max_nnz", -1))
    except (TypeError, ValueError) as e:
        raise ShardCacheError(f"{path!r}: malformed footer: {e}") from e
    if rows < 0 or nnz <= 0:
        raise ShardCacheError(
            f"{path!r}: footer rows={rows} max_nnz={nnz} out of range"
        )
    for sec in footer["sections"]:
        try:
            name = sec["name"]
            shape = tuple(int(x) for x in sec["shape"])
            offset, nbytes = int(sec["offset"]), int(sec["nbytes"])
            itemsize = np.dtype(sec["dtype"]).itemsize
        except (KeyError, TypeError, ValueError) as e:
            raise ShardCacheError(f"{path!r}: malformed footer: {e}") from e
        want_shape = (rows,) if name == "labels" else (rows, nnz)
        if shape != want_shape:
            raise ShardCacheError(
                f"{path!r}: section {name!r} shape {shape} != {want_shape} "
                "(footer corrupted?)"
            )
        if nbytes != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ShardCacheError(
                f"{path!r}: section {name!r} nbytes {nbytes} inconsistent "
                "with its shape (footer corrupted?)"
            )
        if offset < ALIGN or offset + nbytes > size:
            raise ShardCacheError(
                f"{path!r}: section {name!r} [{offset}, {offset + nbytes}) "
                f"falls outside the {size}-byte file (footer corrupted?)"
            )
    return ShardCache(path, footer)


def resolve_cache(path: str, cfg: DataConfig) -> Optional[ShardCache]:
    """The pipeline's auto-detect seam (data.cache):
    the VERIFIED cache for text shard `path`, or None to take the text
    path. Raising semantics are the policy matrix:

    - `off`: never looked at (the pipeline does not call this).
    - `auto`: a missing cache is simply the text path; a stale one
      (config/source mismatch) warns once per file and falls back; a
      CORRUPT one (bad digest / unreadable) raises
      ShardCacheDigestError / ShardCacheError for the pipeline to
      quarantine and fall back — the caller owns the quarantine sink.
    - `on`: the operator asserted cached input — a missing or stale
      cache raises FileNotFoundError/ShardCacheStale loudly at open.
      Corruption still only raises the digest error: the pipeline's
      fallback keeps even a forced-cache run training (integrity
      failures degrade, never crash).
    """
    cpath = cache_path_for(path, cfg.cache_dir)
    if not os.path.exists(cpath):
        if cfg.cache == "on":
            raise FileNotFoundError(
                f"data.cache=on but {cpath!r} does not exist; build it: "
                f"python -m xflow_tpu_torch.tools.criteo_convert cache <prefix> "
                f"--log2-slots {cfg.log2_slots} --max-nnz {cfg.max_nnz}"
            )
        return None
    sc = open_shard_cache(cpath)  # ShardCacheError -> caller quarantines
    try:
        sc.check_compatible(cfg, text_path=path)
    except ShardCacheStale:
        if cfg.cache == "on":
            raise
        print(
            f"xflow: warning: ignoring stale shard cache {cpath!r} "
            "(config or source changed; rebuild with criteo_convert cache)",
            file=sys.stderr,
        )
        return None
    sc.verify()  # ShardCacheDigestError -> caller quarantines + falls back
    return sc
