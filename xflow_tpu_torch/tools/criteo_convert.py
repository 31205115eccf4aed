"""Criteo / Avazu raw rows to libffm shards, and libffm shards to `.xfc`
shard caches: the port's copy of `xflow_tpu/tools/criteo_convert.py`
(standard library only; the shards and caches are byte-identical to the
JAX tool's).

    python -m xflow_tpu_torch.tools.criteo_convert RAW OUT_PREFIX [--shards 8] \
        [--format criteo|avazu] [--limit N] [--no-header] [--cache [cache options]]
    python -m xflow_tpu_torch.tools.criteo_convert cache PREFIX \
        [--log2-slots 22] [--hash-salt 0] [--max-nnz 32] [--cache-dir D] [--force]

The raw converter streams Criteo display-advertising TSV (`label \\t
I1..I13 \\t C1..C26`) or Avazu CSV (`id,click,col..`; `-` reads stdin)
into `<OUT_PREFIX>-%05d` libffm shards, round-robin by row, in one pass
at constant memory, and prints {"rows", "skipped", "fields"[, "cache"]}:

- integer feature Ii (field i): token ``i:I<i>_<bucket>:1`` with
  ``bucket = floor(log2(v+1))`` for v >= 0 and ``NEG`` below 0;
- categorical feature Cj (field 13+j): ``f:C<f>_<value>:1``; Avazu's
  columns after `click`: ``f:A<f>_<value>:1``;
- a missing value gives no token; a row of the wrong width, a label
  other than 0/1, or no token at all is skipped and counted.

The field is folded into the feature text because the trainer hashes
the feature token alone: the same value in two fields would share a
slot. A raw value holding whitespace, ':' or '%' is escaped byte by byte
as ``%XX`` (injective: a clean value cannot collide with an escaped
one). Avazu's first line sets the column count; with the header rule
(default) it is the header and is dropped, with `--no-header` it is
converted as data. Every shard stays open for the run, so the shard
count is checked against the process's open-file limit before any file
is opened.

`cache` reads every `<PREFIX>-NNNNN` shard once (the native parser) and
writes `<shard>.xfc` beside it (or under `--cache-dir`), printing
{"shards", "rows", "bytes", "skipped"}; a cache already fresh for these
parameters is skipped unless `--force`. The hash parameters are baked
into the stored slots: they must match the training run's `data.*`
values, or the run finds the cache stale.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from typing import Iterator, Optional

N_INT, N_CAT = 13, 26

# the libffm token's structural characters: a raw value holding one would
# be mis-tokenized downstream, so each is escaped (and '%' itself)
_BAD = set(" \t\n\r\x0b\x0c:%")


def _sanitize(v: str) -> str:
    if not any(c in _BAD for c in v):
        return v
    return "".join("%%%02X" % ord(c) if c in _BAD else c for c in v)


def criteo_line_to_libffm(line: str) -> Optional[str]:
    """One raw Criteo TSV line -> one libffm line (None = malformed)."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) != 1 + N_INT + N_CAT:
        return None
    label = parts[0]
    if label not in ("0", "1"):
        return None
    toks = []
    for i in range(N_INT):
        v = parts[1 + i]
        if not v:
            continue
        try:
            iv = int(v)
        except ValueError:
            return None
        bucket = "NEG" if iv < 0 else str(int(math.log2(iv + 1)))
        toks.append("%d:I%d_%s:1" % (i, i, bucket))
    for j in range(N_CAT):
        v = parts[1 + N_INT + j]
        if not v:
            continue
        f = N_INT + j
        toks.append("%d:C%d_%s:1" % (f, f, _sanitize(v)))
    if not toks:
        return None
    return "%s\t%s" % (label, " ".join(toks))


def avazu_line_to_libffm(line: str, n_fields: int) -> Optional[str]:
    """One Avazu CSV line (id,click,col2..) -> libffm (None = malformed)."""
    parts = line.rstrip("\n").split(",")
    if len(parts) != n_fields + 2 or parts[1] not in ("0", "1"):
        return None
    toks = ["%d:A%d_%s:1" % (f, f, _sanitize(v)) for f, v in enumerate(parts[2:]) if v]
    if not toks:
        return None
    return "%s\t%s" % (parts[1], " ".join(toks))


def check_fd_budget(num_shards: int) -> None:
    """Raise when `num_shards` open files would pass the process's limit
    (less 16 for the rest of the process)."""
    try:
        import resource
    except ImportError:  # not POSIX: the OS reports it
        return
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if soft != resource.RLIM_INFINITY and num_shards > soft - 16:
        raise ValueError(
            f"--shards {num_shards} needs {num_shards} simultaneously "
            f"open files but the process fd limit is {soft}; raise it "
            f"(`ulimit -n {num_shards + 64}`) or convert in chunks"
        )


def convert(src, out_prefix: str, num_shards: int, fmt: str = "criteo", limit: int = 0,
            header: bool = True) -> dict:
    """Stream the lines of `src` into `<out_prefix>-%05d` libffm shards,
    round-robin by row, stopping after `limit` rows (0: all). Returns
    {"rows", "skipped", "fields"}. Avazu's first line sets the column
    count, and is converted as data too when `header` is false."""
    check_fd_budget(num_shards)
    outs = [open("%s-%05d" % (out_prefix, s), "w") for s in range(num_shards)]
    rows = skipped = 0
    n_fields = N_INT + N_CAT
    avazu_cols = None
    pending = []
    try:
        it: Iterator[str] = iter(src)
        if fmt == "avazu":
            first = next(it, "")
            avazu_cols = max(0, len(first.rstrip("\n").split(",")) - 2)
            n_fields = avazu_cols
            if not header and first:
                pending.append(first)
        for line in itertools.chain(pending, it):
            conv = (criteo_line_to_libffm(line) if fmt == "criteo"
                    else avazu_line_to_libffm(line, avazu_cols))
            if conv is None:
                skipped += 1
                continue
            outs[rows % num_shards].write(conv + "\n")
            rows += 1
            if limit and rows >= limit:
                break
    finally:
        for f in outs:
            f.close()
    return {"rows": rows, "skipped": skipped, "fields": n_fields}


def _add_cache_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--log2-slots", type=int, default=22,
                    help="table size the slots fold into (data.log2_slots)")
    ap.add_argument("--hash-salt", type=int, default=0,
                    help="feature-hash salt (data.hash_salt)")
    ap.add_argument("--max-nnz", type=int, default=32,
                    help="padded per-row feature capacity (data.max_nnz)")
    ap.add_argument("--cache-dir", default="",
                    help="where .xfc files go ('' = beside each shard; data.cache_dir)")


def _build_cache(prefix: str, args, force: bool) -> dict:
    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.data.shardcache import build_cache

    cfg = override(Config(), **{
        "data.log2_slots": args.log2_slots,
        "data.hash_salt": args.hash_salt,
        "data.max_nnz": args.max_nnz,
        "data.cache_dir": args.cache_dir,
    }).data
    return build_cache(prefix, cfg, force=force)


def cache_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="criteo_convert cache",
        description="pack <prefix>-NNNNN libffm shards into .xfc binary caches "
                    "(pre-hashed, crc32-digested, memory-mapped at train time)",
    )
    ap.add_argument("prefix", help="libffm shard prefix (reads <prefix>-NNNNN)")
    _add_cache_args(ap)
    ap.add_argument("--force", action="store_true",
                    help="rebuild caches that are already fresh")
    args = ap.parse_args(argv)
    print(json.dumps(_build_cache(args.prefix, args, args.force)))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # a literal first argument `cache` is the subcommand; a raw file of
    # that name is passed as ./cache
    if argv[:1] == ["cache"]:
        return cache_main(argv[1:])
    ap = argparse.ArgumentParser(
        description="stream raw Criteo/Avazu into rank-sharded libffm files "
                    "(subcommand `cache`: pack existing libffm shards into "
                    "the binary shard cache)"
    )
    ap.add_argument("src", help="raw file path, or - for stdin (zcat | ...); a file "
                                "literally named 'cache' must be passed as ./cache "
                                "(bare 'cache' selects the subcommand)")
    ap.add_argument("out_prefix", help="writes <out_prefix>-%%05d")
    ap.add_argument("--shards", type=int, default=8,
                    help="one per training rank (rank k reads shard k)")
    ap.add_argument("--format", default="criteo", choices=("criteo", "avazu"))
    ap.add_argument("--limit", type=int, default=0, help="stop after N rows (smoke runs)")
    ap.add_argument("--no-header", action="store_true",
                    help="avazu: the stream has no CSV header (pre-split chunks); "
                         "the first line is data")
    ap.add_argument("--cache", action="store_true",
                    help="also build the binary shard cache in the same invocation "
                         "(a follow-up `criteo_convert cache <out_prefix>`)")
    _add_cache_args(ap)
    args = ap.parse_args(argv)
    src = sys.stdin if args.src == "-" else open(args.src)
    try:
        stats = convert(src, args.out_prefix, args.shards, args.format, args.limit,
                        header=not args.no_header)
    finally:
        if src is not sys.stdin:
            src.close()
    if args.cache:
        stats["cache"] = _build_cache(args.out_prefix, args, force=True)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
