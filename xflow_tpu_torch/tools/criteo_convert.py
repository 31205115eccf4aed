"""Pack libffm text shards into `.xfc` shard caches: the `cache`
subcommand of `xflow_tpu/tools/criteo_convert.py`.

    python -m xflow_tpu_torch.tools.criteo_convert cache PREFIX \
        [--log2-slots 22] [--hash-salt 0] [--max-nnz 32] [--cache-dir D] [--force]

Reads every `<PREFIX>-NNNNN` shard once (the native parser), writes
`<shard>.xfc` beside it (or under `--cache-dir`) and prints one JSON line
{"shards", "rows", "bytes", "skipped"}; a cache already fresh for these
parameters is skipped unless `--force`. The hash parameters are baked
into the stored slots: they must match the training run's `data.*`
values, or the run finds the cache stale. The caches are byte-identical
to the JAX package's. The raw Criteo / Avazu converter is not ported.
"""

from __future__ import annotations

import argparse
import json
import sys


def cache_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="criteo_convert cache",
        description="pack <prefix>-NNNNN libffm shards into .xfc binary caches "
                    "(pre-hashed, crc32-digested, memory-mapped at train time)",
    )
    ap.add_argument("prefix", help="libffm shard prefix (reads <prefix>-NNNNN)")
    ap.add_argument("--log2-slots", type=int, default=22,
                    help="table size the slots fold into (data.log2_slots)")
    ap.add_argument("--hash-salt", type=int, default=0,
                    help="feature-hash salt (data.hash_salt)")
    ap.add_argument("--max-nnz", type=int, default=32,
                    help="padded per-row feature capacity (data.max_nnz)")
    ap.add_argument("--cache-dir", default="",
                    help="where .xfc files go ('' = beside each shard; data.cache_dir)")
    ap.add_argument("--force", action="store_true",
                    help="rebuild caches that are already fresh")
    args = ap.parse_args(argv)
    from xflow_tpu_torch.config import Config, override
    from xflow_tpu_torch.data.shardcache import build_cache

    cfg = override(Config(), **{
        "data.log2_slots": args.log2_slots,
        "data.hash_salt": args.hash_salt,
        "data.max_nnz": args.max_nnz,
        "data.cache_dir": args.cache_dir,
    }).data
    print(json.dumps(build_cache(args.prefix, cfg, force=args.force)))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["cache"]:
        return cache_main(argv[1:])
    print("usage: python -m xflow_tpu_torch.tools.criteo_convert cache PREFIX [options]\n"
          "(the port has only the `cache` subcommand; the raw Criteo / Avazu "
          "converter is python -m xflow_tpu.tools.criteo_convert)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
