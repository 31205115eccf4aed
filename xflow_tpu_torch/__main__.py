"""Command line of the PyTorch port.

    python -m xflow_tpu_torch evaluate --checkpoint-dir D --test F \
        [--model fm] [--batch-size N] [--log2-slots N] [--device cuda] [--set k=v ...]

Loads the newest loadable committed checkpoint under D, evaluates libffm
file F and prints one JSON line {"auc", "logloss", "step", "device"}.
Flag names follow `python -m xflow_tpu`.
"""

from __future__ import annotations

import argparse
import json
import sys

MODEL_INDEX = {"0": "lr", "1": "fm", "2": "mvm"}


def build_config(args):
    from xflow_tpu_torch.config import Config, override

    pairs = {"train.checkpoint_dir": args.checkpoint_dir, "data.test_path": args.test}
    if args.model:
        pairs["model.name"] = MODEL_INDEX.get(args.model, args.model)
    if args.batch_size is not None:
        pairs["data.batch_size"] = args.batch_size
    if args.log2_slots is not None:
        pairs["data.log2_slots"] = args.log2_slots
    for item in args.set:
        k, _, v = item.partition("=")
        pairs[k] = v
    return override(Config(), **pairs)


def cmd_evaluate(args) -> int:
    from xflow_tpu_torch.evaluate import evaluate
    from xflow_tpu_torch.serve.runner import ServeRunner

    cfg = build_config(args)
    runner = ServeRunner(cfg, device=args.device)
    gen = runner.load()
    auc, ll = evaluate(cfg, gen.tables, cfg.data.test_path, device=args.device)
    print(json.dumps({"auc": auc, "logloss": ll, "step": gen.step, "device": args.device}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xflow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("evaluate", help="evaluate a checkpoint on a libffm file")
    ev.add_argument("--checkpoint-dir", required=True)
    ev.add_argument("--test", required=True, help="libffm file to evaluate")
    ev.add_argument("--model", default="fm")
    ev.add_argument("--batch-size", type=int, default=None)
    ev.add_argument("--log2-slots", type=int, default=None)
    ev.add_argument("--device", default="cuda")
    ev.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set model.v_dim=4")
    args = ap.parse_args(argv)
    return cmd_evaluate(args)


if __name__ == "__main__":
    sys.exit(main())
