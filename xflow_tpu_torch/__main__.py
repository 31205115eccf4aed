"""Command line of the PyTorch port. Flag names follow `python -m xflow_tpu`.

    python -m xflow_tpu_torch train --train PREFIX [--test PREFIX] [--model lr|fm|mvm] \
        [--epochs N] [--batch-size N] [--optimizer ftrl|sgd] [--log2-slots N] \
        [--checkpoint-dir D] [--device cuda] [--set k=v ...]

Trains on `<PREFIX>-00000` on one device (resuming from the newest
checkpoint under D when there is one), evaluates `<test PREFIX>-00000`
when given, and prints one JSON summary line {"rank", "steps", "epochs",
"examples", "seconds", "examples_per_sec", "last_loss", "occupancy",
"bad_steps", ["auc", "logloss"], "device"}.

    python -m xflow_tpu_torch evaluate --checkpoint-dir D --test F \
        [--model lr|fm|mvm] [--batch-size N] [--log2-slots N] [--device cuda] [--set k=v ...]

Loads the newest loadable committed checkpoint under D, evaluates libffm
file F and prints one JSON line {"auc", "logloss", "step", "device"}.
"""

from __future__ import annotations

import argparse
import json
import sys

MODEL_INDEX = {"0": "lr", "1": "fm", "2": "mvm"}


def build_config(args):
    from xflow_tpu_torch.config import Config, override

    pairs = {}
    if getattr(args, "train", None):
        pairs["data.train_path"] = args.train
    if args.test:
        pairs["data.test_path"] = args.test
    if args.checkpoint_dir:
        pairs["train.checkpoint_dir"] = args.checkpoint_dir
    if args.model:
        pairs["model.name"] = MODEL_INDEX.get(args.model, args.model)
    if getattr(args, "epochs", None) is not None:
        pairs["train.epochs"] = args.epochs
    if args.batch_size is not None:
        pairs["data.batch_size"] = args.batch_size
    if getattr(args, "optimizer", None):
        pairs["optim.name"] = args.optimizer
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


def cmd_train(args) -> int:
    from xflow_tpu_torch.train.trainer import Trainer

    if (args.num_processes or 1) > 1:
        print("train: the port trains on one device; multi-process runs are not "
              "ported", file=sys.stderr)
        return 2
    cfg = build_config(args)
    trainer = Trainer(cfg, device=args.device)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.state.step}", file=sys.stderr)
    res = trainer.fit()
    summary = {
        "rank": 0,
        "steps": res.steps,
        "epochs": res.epochs,
        "examples": res.examples,
        "seconds": round(res.seconds, 3),
        "examples_per_sec": round(res.examples_per_sec, 1),
        "last_loss": res.last_loss,
        "occupancy": res.occupancy,
        "bad_steps": res.bad_steps,
    }
    if cfg.data.test_path:
        auc, ll = trainer.evaluate()
        summary["auc"], summary["logloss"] = auc, ll
        print(f"logloss: {ll}\tauc = {auc}", file=sys.stderr)
    summary["device"] = args.device
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xflow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train a model on one device")
    tr.add_argument("--train", required=True, help="train shard prefix (reads <prefix>-00000)")
    tr.add_argument("--test", default="", help="test shard prefix (evaluates <prefix>-00000)")
    tr.add_argument("--model", default="lr", help="lr|fm|mvm or reference index 0|1|2")
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--batch-size", type=int, default=None)
    tr.add_argument("--optimizer", default=None, help="ftrl|sgd")
    tr.add_argument("--log2-slots", type=int, default=None)
    tr.add_argument("--checkpoint-dir", default=None)
    tr.add_argument("--no-mesh", action="store_true",
                    help="accepted for flag parity: the port always runs one device")
    tr.add_argument("--coordinator", default=None, help="accepted for flag parity")
    tr.add_argument("--num-processes", type=int, default=None,
                    help="accepted for flag parity; more than 1 is refused")
    tr.add_argument("--process-id", type=int, default=None, help="accepted for flag parity")
    tr.add_argument("--device", default="cuda")
    tr.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set optim.name=sgd")
    tr.set_defaults(fn=cmd_train)
    ev = sub.add_parser("evaluate", help="evaluate a checkpoint on a libffm file")
    ev.add_argument("--checkpoint-dir", required=True)
    ev.add_argument("--test", required=True, help="libffm file to evaluate")
    ev.add_argument("--model", default="lr", help="lr|fm|mvm or reference index 0|1|2")
    ev.add_argument("--batch-size", type=int, default=None)
    ev.add_argument("--log2-slots", type=int, default=None)
    ev.add_argument("--device", default="cuda")
    ev.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set model.v_dim=4")
    ev.set_defaults(fn=cmd_evaluate)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
