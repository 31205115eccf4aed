"""Command line of the PyTorch port. Flag names follow `python -m xflow_tpu`.

    python -m xflow_tpu_torch train --train PREFIX [--test PREFIX] [--model lr|fm|mvm|ffm] \
        [--epochs N] [--batch-size N] [--optimizer ftrl|sgd] [--log2-slots N] \
        [--checkpoint-dir D] [--device cuda] [--set k=v ...]

Trains on `<PREFIX>-00000` on one device (resuming from the newest
checkpoint under D when there is one), evaluates `<test PREFIX>-00000`
when given, and prints one JSON summary line {"rank", "steps", "epochs",
"examples", "seconds", "examples_per_sec", "last_loss", "occupancy",
"bad_steps", ["auc", "logloss"], "device"}.

    python -m xflow_tpu_torch evaluate --checkpoint-dir D --test F \
        [--model lr|fm|mvm|ffm] [--batch-size N] [--log2-slots N] [--device cuda] [--set k=v ...]

Loads the newest loadable committed checkpoint under D, evaluates libffm
file F and prints one JSON line {"auc", "logloss", "step", "device"}.

    python -m xflow_tpu_torch serve --checkpoint-dir D [--model lr|fm|mvm|ffm] \
        [--log2-slots N] [--port P] [--host H] [--unix-socket PATH] [--window-ms MS] \
        [--max-batch N] [--poll-s S] [--metrics-path F] [--device cuda] [--set k=v ...]

Serves pCTRs over HTTP (`POST /predict` {"rows": [...]}, `GET /healthz`,
`GET /stats`) from the newest loadable committed checkpoint under D,
microbatched, and hot-reloads newer committed steps; prints one JSON
ready line {"serving", "step", "generation", "pid", "host", "port"[,
"unix_socket"], "device"} once listening, and exits 0 on SIGTERM. With
`--device cuda` and no CUDA device it exits 2 without serving.

    python -m xflow_tpu_torch serve-fleet --checkpoint-dir D [--replicas N] [--port P] \
        [--run-dir R] [--max-restarts K] [--retries N] [--deadline-ms MS] [--hedge-ms MS] \
        [--device cuda] [serve flags ...]

N supervised `serve` replicas, each on `--device` (default cuda; a
replica without the card exits 2 and the fleet exits 1), behind the
failover router on port P (`serve/fleet.py`, `serve/router.py`): retries
on another replica, circuit breaking, a staggered hot reload and a
router-first drain on SIGTERM. One JSON ready line {"serving", "fleet",
"router_host", "router_port", "run_id", "pid", "replicas": [{"replica",
"port", "step", "pid", "device"}]}; the fleet process imports no torch.

FFM at its practical shape: `--model ffm --set model.v_dim=4` (rows
`wv [S, 1 + num_fields * v_dim]`); it has no reference index, as in
`python -m xflow_tpu`.

Both read their input through the native parser (`--set
data.parser_threads=N`) or a shard's `.xfc` cache (`data.cache`,
`data.cache_dir`; `python -m xflow_tpu_torch.tools.criteo_convert cache
PREFIX` packs them).
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
    for flag, key in (("port", "serve.port"), ("host", "serve.host"),
                      ("unix_socket", "serve.unix_socket"), ("window_ms", "serve.window_ms"),
                      ("max_batch", "serve.max_batch"), ("poll_s", "serve.reload_poll_s"),
                      ("metrics_path", "serve.metrics_path"), ("replicas", "serve.replicas"),
                      ("reload_stagger_s", "serve.reload_stagger_s"),
                      ("retries", "serve.route_retries"),
                      ("deadline_ms", "serve.route_deadline_ms"),
                      ("hedge_ms", "serve.route_hedge_ms"),
                      ("eject_failures", "serve.eject_failures"),
                      ("circuit_open_s", "serve.circuit_open_s"),
                      ("health_poll_s", "serve.health_poll_s")):
        if getattr(args, flag, None) is not None:
            pairs[key] = getattr(args, flag)
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


def cmd_serve(args) -> int:
    import torch

    from xflow_tpu_torch.serve.server import serve_main

    cfg = build_config(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"serve: --device {args.device}: no CUDA device (torch.cuda.is_available() is "
              "false); pass --device cpu to serve from the CPU", file=sys.stderr)
        return 2
    try:
        return serve_main(cfg, device=args.device)
    except (FileNotFoundError, RuntimeError) as e:
        print(f"serve: cannot load a checkpoint: {e}", file=sys.stderr)
        return 1


def cmd_serve_fleet(args) -> int:
    from xflow_tpu_torch.serve.fleet import fleet_main

    cfg = build_config(args)
    # each replica's `serve` argv: the serve flags given here and the
    # device, less the fleet's own (--port and --metrics-path are per replica)
    serve_args = ["--checkpoint-dir", args.checkpoint_dir, "--device", args.device]
    for flag, value in (("--host", args.host), ("--model", args.model),
                        ("--log2-slots", args.log2_slots), ("--window-ms", args.window_ms),
                        ("--max-batch", args.max_batch), ("--poll-s", args.poll_s)):
        if value is not None:
            serve_args += [flag, str(value)]
    for item in args.set:
        serve_args += ["--set", item]
    return fleet_main(cfg, serve_args, run_dir=args.run_dir, max_restarts=args.max_restarts,
                      restart_backoff=args.restart_backoff, min_uptime_s=args.min_uptime_s)


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
    tr.add_argument("--model", default="lr", help="lr|fm|mvm|ffm, or reference index 0|1|2")
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
    ev.add_argument("--model", default="lr", help="lr|fm|mvm|ffm, or reference index 0|1|2")
    ev.add_argument("--batch-size", type=int, default=None)
    ev.add_argument("--log2-slots", type=int, default=None)
    ev.add_argument("--device", default="cuda")
    ev.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set model.v_dim=4")
    ev.set_defaults(fn=cmd_evaluate)
    sv = sub.add_parser("serve", help="serve pCTRs over HTTP from a committed checkpoint, "
                                      "with microbatching and hot reload")
    sv.add_argument("--checkpoint-dir", required=True,
                    help="dir of committed checkpoints; the newest loads, newer ones hot-reload")
    sv.add_argument("--model", default="lr", help="lr|fm|mvm|ffm, or reference index 0|1|2")
    sv.add_argument("--log2-slots", type=int, default=None)
    sv.add_argument("--port", type=int, default=None,
                    help="TCP port (default 8000; 0 = a free one; -1 = unix socket only)")
    sv.add_argument("--host", default=None)
    sv.add_argument("--unix-socket", default=None, help="also serve HTTP over this AF_UNIX path")
    sv.add_argument("--window-ms", type=float, default=None,
                    help="coalescing window (default 2.0)")
    sv.add_argument("--max-batch", type=int, default=None,
                    help="rows a device batch and a request at most (default 256)")
    sv.add_argument("--poll-s", type=float, default=None,
                    help="hot-reload poll interval (default 2.0)")
    sv.add_argument("--metrics-path", default=None,
                    help="kind=serve telemetry JSONL (windows, reload events)")
    sv.add_argument("--no-mesh", action="store_true",
                    help="accepted for flag parity: the port serves from one device")
    sv.add_argument("--device", default="cuda")
    sv.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set serve.ladder=32,64,256")
    sv.set_defaults(fn=cmd_serve, test=None, batch_size=None)
    sf = sub.add_parser("serve-fleet", help="N supervised serve replicas behind a "
                                            "health-checked failover router")
    sf.add_argument("--checkpoint-dir", required=True,
                    help="dir of committed checkpoints every replica loads and hot-reloads")
    sf.add_argument("--model", default="lr", help="lr|fm|mvm|ffm, or reference index 0|1|2")
    sf.add_argument("--log2-slots", type=int, default=None)
    sf.add_argument("--replicas", type=int, default=None, help="replica count (default 2)")
    sf.add_argument("--port", type=int, default=None,
                    help="the router's port (default 8000; 0 = a free one, in the ready line)")
    sf.add_argument("--host", default=None)
    sf.add_argument("--window-ms", type=float, default=None, help="each replica's window")
    sf.add_argument("--max-batch", type=int, default=None, help="each replica's batch rows")
    sf.add_argument("--poll-s", type=float, default=None, help="each replica's reload poll")
    sf.add_argument("--reload-stagger-s", type=float, default=None,
                    help="replica k delays a noticed reload by k x this (default 1.0)")
    sf.add_argument("--retries", type=int, default=None,
                    help="router retries on another replica after a connect failure or "
                         "5xx (default 2)")
    sf.add_argument("--deadline-ms", type=float, default=None,
                    help="a request's routing budget (default 2000)")
    sf.add_argument("--hedge-ms", type=float, default=None,
                    help="hedge a request outstanding this long (default 0 = off)")
    sf.add_argument("--eject-failures", type=int, default=None,
                    help="consecutive failures that open a replica's circuit (default 3)")
    sf.add_argument("--circuit-open-s", type=float, default=None,
                    help="open hold before the half-open probe (default 2)")
    sf.add_argument("--health-poll-s", type=float, default=None,
                    help="the router's /healthz poll interval (default 0.5)")
    sf.add_argument("--run-dir", default="",
                    help="serve_replica<k>.jsonl, serve_router.jsonl and replica<k>.log here")
    sf.add_argument("--max-restarts", type=int, default=0,
                    help="supervised restarts of each replica (default 0)")
    sf.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base seconds between a replica's restarts (doubling, jittered, "
                         "capped at 60)")
    sf.add_argument("--min-uptime-s", type=float, default=0.0,
                    help="a replica dying faster than this is not restarted")
    sf.add_argument("--no-mesh", action="store_true",
                    help="accepted for flag parity: each replica serves from one device")
    sf.add_argument("--device", default="cuda",
                    help="every replica's device (default cuda; cpu only when asked)")
    sf.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, passed to every replica too")
    sf.set_defaults(fn=cmd_serve_fleet, test=None, batch_size=None, unix_socket=None,
                    metrics_path=None)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
