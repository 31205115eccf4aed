"""Command line of the PyTorch port. Flag names follow `python -m xflow_tpu`.

    python -m xflow_tpu_torch train --train PREFIX [--test PREFIX] [--model lr|fm|mvm|ffm] \
        [--epochs N] [--batch-size N] [--optimizer ftrl|sgd] [--log2-slots N] \
        [--checkpoint-dir D] [--device cuda] [--set k=v ...]

Trains on `<PREFIX>-00000` on one device (resuming from the newest
checkpoint under D when there is one), evaluates `<test PREFIX>-00000`
when given, and prints one JSON summary line {"rank", "steps", "epochs",
"examples", "seconds", "examples_per_sec", "last_loss", "occupancy",
"bad_steps", ["auc", "logloss"], "device"}. With `--coordinator
HOST:PORT --num-processes N --process-id K` (or the `XFLOW_COORDINATOR`,
`XFLOW_NUM_PROCESSES`, `XFLOW_PROCESS_ID` environment) and N above 1,
each process is one rank of a `torch.distributed` world (NCCL on the
card, one card a rank; gloo with `--device cpu`) and the ranks train on
a ('data', 'table') mesh (`--set mesh.data=D --set mesh.table=T`):
data coordinate d reads `<PREFIX>-0000d`, rank 0 writes the checkpoint
and prints the summary (with "world"). With `--set data.stream=tail`
it follows the growing shard set instead (the online loop, publishing
every `train.publish_every` steps). SIGTERM or SIGINT commit the step
reached; the summary then carries "interrupted" (the signal), no
evaluation runs, and the exit code is 0.

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

    python -m xflow_tpu_torch gen-data OUT_PREFIX [--shards N] [--rows N] [--fields N] \
        [--ids-per-field N] [--seed N] [--truth-seed N] [--zipf-alpha A] \
        [--truth linear|ffm] [--bulk]
    python -m xflow_tpu_torch export CHECKPOINT_DIR [--table w|v|wv] --out FILE
    python -m xflow_tpu_torch collisions FILE [FILE ...] [--log2-slots N] [--salt N]

    python -m xflow_tpu_torch launch-local [--num-processes N] [--run-dir R] \
        [--max-restarts K] [--allow-shrink] -- TRAIN_ARGS
    python -m xflow_tpu_torch launch-dist --hosts FILE [--dry-run] [--ssh-cmd C] \
        [--workdir W] [--env K=V] [--run-dir R] [--max-restarts K] -- TRAIN_ARGS
    python -m xflow_tpu_torch launch-multislice [--slices N] --run-dir R \
        [--max-restarts K] -- TRAIN_ARGS

The launchers of `python -m xflow_tpu`, with its flags and messages
(`launch/local.py`, `launch/dist.py`, `parallel/multislice.py`):
`launch-local` starts N `train` ranks on this host joined over
127.0.0.1, `launch-dist` one rank a host over ssh (`--dry-run` prints
each host's environment and command), `launch-multislice` N slices, each
a world of its own, that exchange table deltas in `<R>/sync`
(`--set sync.mode=...`; `{slice}` in TRAIN_ARGS becomes the slice).
With `--run-dir` each rank writes `metrics_rank<k>.jsonl` and
`heartbeat_rank<k>.jsonl` there and the watchdog polls them;
`--max-restarts` relaunches a failed world (or slice) with
`train.resume=true`. The children take TRAIN_ARGS' `--device` (cuda by
default; the JAX launcher forces the CPU): `--device cpu` runs a
multi-rank world over gloo on one host, which is how a world larger
than the host's cards runs.

The data tools of `python -m xflow_tpu`, with its flags and outputs:
`gen-data` writes synthetic libffm shards (`data/synth.py`, byte-equal
to the JAX writers' for the same seeds) and prints their paths;
`export` writes the newest committed checkpoint's table as
`slot\tweight...` rows of its nonzero slots (`w` and `v` are sliced out
of a fused `wv`, `w` being its column 0) and prints {"step", "table",
"nonzero"}; `collisions` prints the hash-collision JSON of
`tools/collisions.py`. None needs a card.

The observability flags (`--set train.<key>=...`, as the JAX trainer's):
`metrics_path`, `log_every`, `health_metrics`, `heartbeat_path`,
`heartbeat_every`, `hang_timeout_s`, `pipeline_metrics`, `profile_dir`,
`trace_start_step`, `trace_num_steps`, `eval_every`, `eval_buckets`,
`eval_window_decay`, `pred_dump`. With `--test`, `train` writes
`pred_0_0.txt` in the working directory (`train.pred_dump`).

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
    from xflow_tpu_torch.parallel.distributed import maybe_initialize, shutdown

    rank = maybe_initialize(args.coordinator, args.num_processes, args.process_id,
                            device=args.device)
    try:
        return _train(args, rank)
    finally:
        shutdown()


def _train(args, rank: int) -> int:
    import torch.distributed as dist

    from xflow_tpu_torch.train.trainer import Trainer

    cfg = build_config(args)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh, device = None, args.device
    if world > 1:
        if args.no_mesh:
            print("train: --no-mesh with a world of several processes would train each "
                  "rank alone; drop --no-mesh, or run one process", file=sys.stderr)
            return 2
        import torch

        from xflow_tpu_torch.parallel.distributed import local_device
        from xflow_tpu_torch.parallel.mesh import make_mesh

        device = local_device(args.device, rank, world)
        mesh = make_mesh(cfg, device=device)
        if torch.device(device).type == "cpu":
            device = "cpu"
    trainer = Trainer(cfg, device=device, mesh=mesh)
    if trainer.maybe_restore():
        if rank == 0:
            print(f"resumed from step {trainer.state.step}", file=sys.stderr)
    res = trainer.fit()
    summary = {
        "rank": rank,
        "steps": res.steps,
        "epochs": res.epochs,
        "examples": res.examples,
        "seconds": round(res.seconds, 3),
        "examples_per_sec": round(res.examples_per_sec, 1),
        "last_loss": res.last_loss,
        "occupancy": res.occupancy,
        "bad_steps": res.bad_steps,
    }
    if res.interrupted:
        # a signal ended the run at a committed step: no evaluation, so
        # the grace period is not spent on it
        summary["interrupted"] = res.interrupted
        summary["device"] = args.device
        if world > 1:
            summary["world"] = world
        if rank == 0:
            print(json.dumps(summary))
        return 0
    if cfg.data.test_path:
        auc, ll = trainer.evaluate()  # every rank takes part on a mesh
        summary["auc"], summary["logloss"] = auc, ll
        if rank == 0:
            print(f"logloss: {ll}\tauc = {auc}", file=sys.stderr)
    summary["device"] = args.device
    if world > 1:
        summary["world"] = world
    if rank == 0:
        print(json.dumps(summary))
    return 0


def cmd_gen_data(args) -> int:
    from xflow_tpu_torch.data.synth import generate_shards, generate_shards_bulk

    if args.bulk:
        if args.truth != "linear":
            print("--bulk supports only the linear truth (the vectorized "
                  "writer has no field-pair mode)", file=sys.stderr)
            return 2
        paths, _ = generate_shards_bulk(
            args.out_prefix, args.shards, args.rows,
            num_fields=args.fields, ids_per_field=args.ids_per_field,
            seed=args.seed, truth_seed=args.truth_seed, zipf_alpha=args.zipf_alpha,
        )
    else:
        paths = generate_shards(
            args.out_prefix, args.shards, args.rows,
            num_fields=args.fields, ids_per_field=args.ids_per_field, seed=args.seed,
            truth_seed=args.truth_seed, zipf_alpha=args.zipf_alpha, truth=args.truth,
        )
    print("\n".join(paths))
    return 0


def cmd_export(args) -> int:
    import os

    import numpy as np

    from xflow_tpu_torch.train.checkpoint import export_sparse_array, latest_step

    step = latest_step(args.checkpoint_dir)
    if step is None:
        print(f"no committed checkpoint in {args.checkpoint_dir}", file=sys.stderr)
        return 1
    data = np.load(os.path.join(args.checkpoint_dir, f"step_{step}", "state.npz"))
    key = f"tables/{args.table}"
    if key in data:
        arr = data[key]
    elif args.table in ("w", "v") and "tables/wv" in data:
        # the fused FM table: w is column 0, v the rest
        wv = data["tables/wv"]
        arr = wv[:, 0] if args.table == "w" else wv[:, 1:]
    else:
        have = sorted(k.split("/", 1)[1] for k in data.files if k.startswith("tables/"))
        print(f"no table {args.table!r} in checkpoint; have {have}", file=sys.stderr)
        return 1
    n = export_sparse_array(arr, args.out)
    print(json.dumps({"step": step, "table": args.table, "nonzero": n}))
    return 0


def cmd_collisions(args) -> int:
    from xflow_tpu_torch.tools.collisions import measure

    print(json.dumps(measure(args.paths, args.log2_slots, args.salt)))
    return 0


def _add_watchdog_flags(ap) -> None:
    """The liveness watchdog's flags (with --run-dir; 0 = the module default)."""
    ap.add_argument("--straggler-factor", type=float, default=0.0,
                    help="flag a rank whose heartbeat step trails the leader "
                         "by more than this factor (default 2.0)")
    ap.add_argument("--dead-after-s", type=float, default=0.0,
                    help="flag a rank with no heartbeat for this many "
                         "seconds as dead (default 60)")
    ap.add_argument("--watchdog-poll-s", type=float, default=0.0,
                    help="heartbeat poll interval in seconds (default 2)")


def _add_supervise_flags(ap) -> None:
    """The supervised restart's flags (`launch/supervise.py`)."""
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="relaunch the whole job (with train.resume=true) up "
                         "to this many times after a nonzero rank exit or a "
                         "watchdog dead-rank verdict (default 0 = no "
                         "supervision)")
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base seconds between restarts; doubles per attempt "
                         "with jitter, capped at 60s (default 1.0)")
    ap.add_argument("--min-uptime-s", type=float, default=0.0,
                    help="an attempt dying faster than this is treated as a "
                         "config error and NOT restarted (default 0 = always "
                         "restart while the budget lasts)")
    ap.add_argument("--allow-shrink", action="store_true",
                    help="degraded-mode supervision: a watchdog dead-HOST "
                         "verdict (unreachable across the grace window, vs a "
                         "process that merely exits) relaunches on the "
                         "surviving host set with a recomputed world size; "
                         "the elastic restore reshards the checkpoint and "
                         "re-assigns the lost rank's data shards (default: "
                         "relaunch same-shape)")


def cmd_launch_local(args) -> int:
    from xflow_tpu_torch.launch.local import launch_local

    return launch_local(
        args.num_processes, args.forward, port=args.port, run_dir=args.run_dir,
        straggler_factor=args.straggler_factor, dead_after_s=args.dead_after_s,
        watchdog_poll_s=args.watchdog_poll_s, max_restarts=args.max_restarts,
        restart_backoff=args.restart_backoff, min_uptime_s=args.min_uptime_s,
        allow_shrink=args.allow_shrink,
    )


def cmd_launch_multislice(args) -> int:
    from xflow_tpu_torch.parallel.multislice import launch_multislice

    return launch_multislice(
        args.slices, args.forward, run_dir=args.run_dir,
        straggler_factor=args.straggler_factor, dead_after_s=args.dead_after_s,
        watchdog_poll_s=args.watchdog_poll_s, max_restarts=args.max_restarts,
        restart_backoff=args.restart_backoff, min_uptime_s=args.min_uptime_s,
    )


def cmd_launch_dist(args) -> int:
    from xflow_tpu_torch.launch.dist import launch_dist, parse_hosts

    hosts = list(args.host or [])
    if args.hosts:
        hosts = parse_hosts(args.hosts) + hosts
    if len(hosts) < 2:
        print("launch-dist needs >= 2 hosts (--hosts FILE or repeated --host)",
              file=sys.stderr)
        return 2
    for kv in args.env or []:
        if "=" not in kv:
            print(f"--env expects K=V, got {kv!r}", file=sys.stderr)
            return 2
    env_extra = dict(kv.split("=", 1) for kv in (args.env or []))
    return launch_dist(
        hosts, args.forward, port=args.port, ssh_cmd=args.ssh_cmd, workdir=args.workdir,
        python=args.python, env_extra=env_extra, dry_run=args.dry_run, run_dir=args.run_dir,
        straggler_factor=args.straggler_factor, dead_after_s=args.dead_after_s,
        watchdog_poll_s=args.watchdog_poll_s, max_restarts=args.max_restarts,
        restart_backoff=args.restart_backoff, min_uptime_s=args.min_uptime_s,
        allow_shrink=args.allow_shrink,
    )


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
                    help="one process, one device (a world of several refuses it)")
    tr.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store (else XFLOW_COORDINATOR)")
    tr.add_argument("--num-processes", type=int, default=None,
                    help="world size (else XFLOW_NUM_PROCESSES); above 1 trains on a mesh")
    tr.add_argument("--process-id", type=int, default=None,
                    help="this rank (else XFLOW_PROCESS_ID)")
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
    gd = sub.add_parser("gen-data", help="generate synthetic libffm shards")
    gd.add_argument("out_prefix")
    gd.add_argument("--shards", type=int, default=3)
    gd.add_argument("--rows", type=int, default=1000)
    gd.add_argument("--fields", type=int, default=18)
    gd.add_argument("--ids-per-field", type=int, default=500)
    gd.add_argument("--seed", type=int, default=0)
    gd.add_argument("--truth-seed", type=int, default=None,
                    help="seed of the planted truth (default: --seed); the same value for "
                         "train and test splits written with different --seed")
    gd.add_argument("--zipf-alpha", type=float, default=0.0,
                    help="power-law feature skew (0 = uniform; ~1.1 is CTR-like)")
    gd.add_argument("--truth", default="linear",
                    help="planted concept: linear | ffm (field-pair interactions a "
                         "field-blind FM cannot fit)")
    gd.add_argument("--bulk", action="store_true",
                    help="chunked vectorized writer for large shards (another random "
                         "stream than the per-row writer)")
    gd.set_defaults(fn=cmd_gen_data)
    ex = sub.add_parser("export", help="export nonzero weights from a checkpoint")
    ex.add_argument("checkpoint_dir")
    ex.add_argument("--table", default="w")
    ex.add_argument("--out", required=True)
    ex.set_defaults(fn=cmd_export)
    co = sub.add_parser("collisions", help="measure the feature-hash collision rate of "
                                           "libffm files")
    co.add_argument("paths", nargs="+")
    co.add_argument("--log2-slots", type=int, default=22)
    co.add_argument("--salt", type=int, default=0)
    co.set_defaults(fn=cmd_collisions)
    ll = sub.add_parser("launch-local", help="start a local multi-process world "
                                             "(scripts/local.sh analog)")
    ll.add_argument("--num-processes", type=int, default=2)
    ll.add_argument("--port", type=int, default=0, help="coordinator port (0 = pick free)")
    ll.add_argument("--run-dir", default="",
                    help="collect per-rank telemetry here: each rank writes "
                         "<run-dir>/metrics_rank<k>.jsonl (overrides any "
                         "train.metrics_path in the forwarded args) and all "
                         "ranks share one run_id; summarize with "
                         "tools/metrics_report.py")
    _add_watchdog_flags(ll)
    _add_supervise_flags(ll)
    ll.add_argument("forward", nargs=argparse.REMAINDER,
                    help="-- followed by `train` args to run in every process (their "
                         "--device, cuda by default: one card a rank; cpu: gloo)")
    ll.set_defaults(fn=cmd_launch_local)
    lm = sub.add_parser(
        "launch-multislice",
        help="emulate N slices with bounded-staleness table sync "
             "across them (sync.mode/staleness_k; each slice is an "
             "independent supervised `train`)",
    )
    lm.add_argument("--slices", type=int, default=2,
                    help="slice count (default 2); each slice is its own "
                         "single-process training world exchanging table "
                         "deltas via <run-dir>/sync")
    lm.add_argument("--run-dir", required=True,
                    help="REQUIRED shared run dir: the sync tier lives in "
                         "<run-dir>/sync (deltas, snapshots, "
                         "membership.json) and slice j writes "
                         "<run-dir>/metrics_rank<j>.jsonl + "
                         "heartbeat_rank<j>.jsonl; summarize with "
                         "tools/metrics_report.py")
    _add_watchdog_flags(lm)
    _add_supervise_flags(lm)
    lm.add_argument("forward", nargs=argparse.REMAINDER,
                    help="-- followed by `train` args for every "
                         "slice; the literal {slice} substitutes to the "
                         "slice index (per-slice --train prefix / "
                         "--checkpoint-dir)")
    lm.set_defaults(fn=cmd_launch_multislice)
    ld = sub.add_parser("launch-dist", help="start one rank per machine over ssh "
                                            "(run_ps_dist.sh analog)")
    ld.add_argument("--hosts", help="hosts file: one host per line, first = rank 0 "
                                    "(scripts/hosts shape)")
    ld.add_argument("--host", action="append",
                    help="repeatable inline host (appended after --hosts entries)")
    ld.add_argument("--port", type=int, default=29431, help="coordinator port on host 0")
    ld.add_argument("--ssh-cmd", default="ssh",
                    help="remote runner prefix (default ssh; e.g. 'ssh -i key')")
    ld.add_argument("--workdir", default="",
                    help="remote working dir; {rank}/{host} placeholders supported")
    ld.add_argument("--python", default="", help="remote python (default python3)")
    ld.add_argument("--env", action="append", metavar="K=V",
                    help="extra env for every rank (repeatable)")
    ld.add_argument("--run-dir", default="",
                    help="REMOTE dir (shared filesystem recommended) for "
                         "per-rank telemetry: each rank writes "
                         "<run-dir>/metrics_rank<k>.jsonl and all ranks share "
                         "one run_id (XFLOW_RUN_ID); summarize with "
                         "tools/metrics_report.py")
    ld.add_argument("--dry-run", action="store_true",
                    help="print the per-host command lines instead of running")
    _add_watchdog_flags(ld)
    _add_supervise_flags(ld)
    ld.add_argument("forward", nargs=argparse.REMAINDER,
                    help="-- followed by `train` args to run on every host")
    ld.set_defaults(fn=cmd_launch_dist)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
