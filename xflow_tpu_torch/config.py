"""Configuration tree of the PyTorch port: the fields the ported slices
(FM inference, single-device LR, FM, MVM and FFM training, the host
input plane, the server and its fleet, the online training loop and
the trainer's observability, the multi-device engines, the launchers
and the multi-slice sync tier) read, with the
JAX package's
names and defaults (`xflow_tpu/config.py`), so a `--set section.key=value`
override means the same in both.

Fields not listed here belong to what the port leaves out by design
(`train.compile_metrics`); an override naming one raises KeyError.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FTRLConfig:
    """FTRL-proximal hyperparameters (the reference's `ftrl.h` defaults)."""

    alpha: float = 5e-2
    beta: float = 1.0
    lambda1: float = 5e-5
    lambda2: float = 10.0


@dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-3


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer selection ("ftrl" | "sgd"). `v_init_scale` / `v_init_sgd`
    are the vector-table inits (N(0,1) * scale for FTRL, a constant for
    SGD). `fused_scatter` ("auto"|"on"|"off") applies FTRL inside the
    windowed scatter on the single-device sorted FM step
    (`ops/sorted_table.scatter_ftrl_sorted`)."""

    name: str = "ftrl"
    ftrl: FTRLConfig = field(default_factory=FTRLConfig)
    sgd: SGDConfig = field(default_factory=SGDConfig)
    v_init_scale: float = 1e-2
    v_init_sgd: float = 1e-3
    fused_scatter: str = "auto"


@dataclass(frozen=True)
class ModelConfig:
    """Model selection and dims. `fm_standard` selects the textbook FM
    second-order term (per latent dim, with the 1/2 when `fm_half`);
    False reproduces the reference's coupled form. `fm_fused` keeps w
    and v in one ``wv [S, 1+k]`` table.

    MVM: `mvm_exclusive` ("auto"|"on"|"off") routes a batch to the
    exclusive-fields product row side ("auto": when no row repeats a
    field, else the segment row side; "on": raise on a repeated field;
    "off": always the segment row side). `mvm_plus_one` selects the
    factor form: False = the plain view-sum product over fields, True =
    the product of (1 + view sum), the form that learns from small
    inits (`xflow_tpu/config.py`)."""

    name: str = "lr"
    v_dim: int = 10
    num_fields: int = 18
    mvm_exclusive: str = "auto"
    mvm_plus_one: bool = False
    fm_standard: bool = True
    fm_half: bool = True
    fm_fused: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Input: libffm shards hashed into a dense ``2**log2_slots`` table,
    batched to ``[batch_size, max_nnz]`` padded blocks.

    `sorted_layout` ("auto"|"on"|"off") picks the sorted-window engine
    for fused FM and MVM; `sorted_bf16` rounds gathered table values
    to bf16; `sorted_sub_batches` is the number NS of row-contiguous
    sub-batches a batch's plan is stacked into (0 = auto:
    `ops/sorted_table.resolve_sub_batches`).

    On a mesh (`parallel/`): `sorted_mesh` picks the sorted engine,
    "fullshard" (table and optimizer state sharded over every rank,
    `parallel/sorted_fullshard.py`) or "replicated" (sharded over the
    table axis, repeated across the data axis,
    `parallel/sorted_sharded.py`); `fullshard_slack` sizes the
    fully-sharded engine's per-(source, owner) occurrence buffers as a
    multiple of the uniform-hash expectation (a batch that overflows
    them runs the row-major sharded step).

    `dedup` ("auto"|"off") ships a row-major batch as (unique_slots,
    inverse) when its unique slots fit `dedup_cap_frac * batch_size *
    max_nnz` (`ops/sorted_table.dedup_slots`): the table gather then
    moves U rows instead of B*F. Off by default, as in the JAX package.

    Host input (`data/pipeline.py`): text is read by the C++ parser
    (`data/native.py`) in `parser_threads` workers (0 = one a usable
    core, capped at 16; 1 = the sequential parser; batches are
    byte-identical either way); a short last batch is padded and
    row-masked. `cache` ("auto"|"on"|"off") reads a
    shard's packed `.xfc` cache (`data/shardcache.py`) where one is fresh
    ("on": it must be), beside the shard or under `cache_dir`.
    `max_bad_rows` is the budget of feature-less rows a training pass
    may hold (-1 = count and warn only); `quarantine_path` (a JSONL
    file, "" = off) records each of them.

    The stream (`data/pipeline.TailFollower`): `stream` "off" trains the
    shard's epochs; "tail" follows the growing shard set, spooling each
    poll's newly completed lines into a sealed segment under
    `stream_dir` ("" = an `.xfstream` dir beside the shards), converted
    to `.xfc` on arrival when `cache` allows. Polls every
    `stream_poll_s`; `stream_idle_s` without new complete rows ends the
    stream (0 = follow forever)."""

    train_path: str = ""
    test_path: str = ""
    batch_size: int = 1024
    max_nnz: int = 32
    log2_slots: int = 22
    hash_salt: int = 0
    parser_threads: int = 0
    cache: str = "auto"
    cache_dir: str = ""
    max_bad_rows: int = -1
    quarantine_path: str = ""
    sorted_layout: str = "auto"
    sorted_bf16: bool = False
    sorted_sub_batches: int = 0
    sorted_mesh: str = "fullshard"
    dedup: str = "off"
    dedup_cap_frac: float = 0.5
    fullshard_slack: float = 2.0
    stream: str = "off"
    stream_poll_s: float = 0.25
    stream_idle_s: float = 0.0
    stream_dir: str = ""


@dataclass(frozen=True)
class TrainConfig:
    """The fit loop and checkpoints: epochs over the shard, the table
    init seed, a window record every `log_every` steps (0 = none), a
    checkpoint every `checkpoint_every` steps (0 = only at the end),
    resume from the newest checkpoint, the non-finite guard
    ("off"|"skip"|"halt") and its consecutive-skip abort; where
    checkpoints live, their format ("npz" is the one the port reads and
    writes) and digest verification on restore ("auto"|"off").
    `ckpt_replica_dir` ("" = off) is the tier-2 replica of the
    checkpoints: every committed step is mirrored there (digest
    re-verified, its own COMMITTED last), and restores and the serve
    watcher walk the union of both tiers' committed steps, newest first.

    `metrics_path` ("" = off) is the run's JSONL record stream, rolled
    past `metrics_max_bytes` (0 = never): a window record every
    `log_every` steps, written one step behind (StepTimer's split,
    the card's memory, the health fields and the registry's counters),
    the `final` record, one `checkpoint_save` span a save under
    `ckpt_spans`, and a kind="pipeline" record a window under
    `pipeline_metrics`. `health_metrics` ("off"|"norms"|"full") adds the
    grad, update and param norms to each step (per table under "full"),
    a loss EMA (`health_ema_decay`) and the occupancy gauges.
    `heartbeat_path` ("" = off) gets a kind="heartbeat" record every
    `heartbeat_every` steps and at start, checkpoints, evals and the
    end; `hang_timeout_s` (0 = off) dumps every thread's stack once a
    stall without a step. `profile_dir` ("" = off) receives a
    `torch.profiler` Chrome trace of steps `trace_start_step` ..
    `+ trace_num_steps - 1` (start 0: the whole run).

    Evaluation: `eval_every` epochs (or publications, in the online
    loop; 0 = only at the end) a streaming pass over `data.test_path`
    logs `eval_auc`; `eval_buckets` (-1 = auto: exact on one process,
    65,536 buckets for a streaming pass; 0 = exact; N = N buckets) and
    `eval_window_decay` (0 = each pass fresh) shape it. `pred_dump`
    writes `pred_0_<block>.txt` rows on the exact and bucketed paths.

    `ckpt_on_signal`: SIGTERM/SIGINT commit the step reached and end
    the run; a world of several ranks agrees on the step with one
    all_reduce(MAX) of the pending signal every `signal_sync_every`
    steps (0: no handler is installed on such a world). `keep_checkpoints` / `keep_replica_checkpoints` keep the N
    newest committed steps of each tier (0 = all) and sweep uncommitted
    debris after each save. `ckpt_async`: the fit loop only snapshots
    and a writer thread commits, at most one save in flight
    (`train/checkpoint.py` `AsyncCheckpointWriter`). `publish_every` (0
    = off; needs `checkpoint_dir` and `data.stream=tail`): every Nth
    step commits a checkpoint with a publication sidecar the server
    reads. Compile accounting (`compile_metrics`) is not taken over:
    the torch step has no compile step."""

    epochs: int = 60
    seed: int = 0
    log_every: int = 100
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    resume: bool = True
    nonfinite_guard: str = "skip"
    nonfinite_max_consecutive: int = 10
    checkpoint_format: str = "npz"
    checkpoint_verify: str = "auto"
    ckpt_replica_dir: str = ""
    metrics_path: str = ""
    ckpt_spans: bool = True
    ckpt_on_signal: bool = True
    signal_sync_every: int = 100
    keep_checkpoints: int = 0
    ckpt_async: bool = False
    keep_replica_checkpoints: int = 0
    publish_every: int = 0
    eval_every: int = 0
    pred_dump: bool = True
    eval_buckets: int = -1
    eval_window_decay: float = 0.0
    metrics_max_bytes: int = 0
    health_metrics: str = "off"
    health_ema_decay: float = 0.99
    heartbeat_path: str = ""
    heartbeat_every: int = 25
    hang_timeout_s: float = 0.0
    pipeline_metrics: bool = False
    profile_dir: str = ""
    trace_start_step: int = 0
    trace_num_steps: int = 20


@dataclass(frozen=True)
class ServeConfig:
    """The server (`python -m xflow_tpu_torch serve`) and its fleet, with
    the JAX package's names, defaults and meanings.

    Listeners: TCP on `host`:`port` (0 = a free port, reported in the
    ready line; -1 = none) and/or HTTP over the AF_UNIX path
    `unix_socket`. Microbatching (`serve/coalescer.py`): requests queued
    inside `window_ms` coalesce into one padded batch of at most
    `max_batch` rows (the per-request row cap too); beyond
    `max_queue_rows` queued rows a submit gets 503. Hot reload polls the
    checkpoint dir every `reload_poll_s`. Telemetry: kind="serve" JSONL
    windows every `metrics_every_s` to `metrics_path` ("" = off), rolled
    past `metrics_max_bytes` (0 = never). Request tracing: head-sampling
    rate `trace_sample_rate` (0 = off), tail capture over
    `trace_slow_ms`. `request_timeout_s`: an unanswered request gets
    503. Brownout: a backlog over `brownout_high_frac` x max_queue_rows
    sustained `brownout_after_s` shrinks the window by
    `brownout_window_factor` and sheds low-priority requests, until it
    stays under `brownout_low_frac`. Autotune (off by default) steers
    window_ms and the ladder rung toward `slo_p99_ms` within a band of
    `autotune_band_frac`, stepping by `autotune_step_frac`, no window
    below `autotune_min_window_ms`. `ladder` ("32,64,256"; "" =
    max_batch only): the batch shapes a batch is padded to, the
    smallest that fits.

    The fleet (`python -m xflow_tpu_torch serve-fleet`): `replicas`
    supervised servers behind the router; replica k delays a noticed
    reload by k x `reload_stagger_s`. The router polls each replica's
    /healthz every `health_poll_s`, ejects a replica after
    `eject_failures` consecutive failures for `circuit_open_s` before a
    half-open probe, gives a request `route_deadline_ms` and
    `route_retries` retries on other replicas, and hedges one
    outstanding for `route_hedge_ms` (0 = off)."""

    host: str = "127.0.0.1"
    port: int = 8000
    unix_socket: str = ""
    window_ms: float = 2.0
    max_batch: int = 256
    max_queue_rows: int = 8192
    reload_poll_s: float = 2.0
    metrics_path: str = ""
    metrics_every_s: float = 5.0
    metrics_max_bytes: int = 0
    trace_sample_rate: float = 0.0
    trace_slow_ms: float = 250.0
    request_timeout_s: float = 30.0
    brownout_high_frac: float = 0.5
    brownout_low_frac: float = 0.25
    brownout_after_s: float = 0.25
    brownout_window_factor: float = 0.25
    autotune: bool = False
    slo_p99_ms: float = 25.0
    autotune_band_frac: float = 0.15
    autotune_step_frac: float = 0.5
    autotune_min_window_ms: float = 0.25
    ladder: str = ""
    replicas: int = 2
    reload_stagger_s: float = 1.0
    health_poll_s: float = 0.5
    eject_failures: int = 3
    circuit_open_s: float = 2.0
    route_deadline_ms: float = 2000.0
    route_retries: int = 2
    route_hedge_ms: float = 0.0


@dataclass(frozen=True)
class MeshConfig:
    """The ('data', 'table') mesh of a multi-rank run
    (`parallel/mesh.py`): `data` ranks split the batch (the reference's
    workers), `table` ranks split the table's slot range (its servers).
    -1 infers the axis from the world size."""

    data: int = -1
    table: int = 1


@dataclass(frozen=True)
class SyncConfig:
    """The multi-slice sync tier (`parallel/multislice.py`): slices that
    train apart exchange additive table deltas through the shared `dir`
    every `every_steps` steps. `mode`: "off" (no tier), "sync" (wait for
    every live peer's round: K = 0), "bounded" (wait until every live
    peer is within `staleness_k` rounds) or "async" (never wait). Every
    wait is bounded by `timeout_s` with `retries` re-checks `backoff_s`
    apart (doubling, jittered); a missed bound then follows `on_stale`
    ("wait": after the bounded wait; "proceed": check once and go on).
    Every `snapshot_every` rounds (0 = never) a slice publishes its whole
    state, which a relaunched slice adopts."""

    mode: str = "off"
    staleness_k: int = 0
    every_steps: int = 50
    dir: str = ""
    timeout_s: float = 30.0
    retries: int = 3
    backoff_s: float = 0.5
    on_stale: str = "wait"
    snapshot_every: int = 10


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)

    @property
    def num_slots(self) -> int:
        return 1 << self.data.log2_slots


def _replace_nested(obj: Any, path: list[str], value: Any) -> Any:
    if path[0] not in {f.name for f in dataclasses.fields(obj)}:
        raise KeyError(f"unknown config key {path[0]!r} in {type(obj).__name__}")
    if len(path) == 1:
        cur = getattr(obj, path[0])
        if isinstance(cur, bool):
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        return dataclasses.replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    return dataclasses.replace(obj, **{path[0]: _replace_nested(child, path[1:], value)})


def override(cfg: Config, **dotted: Any) -> Config:
    """Apply dotted-path overrides: override(cfg, **{"model.name": "fm"})."""
    for key, value in dotted.items():
        cfg = _replace_nested(cfg, key.split("."), value)
    return cfg
