"""Configuration tree of the PyTorch port: the fields the ported slices
(FM inference, single-device FM and MVM training) read, with the JAX package's
names and defaults (`xflow_tpu/config.py`), so a `--set section.key=value`
override means the same in both.

Sections and fields not listed here belong to paths the port has not
taken over yet (multi-device engines, the serving fleet, telemetry);
an override naming one raises KeyError.
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

    `dedup` ("auto"|"off") ships a row-major batch as (unique_slots,
    inverse) when its unique slots fit `dedup_cap_frac * batch_size *
    max_nnz` (`ops/sorted_table.dedup_slots`): the table gather then
    moves U rows instead of B*F. Off by default, as in the JAX package."""

    train_path: str = ""
    test_path: str = ""
    batch_size: int = 1024
    max_nnz: int = 32
    log2_slots: int = 22
    hash_salt: int = 0
    sorted_layout: str = "auto"
    sorted_bf16: bool = False
    sorted_sub_batches: int = 0
    dedup: str = "off"
    dedup_cap_frac: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    """The fit loop and checkpoints: epochs over the shard, the table
    init seed, a progress line every `log_every` steps (0 = none), a
    checkpoint every `checkpoint_every` steps (0 = only at the end),
    resume from the newest checkpoint, the non-finite guard
    ("off"|"skip"|"halt") and its consecutive-skip abort; where
    checkpoints live, their format ("npz" is the one the port reads and
    writes) and digest verification on restore ("auto"|"off")."""

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


@dataclass(frozen=True)
class ServeConfig:
    """Rows per serving device batch (the per-request row cap too)."""

    max_batch: int = 256


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

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
