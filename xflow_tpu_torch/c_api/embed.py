"""Python side of the port's C ABI (see xflow_c_api.h), after
`xflow_tpu/c_api/embed.py`: the C shim (`xflow_c_api.c`) embeds CPython
and drives this module; handles are integers into a registry.

A handle accumulates dotted config overrides, plus one undotted key,
``device`` (default ``cuda``; ``cpu`` when the caller asks for it), kept
out of `Config`: the counterpart of the CLI's ``--device``. Training,
evaluation and serving run the port's own `Trainer`, `evaluate` and
`ServeRunner` on that device.
"""

from __future__ import annotations

import itertools
from typing import Dict

DEVICE_KEY = "device"

_registry: Dict[int, dict] = {}
_ids = itertools.count(1)


def create(train_prefix: str, test_prefix: str) -> int:
    handle = next(_ids)
    _registry[handle] = {
        "overrides": {
            "data.train_path": train_prefix,
            "data.test_path": test_prefix,
        },
        "device": "cuda",
        "result": None,
        "auc": float("nan"),
    }
    return handle


def set_config(handle: int, key: str, value: str) -> None:
    entry = _registry[handle]
    if key == DEVICE_KEY:
        entry["device"] = value
    else:
        entry["overrides"][key] = value


def _config(entry: dict, **extra):
    from xflow_tpu_torch.config import Config, override

    return override(Config(), **{**entry["overrides"], **extra})


def start_train(handle: int) -> int:
    from xflow_tpu_torch.train.trainer import Trainer

    entry = _registry[handle]
    cfg = _config(entry)
    trainer = Trainer(cfg, device=entry["device"])
    entry["result"] = trainer.fit()
    if cfg.data.test_path:
        entry["auc"], entry["logloss"] = trainer.evaluate()
    return 0


def get_auc(handle: int) -> float:
    return float(_registry[handle]["auc"])


def load_checkpoint(handle: int, ckpt_dir: str) -> int:
    """Back XFLoadCheckpoint: a serve runner on the handle's device over
    the newest committed checkpoint in `ckpt_dir` that loads (walk-back
    over damaged steps, both tiers), under the handle's overrides so the
    model and hash config match what trained."""
    from xflow_tpu_torch.serve.runner import ServeRunner

    entry = _registry[handle]
    runner = ServeRunner(_config(entry, **{"train.checkpoint_dir": ckpt_dir}),
                         device=entry["device"])
    runner.load()  # raises when nothing committed loads -> C returns -1
    entry["runner"] = runner
    return 0


def predict(handle: int, rows_text: str) -> list:
    """Back XFPredict: newline-separated libffm feature rows (an optional
    leading label ignored) -> [pctr floats], through `predict_rows`, the
    forward `evaluate` uses. Raises on malformed rows or a handle without
    a loaded checkpoint: the C shim returns -1, never crashes."""
    runner = _registry[handle].get("runner")
    if runner is None:
        raise RuntimeError("no checkpoint loaded; call XFLoadCheckpoint first")
    rows = [ln for ln in rows_text.splitlines() if ln.strip()]
    pctrs, _gen = runner.predict_rows(rows)
    return [float(p) for p in pctrs]


def get_serving_step(handle: int) -> int:
    """Checkpoint step the handle's runner serves (-1 = none loaded)."""
    runner = _registry[handle].get("runner")
    return int(runner.step) if runner is not None else -1


def destroy(handle: int) -> None:
    _registry.pop(handle, None)
