"""The serve runner: checkpoint-backed online pCTR prediction
(`xflow_tpu/serve/runner.py`), answered through the same `predict_fn` as
`evaluate`, so offline and online scores of a row agree.

This slice ports loading (tables only, digest-verified, with walk-back)
and prediction on row-major request batches. Hot reload, the HTTP front
end, the coalescer and the batch-shape ladder come later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.data.libffm import parse_line
from xflow_tpu_torch.data.schema import make_batch
from xflow_tpu_torch.evaluate import to_device
from xflow_tpu_torch.models import get_model
from xflow_tpu_torch.models.predict import make_predict_fn
from xflow_tpu_torch.train import checkpoint as ckpt
from xflow_tpu_torch.weights import table_shapes, tables_from_jax


class BadRequest(ValueError):
    """A request answered with 400: a malformed row, or one with no
    parseable features."""


def parse_rows(rows: list, dcfg) -> tuple[list, list]:
    """Request rows (libffm feature lists; a leading label is ignored) ->
    per-row (fields, slots) int32 arrays through the training hash path.
    Raises BadRequest on a non-string row or one with no features."""
    fields_rows, slots_rows = [], []
    for i, row in enumerate(rows):
        if not isinstance(row, str):
            raise BadRequest(f"row {i}: expected a string, got {type(row).__name__}")
        line = row if "\t" in row else "0\t" + row
        parsed = parse_line(line, dcfg.log2_slots, dcfg.hash_salt)
        if parsed is None or parsed[2].size == 0:
            raise BadRequest(f"row {i}: no parseable field:feature tokens in {row!r}")
        _, f, s = parsed
        fields_rows.append(f)
        slots_rows.append(s)
    return fields_rows, slots_rows


@dataclass
class Generation:
    """One loaded model generation: the device tables and their step."""

    tables: dict
    step: int
    gen: int


class ServeRunner:
    """pCTR prediction from the newest loadable checkpoint under
    `cfg.train.checkpoint_dir`, on `device`."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.model = get_model(cfg.model.name)(cfg)
        self._predict = make_predict_fn(self.model)
        self._gen: Optional[Generation] = None
        self._gen_counter = 0

    def load(self) -> Generation:
        """Load the newest committed checkpoint's tables (digest-verified
        per train.checkpoint_verify, walking back past damaged steps) onto
        the device and make it the serving generation."""
        if self.cfg.train.checkpoint_format != "npz":
            raise ValueError(
                f"train.checkpoint_format={self.cfg.train.checkpoint_format!r}: "
                "the port reads npz checkpoints"
            )
        host, step = ckpt.restore_tables(
            self.cfg.train.checkpoint_dir,
            table_shapes(self.cfg),
            verify=self.cfg.train.checkpoint_verify,
        )
        self._gen_counter += 1
        self._gen = Generation(
            tables=tables_from_jax(host, self.cfg, self.device),
            step=int(step),
            gen=self._gen_counter,
        )
        return self._gen

    def predict(self, arrays: dict) -> tuple[np.ndarray, Generation]:
        """One row-major batch {slots, fields, mask, row_mask} of host
        arrays -> (pctr [B] on the host, the generation that answered)."""
        gen = self._gen
        if gen is None:
            raise RuntimeError("no checkpoint loaded; call load() first")
        p = self._predict(gen.tables, to_device(arrays, self.device))
        return p.cpu().numpy(), gen

    def predict_rows(self, rows: list) -> tuple[np.ndarray, Generation]:
        """Parse, pad and predict libffm feature rows in chunks of
        serve.max_batch rows. Returns (pctr [len(rows)], generation)."""
        fields_rows, slots_rows = parse_rows(rows, self.cfg.data)
        B = self.cfg.serve.max_batch
        out = np.empty((len(rows),), np.float32)
        gen = None
        for lo in range(0, len(rows), B):
            chunk = slots_rows[lo : lo + B]
            b = make_batch(fields_rows[lo : lo + B], chunk, [0.0] * len(chunk), B,
                           self.cfg.data.max_nnz)
            p, gen = self.predict(
                {"slots": b.slots, "fields": b.fields, "mask": b.mask, "row_mask": b.row_mask}
            )
            out[lo : lo + len(chunk)] = p[: len(chunk)]
        return out, gen
