"""Model interface: a model is an `nn.Module` built from the config whose
`forward(tables, batch)` maps named parameter tables and one batch's
tensors to logits [B]. Tables stay outside the module, as plain
``{name: tensor}`` dicts, so one model serves whichever checkpoint
generation is loaded.

Table shapes: ``[S]`` for a scalar table, logical ``[S, K]`` otherwise.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from xflow_tpu_torch.config import Config


class Model(nn.Module):
    name: str = ""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg

    @staticmethod
    def table_specs(cfg: Config) -> Dict[str, tuple]:
        """Table name -> trailing dims (() scalar, (K,) vector)."""
        raise NotImplementedError

    def init_tables(self, generator: torch.Generator, device="cuda") -> Dict[str, torch.Tensor]:
        """Fresh tables (`xflow_tpu/models/base.py::init_tables`): scalar
        tables and the fused table's column 0 (the linear w) are zero;
        vector entries ~ N(0, 1) * optim.v_init_scale under FTRL, the
        constant optim.v_init_sgd under SGD. Drawn on the CPU from
        `generator` (not JAX's bits), then moved to `device`."""
        tables = {}
        S = self.cfg.num_slots
        optim = self.cfg.optim
        for tname, trailing in sorted(self.table_specs(self.cfg).items()):
            if trailing == ():
                t = torch.zeros((S,), dtype=torch.float32)
            else:
                if optim.name == "sgd":
                    t = torch.full((S, trailing[0]), optim.v_init_sgd, dtype=torch.float32)
                else:
                    t = torch.randn((S, trailing[0]), generator=generator) * optim.v_init_scale
                if tname == "wv":
                    t[:, 0] = 0.0
            tables[tname] = t.to(device)
        return tables


_REGISTRY: Dict[str, type] = {}


def register_model(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def get_model(name: str) -> type:
    """The model class registered under `name`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[name]
