"""Optimizer interface (`xflow_tpu/optim/base.py`): an optimizer is a pure
function over dense per-table state. FTRL's closed-form w is a function
of (z, n), and a zero gradient leaves (z, n) unchanged, so applying the
update to every slot is a no-op for untouched slots and no touched-mask
is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class Optimizer:
    name: str
    # tables -> opt_state ({table: {leaf: tensor}})
    init_state: Callable
    # (tables, opt_state, grads, cfg) -> (new_tables, new_opt_state)
    apply: Callable


_REGISTRY: Dict[str, Optimizer] = {}


def register_optimizer(opt: Optimizer) -> Optimizer:
    _REGISTRY[opt.name] = opt
    return opt


def get_optimizer(name: str) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
