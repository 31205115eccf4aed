"""Plain SGD (`xflow_tpu/optim/sgd.py`): w -= lr * g. Stateless."""

from __future__ import annotations

from xflow_tpu_torch.optim.base import Optimizer, register_optimizer


def _init_state(tables):
    return {name: {} for name in tables}


def _apply(tables, opt_state, grads, cfg):
    lr = cfg.optim.sgd.lr
    return {name: w - lr * grads[name] for name, w in tables.items()}, opt_state


OPTIMIZER = register_optimizer(Optimizer(name="sgd", init_state=_init_state, apply=_apply))
