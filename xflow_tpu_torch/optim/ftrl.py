"""FTRL-proximal (`xflow_tpu/optim/ftrl.py`), per element:

    n' = n + g²
    z' = z + g − (√n' − √n)/α · w
    w' = 0                                        if |z'| ≤ λ1
       = −(z' − sign(z')·λ1) / ((β + √n')/α + λ2) otherwise

on dense (w, n, z) tensors, with the reference's lazy-init guard: a slot
that has never seen a gradient (g = 0 this step and n = 0) keeps its w.
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.optim.base import Optimizer, register_optimizer


def _init_state(tables):
    return {
        name: {"n": torch.zeros_like(t), "z": torch.zeros_like(t)}
        for name, t in tables.items()
    }


def weight_of(z_new, n_new, alpha, beta, lambda1, lambda2):
    """The FTRL weight of the new (z', n'), before the lazy-init guard."""
    shrink = torch.sign(z_new) * lambda1
    denom = (beta + torch.sqrt(n_new)) / alpha + lambda2
    return torch.where(torch.abs(z_new) <= lambda1, 0.0, -(z_new - shrink) / denom)


def update_one(w, n, z, g, alpha, beta, lambda1, lambda2):
    """One FTRL step on same-shape tensors -> (w', n', z'). The kernel
    `csrc/scatter_ftrl.cu` repeats this arithmetic op for op."""
    n_new = n + g * g
    z_new = z + g - (torch.sqrt(n_new) - torch.sqrt(n)) / alpha * w
    w_new = weight_of(z_new, n_new, alpha, beta, lambda1, lambda2)
    # lazy-init parity: keep w where the slot has never seen a gradient
    untouched = (g == 0.0) & (n == 0.0)
    w_new = torch.where(untouched, w, w_new)
    return w_new, n_new, z_new


def _apply(tables, opt_state, grads, cfg):
    hp = cfg.optim.ftrl
    new_tables, new_state = {}, {}
    for name, w in tables.items():
        st = opt_state[name]
        w_new, n_new, z_new = update_one(
            w, st["n"], st["z"], grads[name], hp.alpha, hp.beta, hp.lambda1, hp.lambda2
        )
        new_tables[name] = w_new
        new_state[name] = {"n": n_new, "z": z_new}
    return new_tables, new_state


OPTIMIZER = register_optimizer(Optimizer(name="ftrl", init_state=_init_state, apply=_apply))
