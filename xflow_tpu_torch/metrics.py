"""Metrics (`xflow_tpu/metrics.py`): the training loss, the reference's
clamped sigmoid, its rank-sum AUC with its logloss sign, and the
streaming bucketed AUC.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def binary_logloss_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row BCE in nats: softplus(x) - y*x. softplus is logaddexp(x, 0),
    as `jax.nn.softplus`; torch's `softplus` returns x itself above its
    threshold of 20, which would differ."""
    return torch.logaddexp(logits, torch.zeros_like(logits)) - labels * logits


def reference_pctr(logits: torch.Tensor) -> torch.Tensor:
    """σ with the reference's clamps: logit < -30 -> 1e-6, > 30 -> 1.0."""
    p = torch.sigmoid(logits)
    p = torch.where(logits < -30.0, torch.full_like(p, 1e-6), p)
    p = torch.where(logits > 30.0, torch.ones_like(p), p)
    return p


def auc_logloss(pctrs: np.ndarray, labels: np.ndarray, log2: bool = False) -> tuple[float, float]:
    """Rank-sum AUC and mean log-likelihood on the host, (auc, logloss).

    The "logloss" keeps the reference's sign: it is the mean of
    ``y log p + (1-y) log(1-p)``, a negative number. AUC is NaN when one
    class is absent."""
    pctrs = np.asarray(pctrs, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    order = np.argsort(-pctrs, kind="stable")
    sorted_labels = labels[order]
    tp = np.cumsum(sorted_labels)
    area = float((tp * (1.0 - sorted_labels)).sum())
    tp_n = float(sorted_labels.sum())
    fp_n = float(len(labels) - tp_n)
    auc = area / (tp_n * fp_n) if tp_n > 0 and fp_n > 0 else float("nan")
    eps = 1e-15
    p = np.clip(pctrs, eps, 1.0 - eps)
    ll = labels * np.log(p) + (1.0 - labels) * np.log(1.0 - p)
    if log2:
        ll = ll / np.log(2.0)
    return auc, float(ll.mean())


class BucketAUC(NamedTuple):
    """Streaming AUC state: per-score-bucket positive/negative counts in
    float64, summable across batches."""

    pos: np.ndarray
    neg: np.ndarray

    @staticmethod
    def init(num_buckets: int = 8192) -> "BucketAUC":
        z = np.zeros((num_buckets,), dtype=np.float64)
        return BucketAUC(pos=z, neg=z)

    def update(self, pctrs, labels) -> "BucketAUC":
        nb = self.pos.shape[0]
        p = np.asarray(pctrs, np.float64)
        y = np.asarray(labels, np.float64)
        idx = np.clip((p * nb).astype(np.int64), 0, nb - 1)
        pos = self.pos + np.bincount(idx, weights=y, minlength=nb)
        neg = self.neg + np.bincount(idx, weights=1.0 - y, minlength=nb)
        return BucketAUC(pos=pos, neg=neg)

    def compute(self) -> float:
        """AUC from the bucket counts (ties within a bucket count 1/2)."""
        pos, neg = np.asarray(self.pos, np.float64), np.asarray(self.neg, np.float64)
        tp_n, fp_n = pos.sum(), neg.sum()
        if tp_n == 0 or fp_n == 0:
            return float("nan")
        pos_below = np.concatenate([[0.0], np.cumsum(pos)[:-1]])
        area = (neg * (tp_n - pos_below - pos) + neg * pos * 0.5).sum()
        return float(area / (tp_n * fp_n))
