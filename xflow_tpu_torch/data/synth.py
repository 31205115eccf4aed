"""Deterministic synthetic libffm shards (numpy only), after
`xflow_tpu/data/synth.py`: the same writers with the same random
streams, so one seed writes the same bytes from either package.

Rows have one feature per field; feature ids are globalized per field
(``field * ids_per_field + id``), and labels follow a planted truth
plus Gaussian noise, so a trained model beats AUC 0.5: the sparse-LR
truth (`truth_density` zeroes a share of it) or the field-pair truth
(`truth="ffm"`) that a field-aware model fits and a plain FM cannot.
`zipf_alpha > 0` draws each field's ids from a power law, with the
hot head at the low ids; `truth_seed` (default `seed`) lets a train and
a test split share one truth.

`generate_shards` writes row by row; `generate_shards_bulk` samples and
formats whole chunks (another random stream) for large shards and can
return the ids it emitted (`track_seen`). `python -m xflow_tpu_torch
gen-data` drives both.
"""

from __future__ import annotations

import os

import numpy as np


def _planted_truth(truth_rng, num_fields, ids_per_field, truth_density):
    """Shared planted-truth weights — ONE implementation so the per-row
    and bulk writers can never diverge on the concept they plant."""
    truth = truth_rng.normal(0.0, 1.0, size=(num_fields, ids_per_field))
    if truth_density < 1.0:
        truth = truth * (truth_rng.random((num_fields, ids_per_field)) < truth_density)
    return truth


def _planted_ffm_truth(truth_rng, num_fields, ids_per_field, dim=3):
    """Field-PAIR interaction ground truth (the field-aware models'
    learnability gate): per-feature latent u ∈ R^dim shared across
    pairs, with an independent ±1 sign per unordered FIELD pair —
    logit(row) = scale · Σ_{a<b} s_ab ⟨u_a[i_a], u_b[i_b]⟩.

    The sign matrix is (with overwhelming probability for ≥3 fields)
    NOT separable as s_ab = σ_a·σ_b, so a plain FM — whose ⟨v_i, v_j⟩
    is field-blind — cannot represent the concept with the same latent
    budget, while FFM fits it directly (v_{i,b} = ±u_i). `scale` keeps
    logit variance ≈ num_fields, matching the linear truth's SNR."""
    u = truth_rng.normal(0.0, 1.0, size=(num_fields, ids_per_field, dim))
    s = np.triu(
        np.where(truth_rng.random((num_fields, num_fields)) < 0.5, 1.0, -1.0), 1
    )
    n_pairs = num_fields * (num_fields - 1) // 2
    scale = np.sqrt(num_fields / max(n_pairs * dim, 1))
    return u, s, scale


def _zipf_cdf(ids_per_field, zipf_alpha):
    if zipf_alpha <= 0.0:
        return None
    pmf = 1.0 / np.arange(1, ids_per_field + 1, dtype=np.float64) ** zipf_alpha
    return np.cumsum(pmf / pmf.sum())


def generate_shards(
    out_prefix: str,
    num_shards: int,
    rows_per_shard: int,
    num_fields: int = 18,
    # 500 keeps the default 10k-row dataset dense enough that train and
    # test SHARE features (10k ids/field made them near-disjoint: a run
    # with defaults evaluated at AUC ~0.50 and looked like a non-learner)
    ids_per_field: int = 500,
    seed: int = 0,
    noise: float = 1.0,
    truth_density: float = 1.0,
    truth_seed: int | None = None,
    zipf_alpha: float = 0.0,
    truth: str = "linear",
) -> list[str]:
    """Write `<out_prefix>-%05d` libffm shards; returns the paths.

    `seed` drives row sampling; the planted ground-truth weights come
    from `truth_seed` (default: `seed`). Generate train and test splits
    with the same `truth_seed` but different `seed` so they share the
    underlying concept.

    `zipf_alpha > 0` draws per-field feature ids from a Zipf-like power
    law (P(rank r) ∝ 1/r^alpha) instead of uniform — the shape of real
    CTR data (Criteo/Avazu categorical frequencies are heavy-tailed),
    where a few hot features dominate every batch. Uniform sampling is
    the worst case for gather locality and hides the wins from
    batch-level key dedup. alpha≈1.1 approximates Criteo-like skew.

    `truth="ffm"` plants the field-PAIR interaction concept
    (`_planted_ffm_truth`) instead of the linear one — the learnability
    gate for field-aware models: FFM fits it
    directly, a field-blind FM cannot with the same latent budget.
    """
    rng = np.random.default_rng(seed)
    truth_rng = np.random.default_rng(seed if truth_seed is None else truth_seed)
    if truth not in ("linear", "ffm"):
        raise ValueError(f"truth={truth!r}: expected linear|ffm")
    ffm_truth = truth == "ffm"
    if ffm_truth:
        u, s_pairs, scale = _planted_ffm_truth(truth_rng, num_fields, ids_per_field)
    else:
        w_truth = _planted_truth(truth_rng, num_fields, ids_per_field, truth_density)
    value = 1.0 / np.sqrt(num_fields)
    zipf_cdf = _zipf_cdf(ids_per_field, zipf_alpha)
    paths = []
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for shard in range(num_shards):
        path = "%s-%05d" % (out_prefix, shard)
        with open(path, "w") as f:
            for _ in range(rows_per_shard):
                if zipf_cdf is not None:
                    # inverse-CDF sampling; rank r maps to feature id r-1,
                    # so low ids are the hot head of every field
                    ids = np.searchsorted(zipf_cdf, rng.random(num_fields))
                else:
                    ids = rng.integers(0, ids_per_field, size=num_fields)
                if ffm_truth:
                    # Σ_{a<b} s_ab ⟨u_a[i_a], u_b[i_b]⟩ via one gram matrix
                    ur = u[np.arange(num_fields), ids]  # [nf, d]
                    logit = scale * float(
                        (s_pairs * (ur @ ur.T)).sum()
                    ) + rng.normal(0.0, noise)
                else:
                    logit = w_truth[np.arange(num_fields), ids].sum() + rng.normal(0.0, noise)
                label = 1 if logit > 0 else 0
                # feature-id strings are globalized per field (fg*ids_per_field
                # + id): models hash the id token alone (as the reference does),
                # so per-field ids must not collide across fields
                toks = " ".join(
                    "%d:%d:%.4f" % (fg, fg * ids_per_field + ids[fg], value)
                    for fg in range(num_fields)
                )
                f.write("%d\t%s\n" % (label, toks))
        paths.append(path)
    return paths


def generate_shards_bulk(
    out_prefix: str,
    num_shards: int,
    rows_per_shard: int,
    num_fields: int = 18,
    ids_per_field: int = 500,
    seed: int = 0,
    noise: float = 1.0,
    truth_density: float = 1.0,
    truth_seed: int | None = None,
    zipf_alpha: float = 0.0,
    chunk_rows: int = 200_000,
    track_seen: bool = False,
    truth: str = "linear",
):
    """Chunked vectorized writer for realistic-scale datasets (≥10M rows,
    the JAX package's baseline configs): same planted-truth model as
    `generate_shards` but sampled a whole chunk at a time — far faster
    than the per-row loop, which at 10M rows is the difference between
    minutes and hours on one core. A separate function (not a fast-path inside `generate_shards`)
    because the RNG stream differs: tests pin the per-row
    stream's exact output.

    Returns (paths, seen) — `seen` is a [num_fields * ids_per_field]
    bool array marking every feature id actually emitted (None unless
    `track_seen`), which makes exact collision accounting free at
    generation time instead of a 180M-token file re-scan.
    """
    rng = np.random.default_rng(seed)
    truth_rng = np.random.default_rng(seed if truth_seed is None else truth_seed)
    if truth not in ("linear", "ffm"):
        raise ValueError(f"truth={truth!r}: expected linear|ffm")
    ffm_truth = truth == "ffm"
    if ffm_truth:
        # same planted concept as generate_shards' truth="ffm" (field-
        # pair interactions a field-blind FM cannot fit); scored per
        # CHUNK through one gram einsum instead of per row
        u, s_pairs, scale = _planted_ffm_truth(truth_rng, num_fields, ids_per_field)
    else:
        w_truth = _planted_truth(truth_rng, num_fields, ids_per_field, truth_density)
    value_suffix = ":%.4f" % (1.0 / np.sqrt(num_fields))
    zipf_cdf = _zipf_cdf(ids_per_field, zipf_alpha)
    seen = (
        np.zeros(num_fields * ids_per_field, bool) if track_seen else None
    )
    offsets = (np.arange(num_fields) * ids_per_field)[None, :]
    # one row's line: "label\tfg:gid:value" tokens, a space between
    # them (the JAX writer assembles the same bytes with numpy's string
    # kernels; one %-format a row writes them several times faster)
    line_fmt = "%d\t" + " ".join(f"{fg}:%d{value_suffix}" for fg in range(num_fields))
    paths = []
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for shard in range(num_shards):
        path = "%s-%05d" % (out_prefix, shard)
        with open(path, "w") as f:
            left = rows_per_shard
            while left > 0:
                c = min(chunk_rows, left)
                left -= c
                if zipf_cdf is not None:
                    ids = np.searchsorted(
                        zipf_cdf, rng.random((c, num_fields))
                    ).astype(np.int64)
                else:
                    ids = rng.integers(0, ids_per_field, size=(c, num_fields))
                if ffm_truth:
                    ur = u[np.arange(num_fields)[None, :], ids]  # [c, nf, d]
                    gram = np.einsum("cad,cbd->cab", ur, ur)
                    logit = scale * (gram * s_pairs[None]).sum(axis=(1, 2))
                else:
                    logit = w_truth[np.arange(num_fields)[None, :], ids].sum(axis=1)
                logit = logit + rng.normal(0.0, noise, size=c)
                labels = (logit > 0).astype(np.int64)
                gids = ids + offsets
                if seen is not None:
                    seen[gids.ravel()] = True
                rows = np.concatenate([labels[:, None], gids], axis=1).tolist()
                f.write("\n".join([line_fmt % tuple(r) for r in rows]))
                f.write("\n")
        paths.append(path)
    return paths, seen
