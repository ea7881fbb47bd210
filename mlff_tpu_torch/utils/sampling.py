"""Stratified sampling of training/validation indices.

Freedman-Diaconis-binned stratified sampling, behavior-equivalent to the
reference ``GDMLTrain.draw_strat_sample`` (reference: sgdml/train.py:1310-1419)
including the seeded RNG (reference seeds with ``seed_idxs_train=0``,
train.py:280).  Host-side NumPy: this runs once per task, device execution
would be pointless.

A verbatim copy of ``mlff_tpu.utils.sampling`` (host NumPy only), so that the port
imports nothing of the JAX package; equal seeds give bitwise-equal arrays.
"""

from __future__ import annotations

import numpy as np


def draw_strat_sample(
    T: np.ndarray,
    n: int,
    excl_idxs: np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Draw an ``n``-point sample of indices into ``T`` that preserves the
    empirical distribution of ``T`` (histogram-stratified)."""
    rng = np.random.default_rng(seed)
    T = np.asarray(T).ravel()

    if excl_idxs is None or len(excl_idxs) == 0:
        excl_idxs = None

    if n == 0:
        return np.array([], dtype=np.int64)

    if T.size == n:
        assert excl_idxs is None
        return np.arange(n)

    if n == 1:
        idxs_all_non_excl = np.setdiff1d(np.arange(T.size), excl_idxs, assume_unique=True)
        return np.array([rng.choice(idxs_all_non_excl)])

    # Freedman-Diaconis bin width; cap bins at half the sample size.
    h = 2 * np.subtract(*np.percentile(T, [75, 25])) / np.cbrt(n)
    n_bins = int(np.ceil((np.max(T) - np.min(T)) / h)) if h > 0 else 1
    n_bins = min(n_bins, int(n / 2))

    bins = np.linspace(np.min(T), np.max(T), n_bins, endpoint=False)
    idxs = np.digitize(T, bins)

    if excl_idxs is not None and excl_idxs.size > 0:
        idxs[excl_idxs] = n_bins + 1  # send excluded points to an impossible bin

    uniq_all, cnts_all = np.unique(idxs, return_counts=True)

    if excl_idxs is not None and excl_idxs.size > 0:
        excl_bin_idx = np.where(uniq_all == n_bins + 1)
        cnts_all = np.delete(cnts_all, excl_bin_idx)
        uniq_all = np.delete(uniq_all, excl_bin_idx)

    # Proportional allocation, then rebalance to hit exactly n.
    reduced_cnts = np.ceil(cnts_all / np.sum(cnts_all, dtype=float) * n).astype(int)
    reduced_cnts = np.minimum(reduced_cnts, cnts_all)

    reduced_cnts_delta = n - np.sum(reduced_cnts)
    while np.abs(reduced_cnts_delta) > 0:
        max_bin_reduction = np.min(reduced_cnts[np.where(reduced_cnts > 1)]) - 1
        outstanding = rng.choice(
            uniq_all,
            min(max_bin_reduction, np.abs(reduced_cnts_delta)),
            p=(reduced_cnts - 1) / np.sum(reduced_cnts - 1, dtype=float),
            replace=True,
        )
        uniq_outstanding, cnts_outstanding = np.unique(outstanding, return_counts=True)
        outstanding_bucket_idx = np.where(
            np.isin(uniq_all, uniq_outstanding, assume_unique=True)
        )[0]
        reduced_cnts[outstanding_bucket_idx] += (
            np.sign(reduced_cnts_delta) * cnts_outstanding
        )
        reduced_cnts_delta = n - np.sum(reduced_cnts)

    idxs_train = np.empty((0,), dtype=int)
    for uniq_idx, bin_cnt in zip(uniq_all, reduced_cnts):
        idx_in_bin_all = np.where(idxs.ravel() == uniq_idx)[0]
        idxs_train = np.append(
            idxs_train, rng.choice(idx_in_bin_all, bin_cnt, replace=False)
        )
    idxs_train.sort()
    return idxs_train
