"""Overlap-bin-balanced pair sampling.

Parity with `sample_dataframe` (camera_movement_engine_train_val.py:29-151,
duplicated in both visual-correspondence engines): partition nonzero-overlap
rows into `interval`-wide bins over `[overlap_min, overlap_max]`, give each
bin an equal quota (remainder to the first bins), process bins from the
smallest population upward carrying unmet quota forward, and append a
separate `overlap == 0` sample.

Implementation is vectorized NumPy over column arrays (the reference uses
pandas groupby + per-bin DataFrame.sample); the returned value is an index
array into the input rows, so callers can slice any columnar store.
"""

from __future__ import annotations

import numpy as np


def sample_overlap_balanced(
    overlap: np.ndarray,
    all_overlap_samples: int,
    rng: np.random.Generator,
    non_overlap_samples: int = 0,
    overlap_min: float = 0.0,
    overlap_max: float = 100.0,
    interval: float = 1.0,
) -> np.ndarray:
    """Return row indices of the balanced sample.

    Bin membership matches `pd.cut(..., include_lowest=True)`: bin k covers
    `(edge_k, edge_{k+1}]` with the first bin closed on the left.
    """
    overlap = np.asarray(overlap, dtype=np.float64)
    n = overlap.shape[0]
    idx_all = np.arange(n)

    # overlap == 0 handled separately (reference :48-52).
    zero_idx = idx_all[overlap == 0]
    if len(zero_idx) <= non_overlap_samples:
        sampled_zero = zero_idx
    else:
        sampled_zero = rng.choice(zero_idx, size=non_overlap_samples,
                                  replace=False)

    nonzero_idx = idx_all[overlap != 0]
    vals = overlap[nonzero_idx]

    edges = np.arange(overlap_min, overlap_max + interval, interval,
                      dtype=np.float64)
    if len(edges) < 2:
        return sampled_zero
    # pd.cut semantics: right-closed, include_lowest extends the first edge.
    bin_of = np.digitize(vals, edges, right=True) - 1
    bin_of[np.isclose(vals, edges[0])] = 0
    in_range = (bin_of >= 0) & (bin_of < len(edges) - 1) & (
        vals <= edges[-1]) & ((vals > edges[0]) | np.isclose(vals, edges[0]))
    nonzero_idx = nonzero_idx[in_range]
    bin_of = bin_of[in_range]

    # Populated bins only (pandas groupby drops empty groups).
    bins, counts = np.unique(bin_of, return_counts=True)
    n_bins = len(bins)
    if n_bins == 0:
        return sampled_zero

    base = all_overlap_samples // n_bins
    rem = all_overlap_samples % n_bins
    quotas = np.full(n_bins, base, dtype=np.int64)
    quotas[:rem] += 1

    # Smallest-population-first with leftover carry (reference :96-136).
    order = np.argsort(counts, kind="stable")
    chosen = []
    leftover = 0
    for pos in order:
        quota = int(quotas[pos]) + leftover
        members = nonzero_idx[bin_of == bins[pos]]
        if len(members) <= quota:
            chosen.append(members)
            leftover = quota - len(members)
        else:
            chosen.append(rng.choice(members, size=quota, replace=False))
            leftover = 0

    parts = [c for c in chosen if len(c)] + ([sampled_zero] if len(sampled_zero) else [])
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(parts)
