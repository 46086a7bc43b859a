"""Clustering quality metrics (numpy), the counterpart of
``repro/cluster/metrics.py``."""
from __future__ import annotations

import numpy as np


def adjusted_rand_index(labels_a, labels_b) -> float:
    """Adjusted Rand Index between two labelings of the same points: 1.0
    for identical partitions (up to relabeling), ~0.0 for chance agreement
    (Hubert & Arabie's adjustment, from the contingency table)."""
    a = np.asarray(labels_a).ravel()
    b = np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"labelings must cover the same points, got "
                         f"{a.shape} vs {b.shape}")
    n = a.size
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.int64)
    np.add.at(table, (ai, bi), 1)

    def comb2(x):
        x = x.astype(np.float64)
        return (x * (x - 1.0) / 2.0).sum()

    sum_ij = comb2(table)
    sum_a = comb2(table.sum(axis=1))
    sum_b = comb2(table.sum(axis=0))
    total = n * (n - 1.0) / 2.0
    expected = sum_a * sum_b / total
    maximum = (sum_a + sum_b) / 2.0
    if maximum == expected:          # both partitions trivial
        return 1.0
    return float((sum_ij - expected) / (maximum - expected))


def clustering_cost(d_to_medoid) -> float:
    """Total assignment cost: sum of each point's distance to its medoid."""
    return float(np.asarray(d_to_medoid, dtype=np.float64).sum())
