"""Exact PAM (BUILD + SWAP), the k-medoids ground truth; the counterpart of
``repro/cluster/pam_exact.py``.

The ``(n, n)`` distance matrix comes from the port's plain distances in row
blocks on the data's device (exactly ``n^2`` distance evaluations, the pull
count every bandit run is compared to); everything after it is the same
numpy on the host as in the JAX package:

* **BUILD**: step t adds the point minimizing ``sum_j min(d1_j, D[i, j])``;
* **SWAP**: best-improvement search; for every swap-in candidate c the
  deltas against all k medoids come from one pass over its matrix row,

      delta(c, i) = sum_j min(D[c,j] - d1_j, 0)
                  + sum_{j: nearest_j = i} [ min(D[c,j], d2_j) - d1_j
                                             - min(D[c,j] - d1_j, 0) ]

  applied until no swap strictly improves the cost.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.distances import pairwise


@dataclass
class PAMResult:
    medoids: list[int]            # k point indices, BUILD order preserved
    labels: np.ndarray            # (n,) medoid slot per point
    cost: float                   # sum of distances to assigned medoids
    pulls: int                    # distance evaluations (= n^2, the matrix)
    swaps: int                    # accepted SWAP moves
    build_medoids: list[int] = field(default_factory=list)  # pre-SWAP seeding


def pam_pulls(n: int) -> int:
    """Distance evaluations exact PAM performs: the full matrix, once."""
    return n * n


def distance_matrix(data: torch.Tensor, metric: str = "l2",
                    block: int = 256) -> np.ndarray:
    """The full (n, n) matrix as host numpy, ``block`` rows at a time on
    the data's device (bounds the ℓ1 broadcast to ``block x n x d``)."""
    dist = pairwise(metric)
    rows = [dist(data[i:i + block], data).cpu().numpy()
            for i in range(0, data.shape[0], block)]
    return np.concatenate(rows, axis=0)


def pam_build(dmat: np.ndarray, k: int) -> tuple[list[int], np.ndarray]:
    """Greedy BUILD on a precomputed matrix: returns (medoids, d1 cache)."""
    n = dmat.shape[0]
    medoids: list[int] = []
    d1 = np.full(n, np.inf)
    for _ in range(k):
        scores = np.minimum(dmat, d1[None, :]).sum(axis=1)
        scores[medoids] = np.inf        # re-picking a medoid gains nothing
        m = int(np.argmin(scores))
        medoids.append(m)
        d1 = np.minimum(d1, dmat[m])
    return medoids, d1


def _caches(dmat: np.ndarray, medoids: list[int]):
    """nearest/second-nearest caches from the medoid columns."""
    cols = dmat[:, medoids]
    order = np.argsort(cols, axis=1, kind="stable")
    nearest = order[:, 0]
    d1 = cols[np.arange(cols.shape[0]), nearest]
    if len(medoids) > 1:
        second = order[:, 1]
        d2 = cols[np.arange(cols.shape[0]), second]
    else:
        d2 = np.full(cols.shape[0], np.inf)
    return nearest.astype(np.int64), d1, d2


def pam_swap(dmat: np.ndarray, medoids: list[int],
             max_rounds: int = 1000) -> tuple[list[int], int]:
    """Best-improvement SWAP until convergence; returns (medoids, swaps)."""
    k = len(medoids)
    medoids = list(medoids)
    swaps = 0
    for _ in range(max_rounds):
        nearest, d1, d2 = _caches(dmat, medoids)
        gain = np.minimum(dmat - d1[None, :], 0.0)          # (n, n)
        shared = gain.sum(axis=1)                           # (n,)
        term = np.minimum(dmat, d2[None, :]) - d1[None, :] - gain
        onehot = np.eye(k)[nearest]                         # (n, k)
        delta = shared[:, None] + term @ onehot             # (n, k)
        delta[medoids, :] = np.inf                          # medoids can't swap in
        c, i = np.unravel_index(np.argmin(delta), delta.shape)
        if delta[c, i] >= -1e-9 * max(1.0, float(d1.sum())):
            break
        medoids[int(i)] = int(c)
        swaps += 1
    return medoids, swaps


def pam_exact(data: torch.Tensor, k: int, metric: str = "l2",
              max_swap_rounds: int = 1000) -> PAMResult:
    """Full exact PAM: BUILD + SWAP-to-convergence on the (n, n) matrix."""
    dmat = distance_matrix(data, metric)
    n = dmat.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    build_meds, _ = pam_build(dmat, k)
    medoids, swaps = pam_swap(dmat, build_meds, max_rounds=max_swap_rounds)
    nearest, d1, _ = _caches(dmat, medoids)
    return PAMResult(medoids=medoids, labels=nearest, cost=float(d1.sum()),
                     pulls=pam_pulls(n), swaps=swaps,
                     build_medoids=build_meds)
