"""Synthetic datasets with the statistics of the paper's benchmarks, made
with numpy from a seed (float32 arrays).

The generators follow ``repro/data/medoid_datasets.py`` — the same
constructions, parameters and default widths — but draw from numpy, so
their values differ from the JAX package's. Tests that compare the two
packages hand both the same numpy arrays.

* ``rnaseq_like`` — probability-simplex rows (ℓ1), Dirichlet-style with a
  per-point concentration (the paper's RNA-Seq 20k, d = 4096);
* ``netflix_like`` — sparse nonnegative ratings (cosine), a dominant taste
  direction with per-user spread and Zipf item popularity (Netflix 20k,
  d = 2048);
* ``mnist_zeros_like`` — dense one-cluster images (ℓ2) (MNIST zeros,
  d = 784);
* ``planted_medoid`` — a Gaussian cloud with row 0 pulled to the centroid,
  so index 0 is the medoid with a controllable margin.

The k-medoids workload has planted-cluster variants of the same per-metric
structure (``CLUSTER_DATASETS``), each returning ``(data (n, d) float32,
labels (n,) int32)``, with uneven, log-spaced cluster sizes
(:func:`uneven_sizes`, the same sizes as the JAX package's) so that the
per-cluster subproblems span several power-of-two buckets.
"""
from __future__ import annotations

import math

import numpy as np


def rnaseq_like(seed: int, n: int, d: int = 4096, radial: float = 1.5,
                sparsity: float = 0.3) -> np.ndarray:
    rs = np.random.default_rng(seed)
    base = rs.standard_gamma(0.3, size=d) + 1e-3
    base = base / base.sum()
    alpha_pt = np.exp(rs.standard_normal(n) * radial - 1.0)     # lognormal
    shape = np.maximum(alpha_pt[:, None] * base[None, :] * d, 1e-3)
    g = rs.standard_gamma(shape.astype(np.float32), dtype=np.float32)
    mask = rs.random((n, d), dtype=np.float32) < 1.0 - sparsity
    g = g * mask + np.float32(1e-6)
    return g / g.sum(axis=1, keepdims=True)


def netflix_like(seed: int, n: int, d: int = 2048,
                 radial: float = 1.2) -> np.ndarray:
    rs = np.random.default_rng(seed)
    u0 = np.maximum(rs.standard_normal((1, d), dtype=np.float32), 0) + 0.1
    r = (np.exp(rs.standard_normal(n) * radial) * 0.5).astype(np.float32)
    vals = np.maximum(u0 + r[:, None] * rs.standard_normal((n, d),
                                                           dtype=np.float32),
                      0)
    pop = 1.0 / (1.0 + np.arange(d) * 0.05)                      # popularity
    act = np.exp(rs.standard_normal(n) * radial)                 # activity
    p = np.clip(pop[None, :] * act[:, None] * 0.5, 0.0, 1.0)
    x = vals * (rs.random((n, d)) < p)
    # guard all-zero rows (cosine undefined): give them one tiny coordinate
    x[:, 0] += 1e-3
    return x.astype(np.float32)


def mnist_zeros_like(seed: int, n: int, d: int = 784,
                     radial: float = 0.4) -> np.ndarray:
    rs = np.random.default_rng(seed)
    proto = 1.0 / (1.0 + np.exp(-rs.standard_normal((1, d)) * 2.0))
    r = np.exp(rs.standard_normal(n) * radial) * 0.25
    x = proto + r[:, None] * rs.standard_normal((n, d), dtype=np.float32)
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def planted_medoid(seed: int, n: int, d: int = 64,
                   gap: float = 0.5) -> np.ndarray:
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, d), dtype=np.float32)
    x[0] = x.mean(axis=0) * (1.0 - gap * 0.1)
    return x


# name -> (metric, generator(seed, n, d))
DATASETS = {
    "rnaseq20k_like": ("l1", rnaseq_like),
    "netflix20k_like": ("cosine", netflix_like),
    "mnist_zeros_like": ("l2", mnist_zeros_like),
}


# ---------------------------------------------------------------------------
# planted-cluster variants (the k-medoids workload)
# ---------------------------------------------------------------------------

def uneven_sizes(n: int, k: int, spread: float = 2.0) -> list[int]:
    """k log-spaced cluster sizes summing to n (largest ~ e^spread x the
    smallest), none empty."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    w = [math.exp(spread * i / max(1, k - 1)) for i in range(k)]
    sizes = [max(1, int(n * wi / sum(w))) for wi in w]
    diff = n - sum(sizes)      # clamping can overshoot either way
    if diff > 0:
        sizes[-1] += diff
    i = k - 1
    while diff < 0:            # shrink from the largest, never below 1
        take = min(sizes[i] - 1, -diff)
        sizes[i] -= take
        diff += take
        i -= 1
    return sizes


def _labels(sizes) -> np.ndarray:
    return np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)


def planted_clusters(seed: int, n: int, d: int = 64, k: int = 8,
                     gap: float = 4.0, spread: float = 2.0):
    """k well-separated Gaussian blobs (ℓ2): centers ``gap * N(0, 1)``,
    unit noise."""
    labels = _labels(uneven_sizes(n, k, spread))
    rs = np.random.default_rng(seed)
    centers = gap * rs.standard_normal((k, d), dtype=np.float32)
    x = centers[labels] + rs.standard_normal((n, d), dtype=np.float32)
    return x.astype(np.float32), labels


def rnaseq_clusters(seed: int, n: int, d: int = 1024, k: int = 8,
                    concentration: float = 80.0, spread: float = 2.0):
    """Simplex rows (ℓ1) with k planted expression programs: each cluster's
    Dirichlet base concentrates on its own coordinate block over a small
    shared background."""
    labels = _labels(uneven_sizes(n, k, spread))
    rs = np.random.default_rng(seed)
    blk = d // k
    base = rs.standard_gamma(0.5, (k, d)) * 0.02 + 1e-4      # background
    block_mask = (np.arange(d)[None, :] // blk) == np.arange(k)[:, None]
    base = base + block_mask * (rs.standard_gamma(2.0, (k, d)) + 0.5)
    base = base / base.sum(axis=1, keepdims=True)            # (k, d) simplex
    alpha = (concentration * base * d / k).astype(np.float32)
    g = rs.standard_gamma(np.maximum(alpha[labels], 1e-3),
                          dtype=np.float32) + np.float32(1e-8)
    return (g / g.sum(axis=1, keepdims=True)).astype(np.float32), labels


def netflix_clusters(seed: int, n: int, d: int = 512, k: int = 8,
                     noise: float = 0.25, spread: float = 2.0):
    """Sparse nonnegative ratings (cosine) with k taste communities, per-user
    noise and popularity-driven sparsity."""
    labels = _labels(uneven_sizes(n, k, spread))
    rs = np.random.default_rng(seed)
    tastes = np.maximum(rs.standard_normal((k, d), dtype=np.float32), 0) + 0.05
    vals = np.maximum(tastes[labels]
                      + noise * rs.standard_normal((n, d), dtype=np.float32),
                      0)
    pop = np.clip(1.0 / (1.0 + np.arange(d) * 0.02), 0.05, 1.0)
    x = vals * (rs.random((n, d), dtype=np.float32) < pop[None, :])
    x[:, 0] += 1e-3                          # guard all-zero rows
    return x.astype(np.float32), labels


def mnist_clusters(seed: int, n: int, d: int = 784, k: int = 8,
                   noise: float = 0.15, spread: float = 2.0):
    """Dense images (ℓ2): k digit prototypes plus small per-image noise."""
    labels = _labels(uneven_sizes(n, k, spread))
    rs = np.random.default_rng(seed)
    protos = 1.0 / (1.0 + np.exp(-rs.standard_normal((k, d)) * 2.0))
    x = np.clip(protos[labels].astype(np.float32)
                + noise * rs.standard_normal((n, d), dtype=np.float32),
                0.0, 1.0)
    return x.astype(np.float32), labels


# name -> (metric, generator(seed, n, d, k) -> (data, labels))
CLUSTER_DATASETS = {
    "planted": ("l2", planted_clusters),
    "rnaseq_like": ("l1", rnaseq_clusters),
    "netflix_like": ("cosine", netflix_clusters),
    "mnist_like": ("l2", mnist_clusters),
}
