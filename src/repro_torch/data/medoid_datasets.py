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
"""
from __future__ import annotations

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
