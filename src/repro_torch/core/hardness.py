"""Theorem 2.1 hardness quantities, the counterpart of
``repro/core/hardness.py``: Delta_i, rho_i, sigma, H2, H~2.

  Delta_i = theta_i - theta_1                       (arm gap; arms sorted)
  sigma   = sqrt(max_i Var_J d(x_i, x_J))           (independent-sampling scale)
  rho_i   = std_J[d(x_1,x_J) - d(x_i,x_J)] / sigma  (correlation gain)

  H2  = max_{i>=2} i / Delta_i^2                    (independent difficulty)
  H~2 = max_{i>=2} i * rho_(i)^2 / Delta_(i)^2      (correlated difficulty,
                                                     arms sorted by Delta/rho)

Exact and O(n^2) on :func:`repro_torch.core.distances.pairwise`, as JAX
computes them on its reference ``pairwise``; variances and deviations are
the population ones (``jnp.var`` / ``jnp.std``), orderings stable.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distances import pairwise


class HardnessStats(NamedTuple):
    theta: torch.Tensor     # (n,) exact centralities, sorted ascending
    order: torch.Tensor     # (n,) original indices in sorted order
    delta: torch.Tensor     # (n,) gaps; delta[0] = 0
    rho: torch.Tensor       # (n,) correlation factors; rho[0] = 0
    sigma: torch.Tensor     # 0-d
    h2: torch.Tensor        # 0-d
    h2_tilde: torch.Tensor  # 0-d


def hardness_stats(data: torch.Tensor, metric: str = "l2") -> HardnessStats:
    """All Theorem 2.1 quantities of ``data (n, d)`` on its device."""
    n = data.shape[0]
    dmat = pairwise(metric)(data, data)              # D[i, j] = d(x_i, x_j)
    theta = dmat.mean(dim=1)
    order = torch.argsort(theta, stable=True)
    theta_s = theta[order]
    delta = theta_s - theta_s[0]

    sigma = torch.sqrt(torch.var(dmat, dim=1, correction=0).max())

    diff = dmat[order[0]][None, :] - dmat[order]     # rows follow sorted arms
    rho = torch.std(diff, dim=1, correction=0) / torch.clamp_min(sigma, 1e-12)

    i_idx = torch.arange(n, dtype=torch.float32, device=data.device) + 1.0
    later = i_idx >= 2
    safe_delta = torch.clamp_min(delta, 1e-12)
    h2 = torch.where(later, i_idx / safe_delta ** 2, -torch.inf).max()

    ratio = torch.where(later, safe_delta / torch.clamp_min(rho, 1e-12),
                        -torch.inf)
    perm = torch.argsort(ratio, stable=True)
    ht = torch.where(later, i_idx * rho[perm] ** 2 / safe_delta[perm] ** 2,
                     -torch.inf)
    return HardnessStats(theta=theta_s, order=order, delta=delta, rho=rho,
                         sigma=sigma, h2=h2, h2_tilde=ht.max())


def predicted_error_bound(n: int, budget: int,
                          stats: HardnessStats) -> torch.Tensor:
    """Theorem 2.1's coarse upper bound on the failure probability."""
    log2n = max(1.0, math.log2(n))
    expo = budget / (16.0 * stats.h2_tilde * stats.sigma ** 2 * log2n)
    return torch.clamp_max(3.0 * log2n * torch.exp(-expo), 1.0)
