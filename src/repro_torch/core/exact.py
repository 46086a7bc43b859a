"""Exact O(n^2) medoid computation — ground truth for every benchmark."""
from __future__ import annotations

import torch

from repro_torch.core.distances import centrality_sums


def _row_sums(data: torch.Tensor, metric: str, block: int) -> torch.Tensor:
    """sum_j d(x_i, x_j) for every row, ``block`` rows at a time (the ℓ1
    path is also chunked over references, see ``centrality_sums``)."""
    return torch.cat([centrality_sums(data[i:i + block], data, metric)
                      for i in range(0, data.shape[0], block)])


def exact_medoid(data: torch.Tensor, metric: str = "l2",
                 block: int = 256) -> torch.Tensor:
    """Return argmin_i sum_j d(x_i, x_j) (first index on ties), as a 0-d
    int64 tensor on the data's device."""
    return torch.argmin(_row_sums(data, metric, block))


def exact_theta(data: torch.Tensor, metric: str = "l2",
                block: int = 256) -> torch.Tensor:
    """All centralities theta_i = (1/n) sum_j d(x_i, x_j)."""
    return _row_sums(data, metric, block) / data.shape[0]
