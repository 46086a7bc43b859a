"""Plain-torch oracles for the kernels (ground truth in tests and on the card),
the counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core.distances import _gram, pairwise, pairwise_l1


def ref_dot_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _gram(x.float(), y.float())


def ref_l1_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(x, y)


def ref_l1_centrality(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(x, y).sum(1, keepdim=True)


def ref_pairwise(metric: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return pairwise(metric)(x, y)
