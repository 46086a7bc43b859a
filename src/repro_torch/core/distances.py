"""Distance functions for the medoid engine (plain PyTorch).

The counterpart of ``repro/core/distances.py``: blocked pairwise distances
``D[c, r] = d(X[c], Y[r])`` for ``X: (C, d)``, ``Y: (R, d)``. These are the
reference implementations the port's kernels are held against.

Metrics: ``l1`` (sum |x - y|), ``l2`` (sqrt of sql2), ``sql2`` (sum (x - y)^2,
by the Gram trick and clamped at 0), ``cosine`` (1 - <x, y> / (|x||y|), norm
product floored at 1e-12).

Gram products run in full fp32: :func:`_gram` turns TF32 off for the CUDA
matmul before each product, because a TF32 Gram keeps about three decimal
digits and can flip the halving on near-ties.
"""
from __future__ import annotations

from typing import Callable

import torch

METRICS = ("l1", "l2", "sql2", "cosine")


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    return x @ y.T


def pairwise_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x[:, None, :].float() - y[None, :, :].float()).abs().sum(-1)


def pairwise_sql2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf, yf = x.float(), y.float()
    x2 = (xf * xf).sum(-1)
    y2 = (yf * yf).sum(-1)
    g = _gram(xf, yf)
    # Clamp: the Gram trick can go slightly negative from rounding.
    return torch.clamp_min(x2[:, None] + y2[None, :] - 2.0 * g, 0.0)


def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(pairwise_sql2(x, y))


def pairwise_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf, yf = x.float(), y.float()
    xn = torch.sqrt((xf * xf).sum(-1))
    yn = torch.sqrt((yf * yf).sum(-1))
    g = _gram(xf, yf)
    denom = torch.clamp_min(xn[:, None] * yn[None, :], 1e-12)
    return 1.0 - g / denom


_PAIRWISE: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l1": pairwise_l1,
    "l2": pairwise_l2,
    "sql2": pairwise_sql2,
    "cosine": pairwise_cosine,
}


def pairwise(metric: str) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    """Return the blocked pairwise-distance function for ``metric``."""
    try:
        return _PAIRWISE[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; one of {METRICS}") from None


def masked_rowsum(block: torch.Tensor,
                  ref_mask: torch.Tensor | None) -> torch.Tensor:
    """Row sums of a (C, R) distance block over the valid reference columns
    (``ref_mask`` reshapeable to (R,), nonzero = valid; None = all valid)."""
    if ref_mask is not None:
        block = block * ref_mask.reshape(-1).to(block.dtype)[None, :]
    return block.sum(1)


def full_distance_matrix(x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """All-pairs (n, n) distance matrix — used by exact computation & oracles."""
    return pairwise(metric)(x, x)


def centrality_sums(x: torch.Tensor, refs: torch.Tensor, metric: str,
                    ref_block: int = 32, d_chunk: int = 256,
                    ref_mask: torch.Tensor | None = None) -> torch.Tensor:
    """sum_j d(x_i, refs_j) without materializing the (C, R, d) broadcast.

    For ℓ1 (no matmul form) the intermediate is bounded to
    (C, ref_block, d_chunk); Gram-trick metrics take the row sum of the
    pairwise matrix. ``ref_mask`` (shape (R,), nonzero = valid) restricts
    the sum to valid references.
    """
    if metric != "l1":
        return masked_rowsum(pairwise(metric)(x, refs), ref_mask)
    xf, rf = x.float(), refs.float()
    c, d = xf.shape
    r = rf.shape[0]
    w = torch.ones(r, dtype=torch.float32, device=xf.device)
    if ref_mask is not None:
        w = w * ref_mask.reshape(-1).float()
    acc = torch.zeros(c, dtype=torch.float32, device=xf.device)
    for r0 in range(0, r, ref_block):
        blk, m = rf[r0:r0 + ref_block], w[r0:r0 + ref_block]
        tot = torch.zeros(c, dtype=torch.float32, device=xf.device)
        for c0 in range(0, d, d_chunk):
            a = (xf[:, None, c0:c0 + d_chunk] - blk[None, :, c0:c0 + d_chunk]).abs()
            tot = tot + (a.sum(-1) * m).sum(1)
        acc = acc + tot
    return acc
