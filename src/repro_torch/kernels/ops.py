"""Glue around the kernels, the counterpart of ``repro/kernels/ops.py``:
norms and unit rows for the Gram metrics, reference-mask weights, the
estimate-to-key transform of the survivor ordering, and ``centrality_kernel``
for the backend registry.

No tile padding is needed: the CUDA kernels guard their own edges. Every
function here runs the kernel on a CUDA tensor and its plain version on a CPU
tensor (see :mod:`repro_torch.kernels.pairwise_distance`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.distances import METRICS
from repro_torch.kernels import pairwise_distance as pk


def _norms_sq(a: torch.Tensor) -> torch.Tensor:
    af = a.float()
    return (af * af).sum(-1)


def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    af = a.float()
    return af / torch.clamp_min(torch.sqrt((af * af).sum(-1, keepdim=True)),
                                1e-12)


def _ref_weights(ref_mask: Optional[torch.Tensor],
                 r: int) -> Optional[torch.Tensor]:
    """A (r,) validity mask (nonzero = valid) as contiguous float32 weights."""
    if ref_mask is None:
        return None
    m = ref_mask.reshape(-1).float().contiguous()
    if m.shape[0] != r:
        raise ValueError(f"ref_mask has {m.shape[0]} entries for {r} "
                         f"references")
    return m


def kernel_centrality_sums(x: torch.Tensor, y: torch.Tensor, *,
                           metric: str = "l2",
                           ref_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Fused ``sum_j d(x_i, y_j)``: (C, d) x (R, d) -> (C,) distance sums.

    ℓ1 goes to the ``l1_centrality`` kernel, the Gram metrics to
    ``dot_centrality``; the (C, R) block never exists in device memory.
    ``ref_mask`` (shape (R,), nonzero = valid) drops invalid references from
    the sum inside the kernel.
    """
    w = _ref_weights(ref_mask, y.shape[0])
    if metric == "l1":
        return pk.l1_centrality(x.float().contiguous(), y.float().contiguous(),
                                w)
    if metric == "cosine":
        return pk.dot_centrality(_unit_rows(x).contiguous(),
                                 _unit_rows(y).contiguous(), None, None, w,
                                 metric=metric)
    if metric in ("l2", "sql2"):
        xf, yf = x.float().contiguous(), y.float().contiguous()
        return pk.dot_centrality(xf, yf, _norms_sq(xf), _norms_sq(yf), w,
                                 metric=metric)
    raise ValueError(f"unknown metric {metric!r}")


def kernel_l1_centrality(x: torch.Tensor, y: torch.Tensor,
                         ref_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Fused mean_j ℓ1(x_i, y_j): (C,) means over the valid references."""
    sums = kernel_centrality_sums(x, y, metric="l1", ref_mask=ref_mask)
    if ref_mask is None:
        # a device scalar keeps CUDA's division IEEE (see engine/halving.py)
        return sums / sums.new_full((), y.shape[0])
    return sums / torch.clamp_min(ref_mask.reshape(-1).float().sum(), 1.0)


def totalorder_keys(theta: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 IEEE-totalorder keys (sign-flip bitcast): integer
    comparison then orders floats like ``lax.top_k`` and the JAX topk
    kernels, -0.0 < +0.0 included, which float comparison would merge."""
    b = theta.float().contiguous().view(torch.int32)
    return torch.where(b >= 0, b, torch.bitwise_not(b) ^ -(2 ** 31))


def kernel_topk_smallest(theta: torch.Tensor, *, keep: int) -> torch.Tensor:
    """Indices (int64) of the ``keep`` smallest entries of ``theta (C,)``,
    ascending, ties toward the smaller index — the stable argsort prefix,
    bit for bit, by the rank/select kernel pair."""
    c = theta.shape[0]
    if not 0 < keep <= c:
        raise ValueError(f"keep must be in [1, {c}], got {keep}")
    return pk.topk_select(pk.topk_rank(totalorder_keys(theta)), keep)


def centrality_kernel(metric: str):
    """Fused row-sum centrality for ``metric``: ``f(x, y, ref_mask=None)
    -> (C,)`` sums."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return functools.partial(kernel_centrality_sums, metric=metric)
