"""Glue around the kernels, the counterpart of ``repro/kernels/ops.py``:
norms and unit rows for the Gram metrics, reference-mask weights, the
estimate-to-key transform of the survivor ordering, the pairwise metrics
built on the pairwise kernels, and ``centrality_kernel`` /
``pairwise_kernel`` for the backend registry.

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


def kernel_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products by the ``dot_pairwise`` kernel:
    (C, d) x (R, d) -> (C, R)."""
    return pk.dot_pairwise(x.float().contiguous(), y.float().contiguous())


def kernel_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise l1 distances by the ``l1_pairwise`` kernel."""
    return pk.l1_pairwise(x.float().contiguous(), y.float().contiguous())


def kernel_sql2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``max(|x|^2 + |y|^2 - 2 G, 0)`` around the ``dot_pairwise`` Gram."""
    g = kernel_dot(x, y)
    return torch.clamp_min(_norms_sq(x)[:, None] + _norms_sq(y)[None, :]
                           - 2.0 * g, 0.0)


def kernel_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(kernel_sql2(x, y))


def kernel_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 - G`` of the unit rows (normalised before the product, as in the
    JAX package; ``distances.pairwise_cosine`` divides G by the norms
    instead, which rounds differently)."""
    return 1.0 - kernel_dot(_unit_rows(x), _unit_rows(y))


def kernel_centrality_sums(x: torch.Tensor, y: torch.Tensor, *,
                           metric: str = "l2",
                           ref_mask: Optional[torch.Tensor] = None,
                           compute_dtype: str = "float32") -> torch.Tensor:
    """Fused ``sum_j d(x_i, y_j)``: (C, d) x (R, d) -> (C,) distance sums.

    ℓ1 goes to the ``l1_centrality`` kernel, the Gram metrics to
    ``dot_centrality``; the (C, R) block never exists in device memory.
    ``ref_mask`` (shape (R,), nonzero = valid) drops invalid references from
    the sum inside the kernel.

    ``compute_dtype="bfloat16"`` runs ``dot_centrality``'s bf16 mode, the
    ``quant_bf16_fused`` backend's path: the norms and the cosine unit rows
    come from the unrounded fp32 rows, the kernel rounds its operands before
    each product. ℓ1 has no product stage and ignores it, as in the JAX
    package: that backend rounds the ℓ1 inputs itself.
    """
    w = _ref_weights(ref_mask, y.shape[0])
    if metric == "l1":
        return pk.l1_centrality(x.float().contiguous(), y.float().contiguous(),
                                w)
    if metric == "cosine":
        return pk.dot_centrality(_unit_rows(x).contiguous(),
                                 _unit_rows(y).contiguous(), None, None, w,
                                 metric=metric, compute_dtype=compute_dtype)
    if metric in ("l2", "sql2"):
        xf, yf = x.float().contiguous(), y.float().contiguous()
        return pk.dot_centrality(xf, yf, _norms_sq(xf), _norms_sq(yf), w,
                                 metric=metric, compute_dtype=compute_dtype)
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


totalorder_keys = pk.totalorder_keys


def kernel_topk_smallest(theta: torch.Tensor, *, keep: int) -> torch.Tensor:
    """Indices (int64) of the ``keep`` smallest entries of ``theta (C,)``,
    ascending, ties toward the smaller index — the stable argsort prefix of
    :func:`totalorder_keys`, bit for bit, by one ``topk_smallest`` launch
    in its fp32 mode (the keys made in registers, no launch of their
    own)."""
    c = theta.shape[0]
    if not 0 < keep <= c:
        raise ValueError(f"keep must be in [1, {c}], got {keep}")
    return pk.topk_smallest_f32(theta.float().contiguous(), keep)


def centrality_kernel(metric: str):
    """Fused row-sum centrality for ``metric``: ``f(x, y, ref_mask=None)
    -> (C,)`` sums."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return functools.partial(kernel_centrality_sums, metric=metric)


_KERNELS = {
    "l1": kernel_l1,
    "l2": kernel_l2,
    "sql2": kernel_sql2,
    "cosine": kernel_cosine,
}


def pairwise_kernel(metric: str):
    """Kernel-backed counterpart of ``distances.pairwise(metric)``."""
    try:
        return _KERNELS[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}") from None
