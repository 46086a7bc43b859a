"""Quantization-error model: how far can a quantized estimate drift?

The counterpart of ``repro/quant/error.py``. The halving decisions compare
per-arm estimates ``theta_i = mean_j d(x_i, x_j)`` over a shared reference
draw. If quantization moves every distance by at most ``eps_d``, it moves
every estimate by at most ``eps_d`` too, so widening the survivor cut by
``2 * eps_d`` keeps every arm that the fp32 scoring of the same draw would
keep (``run_halving(widen=...)``); the exact fp32 check of the finalists
(:mod:`repro_torch.quant.verify`) then certifies the returned arm.

Two error models, both device code without host reads:

``analytic``
    Worst-case bounds from the dtype's resolution and the data's row norms
    (max row ℓ2 / ℓ1 / ∞ norms ``M2 / M1 / Minf``). bf16: ``|Δgram| <=
    EPS_BF16 * M2^2``, so sql2 ``<= 2 EPS M2^2``, l2 ``<= sqrt(2 EPS) M2``,
    cosine ``<= 2 EPS`` (on unit rows), l1 ``<= 2 U_BF16 M1``. int8
    (``S = Minf / 127``): ``|Δgram| <= S M1 + d S^2 / 4``, and l1 ``<= d S``.
``probe`` (default)
    Measured: the quantized and fp32 blocks of ``p = min(n, 64)`` evenly
    strided rows, the largest mean absolute error of a row over the others,
    times a safety factor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import distances
from repro_torch.kernels.ops import _unit_rows
from repro_torch.quant.backends import check_precision, quant_pairwise

#: Error models understood by :func:`margin`.
ERROR_MODELS = ("probe", "analytic")

#: Per-product relative bound of the bf16-multiply / fp32-accumulate Gram
#: (two input roundings at unit roundoff 2^-8, doubled for the fp32 sums).
EPS_BF16 = 2.0 ** -7
#: bf16 unit roundoff (per-element rounding, the ℓ1 path's scale).
U_BF16 = 2.0 ** -8
#: Probe safety factor: the measured error on the probe block times this.
DEFAULT_SAFETY = 4.0
#: Probe rows (strided over the data; the probe block is probe x probe).
DEFAULT_PROBE = 64


def _row_stats(data: torch.Tensor):
    """(max row ℓ2, max row ℓ1, max |entry|) as device scalars."""
    af = data.float().abs()
    m2 = torch.sqrt(torch.max((af * af).sum(-1)))
    m1 = torch.max(af.sum(-1))
    minf = torch.max(af)
    return m2, m1, minf


def _over_127(a: torch.Tensor) -> torch.Tensor:
    # a device scalar keeps CUDA's division IEEE (see engine/halving.py)
    return a / a.new_full((), 127.0)


def _gram_bound(data: torch.Tensor, precision: str) -> torch.Tensor:
    m2, m1, minf = _row_stats(data)
    if precision == "bf16":
        return EPS_BF16 * m2 * m2
    d = data.shape[-1]
    s = _over_127(minf)
    return s * m1 + d * s * s / 4.0


def analytic_distance_bound(data: torch.Tensor, metric: str,
                            precision: str) -> torch.Tensor:
    """Certified worst-case ``max_pair |d_q - d_f|`` over rows of ``data``
    (a 0-d float32 tensor on the data's device)."""
    check_precision(precision)
    if precision == "fp32":
        return data.new_zeros((), dtype=torch.float32)
    if metric == "cosine":
        return 2.0 * _gram_bound(_unit_rows(data), precision)
    if metric == "l1":
        _, m1, minf = _row_stats(data)
        if precision == "bf16":
            return 2.0 * U_BF16 * m1
        return data.shape[-1] * _over_127(minf)
    eg = _gram_bound(data, precision)
    if metric == "sql2":
        return 2.0 * eg
    if metric == "l2":
        return torch.sqrt(2.0 * eg)
    raise ValueError(f"unknown metric {metric!r}; "
                     f"one of {distances.METRICS}")


def probe_rows(n: int, probe: int = DEFAULT_PROBE) -> np.ndarray:
    """The ``p = min(n, probe)`` strided probe rows, as
    ``jnp.linspace(0, n - 1, p).round()`` gives them: float32
    ``(n - 1) * (i / (p - 1))`` with the last point exactly ``n - 1``,
    rounded half to even. Computed on the host: they depend on n alone."""
    p = min(int(n), int(probe))
    if p == 1:
        return np.zeros(1, np.int64)
    step = np.arange(p - 1, dtype=np.float32) / np.float32(p - 1)
    pts = np.float32(0.0) * (np.float32(1.0) - step) + np.float32(n - 1) * step
    pts = np.append(pts, np.float32(n - 1)).astype(np.float32)
    return np.round(pts).astype(np.int64)


def probe_distance_bound(data: torch.Tensor, metric: str, precision: str,
                         probe: int = DEFAULT_PROBE) -> torch.Tensor:
    """Measured ``max |d_q - d_f|`` over a ``p x p`` block of the probe
    rows (no key), as a 0-d tensor: the largest mean absolute error of a
    probe row over the other probe rows (the self-pair diagonal left out),
    the perturbation a halving estimate, a mean over a shared draw, sees."""
    check_precision(precision)
    if precision == "fp32":
        return data.new_zeros((), dtype=torch.float32)
    idx = torch.as_tensor(probe_rows(data.shape[0], probe),
                          device=data.device)
    p = idx.shape[0]
    rows = data[idx]
    err = (quant_pairwise(metric, precision)(rows, rows)
           - distances.pairwise(metric)(rows, rows)).abs()
    err = err.masked_fill(torch.eye(p, dtype=torch.bool, device=err.device),
                          0.0)
    return torch.max(err.sum(1) / err.new_full((), max(p - 1, 1)))


def margin(data: torch.Tensor, metric: str, precision: str, *,
           model: str = "probe", safety: float = DEFAULT_SAFETY,
           probe: int = DEFAULT_PROBE) -> torch.Tensor:
    """The survivor-cut widening ``2 * eps_d`` of a quantized run (a 0-d
    tensor for ``run_halving(widen=...)``): the analytic bound for
    ``model="analytic"``, the probe's error times ``safety`` for
    ``"probe"``."""
    if model not in ERROR_MODELS:
        raise ValueError(f"unknown error model {model!r}; "
                         f"one of {ERROR_MODELS}")
    if model == "analytic":
        return 2.0 * analytic_distance_bound(data, metric, precision)
    return 2.0 * safety * probe_distance_bound(data, metric, precision,
                                               probe=probe)
