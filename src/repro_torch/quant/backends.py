"""Reduced-precision distance backends: bf16 and symmetric per-row int8.

The counterpart of ``repro/quant/backends.py``, under the same names. Each
quantized backend provides the round primitives every backend provides
(``pairwise`` / ``centrality_sums``, plus the ``medoid_centrality`` entry of
``fused_estimators``), so every workload runs quantized through the
registry:

``quant_bf16``
    Inputs are rounded to bfloat16 at the Gram stage only; products
    accumulate in fp32, and row norms and the metric epilogues stay fp32.
    ℓ1 has no product form: it sees the rounding of its inputs only.
``quant_int8``
    Symmetric per-row quantization: row i is scaled by ``s_i = max|x_i| /
    127`` and rounded to int8, and the Gram block accumulates exactly in
    integers before one fp32 dequantization ``G = (Q_x Q_y^T) * s_x s_y^T``.
``quant_bf16_fused``
    ``quant_bf16``'s centrality through the ``dot_centrality`` kernel in
    its bf16 mode (``compute_dtype="bfloat16"``); ℓ1 runs the fp32
    ``l1_centrality`` kernel on bf16-rounded inputs.

The Gram stages of ``quant_bf16`` and ``quant_int8`` are plain torch, as
they are plain jnp in the JAX package: a bf16 x bf16 product is exact in
fp32, so ``gram_bf16`` is the fp32 product of the rounded rows (TF32 off),
and ``gram_int8`` sums the int8 products in int32 on the CPU and in float64
on CUDA (torch has no int32 product there), both exact for any d below
2^31 / 127^2 = 133,144.

Quantized estimates are perturbed estimates: the engine widens the survivor
margin by the error model of :mod:`repro_torch.quant.error` and verifies
the final survivors in exact fp32 (:mod:`repro_torch.quant.verify`), see
``MedoidConfig(precision=...)``. ``backend="quant_bf16"`` used directly runs
plain (unwidened) halving on quantized estimates.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import distances
from repro_torch.core.backend import DistanceBackend, register_backend
from repro_torch.kernels import ops as kops

#: Facade-level precision names (``MedoidConfig.precision``).
PRECISIONS = ("fp32", "bf16", "int8")

#: precision -> registered quantized backend name (fp32 -> None: no override).
_QUANT_BACKEND = {"fp32": None, "bf16": "quant_bf16", "int8": "quant_int8"}


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"one of {PRECISIONS}")
    return precision


def backend_for(precision: str, base: str = "reference"):
    """The quantized backend name a precision maps to (None for fp32).

    ``base`` is the caller's fp32 backend: a fused base keeps a fused
    quantized path where one exists (bf16, the kernel's bf16 mode);
    everything else gets the plain quantized backend for that precision.
    """
    name = _QUANT_BACKEND[check_precision(precision)]
    if name == "quant_bf16" and base in ("pallas_fused", "pallas_fused_topk"):
        return "quant_bf16_fused"
    return name


# ----------------------------- bf16 Gram path -------------------------------

def _bf16(a: torch.Tensor) -> torch.Tensor:
    """Storage rounding: fp32 -> bf16, nearest even."""
    return a.float().bfloat16()


def gram_bf16(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """bf16-multiply / fp32-accumulate Gram block."""
    return distances._gram(_bf16(x).float(), _bf16(y).float())


# ----------------------------- int8 path ------------------------------------

def quantize_rows_int8(x: torch.Tensor):
    """Symmetric per-row int8 quantization: ``(q (n, d) int8, s (n,) f32)``
    with ``x ~= q * s[:, None]`` and ``|x - q s| <= s / 2`` per element."""
    xf = x.float()
    # A device scalar keeps CUDA's division IEEE (see engine/halving.py):
    # a scale one ulp off would change the int8 values.
    s = xf.abs().amax(-1) / xf.new_full((), 127.0)
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)  # zero rows: q = 0
    q = torch.clamp(torch.round(xf / s[..., None]), -127.0, 127.0)
    return q.to(torch.int8), s


def _int_gram(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Exact ``qx @ qy.T`` of int8 rows as int32."""
    if qx.device.type == "cpu":
        return qx.int() @ qy.int().T
    return (qx.double() @ qy.double().T).int()


def gram_int8(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row-scaled int8 Gram: exact integer accumulation, one fp32
    dequantization; the only error is the rounding of the inputs."""
    qx, sx = quantize_rows_int8(x)
    qy, sy = quantize_rows_int8(y)
    return _int_gram(qx, qy).float() * sx[:, None] * sy[None, :]


def dequantize_rows_int8(x: torch.Tensor) -> torch.Tensor:
    """The int8 representation mapped back to fp32 (what the ℓ1 path and the
    error model's probe measure distances between)."""
    q, s = quantize_rows_int8(x)
    return q.float() * s[..., None]


# ------------------------- metric blocks per precision ----------------------

def _quant_pairwise(metric: str, gram, l1_repr):
    """Pairwise block for ``metric`` with a quantized Gram stage; row norms
    and the metric epilogue stay fp32."""
    if metric == "l1":
        def l1(x, y):
            return distances.pairwise_l1(l1_repr(x), l1_repr(y))
        return l1
    if metric == "cosine":
        def cos(x, y):
            return 1.0 - gram(kops._unit_rows(x), kops._unit_rows(y))
        return cos
    if metric in ("l2", "sql2"):
        def sq(x, y):
            g = gram(x, y)
            v = torch.clamp_min(kops._norms_sq(x)[:, None]
                                + kops._norms_sq(y)[None, :] - 2.0 * g, 0.0)
            return torch.sqrt(v) if metric == "l2" else v
        return sq
    raise ValueError(f"unknown metric {metric!r}; one of {distances.METRICS}")


def _bf16_repr(a: torch.Tensor) -> torch.Tensor:
    return _bf16(a).float()


def quant_pairwise(metric: str, precision: str):
    """The quantized pairwise block for ``(metric, precision)``, also what
    the error model's probe compares with the reference block."""
    check_precision(precision)
    if precision == "fp32":
        return distances.pairwise(metric)
    if precision == "bf16":
        return _quant_pairwise(metric, gram_bf16, _bf16_repr)
    return _quant_pairwise(metric, gram_int8, dequantize_rows_int8)


def _centrality_of(pairwise_fn):
    def fn(x, y, ref_mask=None):
        return distances.masked_rowsum(pairwise_fn(x, y), ref_mask)
    return fn


def _make_backend(name: str, precision: str) -> DistanceBackend:
    def pairwise(metric: str):
        return quant_pairwise(metric, precision)

    def centrality(metric: str):
        return _centrality_of(quant_pairwise(metric, precision))

    return DistanceBackend(name=name, pairwise=pairwise,
                           centrality_sums=centrality,
                           fused_estimators={"medoid_centrality": centrality})


register_backend(_make_backend("quant_bf16", "bf16"))
register_backend(_make_backend("quant_int8", "int8"))


# ------------------------ fused (kernel) bf16 centrality ---------------------

def _fused_bf16_centrality(metric: str):
    if metric == "l1":
        kern = kops.centrality_kernel(metric)

        def l1(x, y, ref_mask=None):
            return kern(_bf16_repr(x), _bf16_repr(y), ref_mask=ref_mask)
        return l1
    return functools.partial(kops.kernel_centrality_sums, metric=metric,
                             compute_dtype="bfloat16")


register_backend(DistanceBackend(
    name="quant_bf16_fused",
    pairwise=lambda metric: quant_pairwise(metric, "bf16"),
    centrality_sums=_fused_bf16_centrality,
    fused_estimators={"medoid_centrality": _fused_bf16_centrality},
))
