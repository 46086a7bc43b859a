"""Quantized distance subsystem of the port: bf16/int8 backends, error
model, exact fp32 verification; the counterpart of ``repro.quant``.

Importing this package registers the quantized backends (``quant_bf16``,
``quant_int8``, ``quant_bf16_fused``) with the backend registry;
:func:`repro_torch.core.backend.get_backend` and ``list_backends`` import it
lazily, so the names resolve everywhere without an explicit import.
"""
from repro_torch.quant.backends import (
    PRECISIONS,
    backend_for,
    check_precision,
    dequantize_rows_int8,
    gram_bf16,
    gram_int8,
    quant_pairwise,
    quantize_rows_int8,
)
from repro_torch.quant.error import (
    DEFAULT_PROBE,
    DEFAULT_SAFETY,
    EPS_BF16,
    ERROR_MODELS,
    U_BF16,
    analytic_distance_bound,
    margin,
    probe_distance_bound,
)
from repro_torch.quant.verify import exact_winner, verify_pulls, verify_width

__all__ = [
    "DEFAULT_PROBE", "DEFAULT_SAFETY", "EPS_BF16", "ERROR_MODELS",
    "PRECISIONS", "U_BF16", "analytic_distance_bound", "backend_for",
    "check_precision", "dequantize_rows_int8", "exact_winner", "gram_bf16",
    "gram_int8", "margin", "probe_distance_bound", "quant_pairwise",
    "quantize_rows_int8", "verify_pulls", "verify_width",
]
