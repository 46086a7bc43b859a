"""Observability of the port, the counterpart of ``repro.obs``: per-round
telemetry, trace events and serving metrics.

* :mod:`repro_torch.obs.telemetry` — the per-round telemetry dict the
  halving loop fills when asked (device tensors, no host read in the loop);
* :mod:`repro_torch.obs.trace` — :class:`TraceSession`, JSONL
  span/round/select events and optional ``torch.profiler`` hooks;
* :mod:`repro_torch.obs.metrics` — counters and histograms with a
  Prometheus text exposition, the :class:`ServerMetrics` bundle of the
  medoid server, and the engine-odometer exposition;
* :mod:`repro_torch.obs.validate` — the schema checks of both files
  (``python -m repro_torch.obs.validate TRACE EXPO``).

The engine imports :mod:`repro_torch.obs.telemetry`, so this package sits
below it; the host-side modules (which import
:mod:`repro_torch.engine.instrument`) load lazily.
"""
from __future__ import annotations

from repro_torch.obs import telemetry

__all__ = ["MetricsRegistry", "ServerMetrics", "TraceSession",
           "instrument_exposition", "telemetry", "telemetry_to_host"]

_LAZY = {
    "TraceSession": ("repro_torch.obs.trace", "TraceSession"),
    "MetricsRegistry": ("repro_torch.obs.metrics", "MetricsRegistry"),
    "ServerMetrics": ("repro_torch.obs.metrics", "ServerMetrics"),
    "instrument_exposition": ("repro_torch.obs.metrics",
                              "instrument_exposition"),
}


def __getattr__(name: str):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}"
                             ) from None
    import importlib

    return getattr(importlib.import_module(modname), attr)


def telemetry_to_host(tel) -> dict:
    """A device telemetry dict as host numpy arrays (one copy per leaf,
    after the answer is already on the host)."""
    return {k: v.cpu().numpy() for k, v in tel.items()}
