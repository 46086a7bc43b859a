"""Warn-once deprecation shims for the pre-facade entry points.

The counterpart of ``repro.deprecation``. The facade
(:mod:`repro_torch.api`) is the documented surface; the old per-module
entry points (``repro_torch.core.corr_sh.corr_sh_medoid*``,
``repro_torch.cluster.kmedoids.bandit_kmedoids``) keep working but emit one
:class:`DeprecationWarning` per process. Python's warning registry dedupes
per call site, which under-reports across modules; the explicit set here
makes "exactly once per entry point" testable
(``tests/test_torch_deprecation.py``)."""
from __future__ import annotations

import warnings

_WARNED: set[str] = set()


def warn_once(old: str, new: str) -> None:
    """Emit a DeprecationWarning for ``old`` (qualified name) once per
    process, pointing at its ``repro_torch.api`` replacement."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(f"{old} is deprecated; use {new} instead",
                  DeprecationWarning, stacklevel=3)


def _reset_for_tests() -> None:
    _WARNED.clear()
