"""Paper core of the port: correlated sequential halving and the paper's
baselines.

The baselines and the deprecated pre-facade entry points
(``corr_sh_medoid*``) are exported as in ``repro.core``, resolved at first
use: ``core.meddit`` and ``core.corr_sh`` import the engine, which imports
this package's backend registry, so importing them here would close a
cycle.
"""
_EXPORTS = {"MedditResult": "meddit", "meddit_medoid": "meddit",
            "rand_medoid": "rand", "corr_sh_medoid": "corr_sh",
            "corr_sh_medoid_batch": "corr_sh",
            "corr_sh_medoid_ragged": "corr_sh"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
