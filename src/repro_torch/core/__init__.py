"""Paper core of the port: correlated sequential halving and the paper's
baselines.

The baselines are exported as in ``repro.core``, resolved at first use:
``core.meddit`` imports the engine, which imports this package's backend
registry, so importing it here would close a cycle.
"""
_EXPORTS = {"MedditResult": "meddit", "meddit_medoid": "meddit",
            "rand_medoid": "rand"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
