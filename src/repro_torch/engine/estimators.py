"""Arm-loss estimators: how a batch of reference pulls scores each arm.

The counterpart of ``repro/engine/estimators.py``. The round loop
(:func:`repro_torch.engine.halving.run_halving`) owns reference draws and
halving; an :class:`ArmEstimator` owns only the mapping

    (candidate rows (C, d), reference rows (R, d)) -> per-arm raw sums (C,)

plus an optional auxiliary output. Sums are pre-division: the engine divides
by the reference count. ``ref_mask``, when given, is a float weight vector
over the references that enters multiplicatively.

This slice ports ``medoid_centrality`` (the paper's estimator);
``build_delta`` and ``swap_delta`` come with k-medoids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.backend import get_backend

# score(cand_rows, ref_rows, *, refs, ref_mask=None) -> (sums (C,), aux)
ScoreFn = Callable[..., Tuple[torch.Tensor, Any]]


@dataclass(frozen=True)
class ArmEstimator:
    """One arm-loss estimator: a name (for registries) + score fn."""
    name: str
    score: ScoreFn


# name -> factory(backend, metric, **params) -> ArmEstimator
_ESTIMATORS: dict[str, Callable[..., ArmEstimator]] = {}


def register_estimator(name: str, factory: Callable[..., ArmEstimator],
                       ) -> Callable[..., ArmEstimator]:
    """Register an estimator factory (last registration wins on a name)."""
    _ESTIMATORS[name] = factory
    return factory


def get_estimator(name: str) -> Callable[..., ArmEstimator]:
    try:
        return _ESTIMATORS[name]
    except KeyError:
        raise ValueError(f"unknown estimator {name!r}; "
                         f"one of {list_estimators()}") from None


def list_estimators() -> tuple[str, ...]:
    return tuple(sorted(_ESTIMATORS))


def medoid_centrality(backend=None, metric: str = "l2") -> ArmEstimator:
    """The paper's estimator: ``sum_j d(x_i, y_j)``, through the backend's
    fused path when it registers one (``fused_estimators``), else its
    ``centrality_sums``."""
    be = get_backend(backend)
    fused = be.fused_estimators.get("medoid_centrality")
    fn = fused(metric) if fused is not None else be.centrality_sums(metric)

    def score(cand, ref_rows, *, refs, ref_mask=None):
        return fn(cand, ref_rows, ref_mask=ref_mask), None

    return ArmEstimator("medoid_centrality", score)


register_estimator("medoid_centrality", medoid_centrality)
