"""Arm-loss estimators: how a batch of reference pulls scores each arm.

The counterpart of ``repro/engine/estimators.py``. The round loop
(:func:`repro_torch.engine.halving.run_halving`) owns reference draws and
halving; an :class:`ArmEstimator` owns only the mapping

    (candidate rows (C, d), reference rows (R, d)) -> per-arm raw sums (C,)

plus an optional auxiliary output. Sums are pre-division: the engine divides
by the reference count. ``ref_mask``, when given, is a float weight vector
over the references that enters multiplicatively.

Estimators (the three bandit workloads of BanditPAM/BanditPAM++):

``medoid_centrality``
    ``sum_j d(x_i, y_j)``, the paper's problem, on the backend's fused
    centrality kernels where it has them.
``build_delta``
    BanditPAM BUILD: ``sum_j min(d1_j, d(x_i, y_j))`` against the cached
    nearest-medoid distance ``d1``.
``swap_delta``
    FasterPAM SWAP: one shared draw prices all k swaps of every candidate
    through a ``(C, t)`` block and a ``(t, k)`` one-hot segment sum; the arm
    value is ``min_i delta(c, i)`` and the ``(C, k)`` block is the aux.

Each factory takes a backend's ``fused_estimators`` entry first and
composes ``pairwise``/``centrality_sums`` otherwise.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import distances
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


def _masked_centrality_fn(be, fn, metric: str) -> Callable:
    """Mask-aware form of a backend centrality fn: the built-in backends
    take ``ref_mask`` natively; a registered backend whose fn lacks the
    keyword falls back to masking its pairwise block."""
    try:
        params = inspect.signature(fn).parameters
        mask_native = "ref_mask" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):
        mask_native = False
    if mask_native:
        return lambda x, y, m: fn(x, y, ref_mask=m)
    pw = be.pairwise(metric)
    return lambda x, y, m: distances.masked_rowsum(pw(x, y), m)


def medoid_centrality(backend=None, metric: str = "l2") -> ArmEstimator:
    """The paper's estimator: ``sum_j d(x_i, y_j)``, through the backend's
    fused path when it registers one (``fused_estimators``), else its
    ``centrality_sums``."""
    be = get_backend(backend)
    fused = be.fused_estimators.get("medoid_centrality")
    fn = fused(metric) if fused is not None else be.centrality_sums(metric)
    masked = _masked_centrality_fn(be, fn, metric)

    def score(cand, ref_rows, *, refs, ref_mask=None):
        if ref_mask is None:
            return fn(cand, ref_rows), None
        return masked(cand, ref_rows, ref_mask), None

    return ArmEstimator("medoid_centrality", score)


def build_delta(backend=None, metric: str = "l2", *,
                d1: torch.Tensor) -> ArmEstimator:
    """BanditPAM BUILD estimator: ``sum_j min(d1_j, d(x_i, y_j))``, the
    total cost were arm i added as the next medoid (up to the constant
    ``sum_j d1_j``)."""
    be = get_backend(backend)
    fused = be.fused_estimators.get("build_delta")
    if fused is not None:
        fn = fused(metric)

        def score(cand, ref_rows, *, refs, ref_mask=None):
            return fn(cand, ref_rows, d1[refs], ref_mask=ref_mask), None
    else:
        pw = be.pairwise(metric)

        def score(cand, ref_rows, *, refs, ref_mask=None):
            blk = torch.minimum(pw(cand, ref_rows), d1[refs][None, :])
            return distances.masked_rowsum(blk, ref_mask), None

    return ArmEstimator("build_delta", score)


def swap_delta(backend=None, metric: str = "l2", *, d1: torch.Tensor,
               d2: torch.Tensor, nearest: torch.Tensor,
               k: int) -> ArmEstimator:
    """FasterPAM SWAP estimator. Per candidate c and medoid slot i, over a
    shared reference draw J:

        delta(c, i) = sum_{j in J} min(d(c,j) - d1_j, 0)
                    + sum_{j in J, nearest_j = i} [ min(d(c,j), d2_j) - d1_j
                                                    - min(d(c,j) - d1_j, 0) ]

    The arm value is ``min_i delta(c, i)``; the ``(C, k)`` delta block is
    the aux, so the winner's slot falls out after the loop."""
    be = get_backend(backend)
    fused = be.fused_estimators.get("swap_delta")
    if fused is not None:
        fn = fused(metric)

        def score(cand, ref_rows, *, refs, ref_mask=None):
            delta = fn(cand, ref_rows, d1[refs], d2[refs], nearest[refs], k,
                       ref_mask=ref_mask)
            return torch.min(delta, dim=1).values, delta
    else:
        pw = be.pairwise(metric)

        def score(cand, ref_rows, *, refs, ref_mask=None):
            blk = pw(cand, ref_rows)                          # (C, t)
            d1r, d2r = d1[refs][None, :], d2[refs][None, :]
            gain = torch.clamp_max(blk - d1r, 0.0)            # (C, t)
            term = torch.minimum(blk, d2r) - d1r - gain       # (C, t)
            if ref_mask is not None:
                m = ref_mask.reshape(-1).to(blk.dtype)[None, :]
                gain = gain * m
                term = term * m
            # The one-hot segment sum is a (C, t) x (t, k) product in full
            # fp32 (``_gram`` keeps TF32 off on the card).
            onehot_t = F.one_hot(nearest[refs].long(), k).to(blk.dtype).T
            delta = gain.sum(1, keepdim=True) + distances._gram(term,
                                                                onehot_t)
            return torch.min(delta, dim=1).values, delta

    return ArmEstimator("swap_delta", score)


register_estimator("medoid_centrality", medoid_centrality)
register_estimator("build_delta", build_delta)
register_estimator("swap_delta", swap_delta)
