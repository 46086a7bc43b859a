"""Distance backends for the medoid engine, the counterpart of
``repro/core/backend.py`` under the same names, so ``backend=`` strings and
test parametrizations are shared with the JAX package.

Every corrSH round needs ``centrality_sums(metric)(x, y, ref_mask=None) ->
(C,)`` row sums ``sum_j d(x_i, y_j)`` over a candidate block ``x: (C, d)``
and a reference block ``y: (R, d)``. Registered backends:

``reference``
    Plain torch distances (:mod:`repro_torch.core.distances`), the ground
    truth; ℓ1 centrality is chunked to bound memory.
``pallas_fused``
    The fused centrality kernels — ``l1_centrality`` for l1 and
    ``dot_centrality`` for l2, sql2 and cosine — hand-written CUDA on the
    card; the (C, R) block never reaches device memory.
``pallas_fused_topk``
    ``pallas_fused`` plus the ``topk_smallest`` rank/select kernel pair as
    the halving step's survivor ordering: stable, in the IEEE total order,
    like the JAX backend of that name (the default sort differs only on
    signed zeros and NaNs, see ``engine.halving.resolve_order_fn``).

The fused backends keep the JAX names although no Pallas runs here. The
``pallas_pairwise`` and ``quant_*`` backends are not ported yet; asking for
them raises ``ValueError`` naming the ROADMAP queue that holds them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Union

import torch

from repro_torch.core import distances
from repro_torch.kernels import ops as kops

PairwiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CentralityFn = Callable[..., torch.Tensor]

# Backend names of the JAX package that this port does not register yet.
NOT_PORTED = {
    "pallas_pairwise": "ROADMAP Queue 2 items 4-5 (k-medoids slice)",
    "quant_bf16": "ROADMAP Queue 1 item 9 (quantized paths)",
    "quant_int8": "ROADMAP Queue 1 item 9 (quantized paths)",
    "quant_bf16_fused": "ROADMAP Queue 1 item 9 (quantized paths)",
}


@dataclass(frozen=True)
class DistanceBackend:
    """One implementation of the round primitives, keyed by metric name.

    ``survivor_order``, when set, replaces the halving step's default stable
    sort with a fused ordering of the estimates.
    ``fused_estimators`` maps an estimator name to a ``metric -> score``
    factory that :mod:`repro_torch.engine.estimators` prefers over
    ``centrality_sums``.
    """
    name: str
    pairwise: Callable[[str], PairwiseFn]
    centrality_sums: Callable[[str], CentralityFn]
    survivor_order: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    fused_estimators: Mapping[str, Callable[[str], Callable]] = \
        field(default_factory=dict)


_REGISTRY: dict[str, DistanceBackend] = {}


def register_backend(backend: DistanceBackend) -> DistanceBackend:
    """Add ``backend`` to the registry (last registration wins on a name)."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(backend: Union[str, DistanceBackend, None]) -> DistanceBackend:
    """Resolve a backend name (or pass an instance through). ``None`` means
    the reference backend."""
    if backend is None:
        return _REGISTRY["reference"]
    if isinstance(backend, DistanceBackend):
        return backend
    if backend in NOT_PORTED:
        raise ValueError(f"backend {backend!r} is not ported to repro_torch "
                         f"yet: see {NOT_PORTED[backend]}")
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; one of {list_backends()}") from None


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _reference_centrality(metric: str) -> CentralityFn:
    def fn(x: torch.Tensor, y: torch.Tensor,
           ref_mask: torch.Tensor | None = None) -> torch.Tensor:
        return distances.centrality_sums(x, y, metric, ref_mask=ref_mask)
    return fn


def _no_pairwise_kernel(metric: str) -> PairwiseFn:
    raise ValueError("the pairwise kernels (dot_pairwise, l1_pairwise) are "
                     "not ported yet: see ROADMAP Queue 2 items 4-5")


def _order_epilogue(theta: torch.Tensor) -> torch.Tensor:
    # The full ordering is the keep == C case of the rank/select pair.
    return kops.kernel_topk_smallest(theta, keep=theta.shape[0])


register_backend(DistanceBackend(
    name="reference",
    pairwise=distances.pairwise,
    centrality_sums=_reference_centrality,
))

_FUSED_ESTIMATORS = {"medoid_centrality": kops.centrality_kernel}

register_backend(DistanceBackend(
    name="pallas_fused",
    pairwise=_no_pairwise_kernel,
    centrality_sums=kops.centrality_kernel,
    fused_estimators=_FUSED_ESTIMATORS,
))

register_backend(DistanceBackend(
    name="pallas_fused_topk",
    pairwise=_no_pairwise_kernel,
    centrality_sums=kops.centrality_kernel,
    survivor_order=_order_epilogue,
    fused_estimators=_FUSED_ESTIMATORS,
))
