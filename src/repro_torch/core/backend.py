"""Distance backends for the medoid engine, the counterpart of
``repro/core/backend.py`` under the same names, so ``backend=`` strings and
test parametrizations are shared with the JAX package.

Every corrSH round needs ``centrality_sums(metric)(x, y, ref_mask=None) ->
(C,)`` row sums ``sum_j d(x_i, y_j)`` over a candidate block ``x: (C, d)``
and a reference block ``y: (R, d)``. Registered backends:

``reference``
    Plain torch distances (:mod:`repro_torch.core.distances`), the ground
    truth; ℓ1 centrality is chunked to bound memory.
``pallas_pairwise``
    The pairwise kernels (``dot_pairwise`` under l2, sql2 and cosine,
    ``l1_pairwise`` for l1) for the (C, R) block; centrality is the row sum
    of that block outside the kernel, so the block goes through device
    memory.
``pallas_fused``
    The fused centrality kernels — ``l1_centrality`` for l1 and
    ``dot_centrality`` for l2, sql2 and cosine — hand-written CUDA on the
    card; the (C, R) block never reaches device memory. Its ``pairwise``
    (the k-medoids estimators and caches) is the pairwise kernels'.
``pallas_fused_topk``
    ``pallas_fused`` plus the ``topk_smallest`` kernel (the TPU's
    rank/select pair in one launch) as the halving step's survivor
    ordering: stable, in the IEEE total order, like the JAX backend of that
    name (the default sort differs only on signed zeros and NaNs, see
    ``engine.halving.resolve_order_fn``).

The backends keep the JAX names although no Pallas runs here. The
quantized backends (``quant_bf16``, ``quant_int8``, ``quant_bf16_fused``)
live in :mod:`repro_torch.quant`, which imports this module; the resolvers
import it lazily, as the JAX registry does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Union

import torch

from repro_torch.core import distances
from repro_torch.kernels import ops as kops

PairwiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CentralityFn = Callable[..., torch.Tensor]

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


def _ensure_plugins() -> None:
    """Import the packages that register backends from above this module
    in the layering (they import it, so it cannot import them at module
    scope): :mod:`repro_torch.quant`."""
    import repro_torch.quant.backends  # noqa: F401  (registers quant_*)


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
    if backend not in _REGISTRY:
        _ensure_plugins()
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; one of {list_backends()}") from None


def list_backends() -> tuple[str, ...]:
    _ensure_plugins()
    return tuple(sorted(_REGISTRY))


def _reference_centrality(metric: str) -> CentralityFn:
    def fn(x: torch.Tensor, y: torch.Tensor,
           ref_mask: torch.Tensor | None = None) -> torch.Tensor:
        return distances.centrality_sums(x, y, metric, ref_mask=ref_mask)
    return fn


def _pairwise_rowsum_centrality(metric: str) -> CentralityFn:
    kernel = kops.pairwise_kernel(metric)

    def fn(x: torch.Tensor, y: torch.Tensor,
           ref_mask: torch.Tensor | None = None) -> torch.Tensor:
        return distances.masked_rowsum(kernel(x, y), ref_mask)
    return fn


def _order_epilogue(theta: torch.Tensor) -> torch.Tensor:
    # The full ordering is the keep == C case of topk_smallest.
    return kops.kernel_topk_smallest(theta, keep=theta.shape[0])


register_backend(DistanceBackend(
    name="reference",
    pairwise=distances.pairwise,
    centrality_sums=_reference_centrality,
))

register_backend(DistanceBackend(
    name="pallas_pairwise",
    pairwise=kops.pairwise_kernel,
    centrality_sums=_pairwise_rowsum_centrality,
))

_FUSED_ESTIMATORS = {"medoid_centrality": kops.centrality_kernel}

register_backend(DistanceBackend(
    name="pallas_fused",
    pairwise=kops.pairwise_kernel,
    centrality_sums=kops.centrality_kernel,
    fused_estimators=_FUSED_ESTIMATORS,
))

register_backend(DistanceBackend(
    name="pallas_fused_topk",
    pairwise=kops.pairwise_kernel,
    centrality_sums=kops.centrality_kernel,
    survivor_order=_order_epilogue,
    fused_estimators=_FUSED_ESTIMATORS,
))
