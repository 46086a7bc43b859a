"""The correlated-SH round loop, the counterpart of ``repro/engine/halving.py``.

Each round splits the key (``key, sub = split(key)``), draws ``t_r``
references as a prefix of ``permutation(sub, n)``, scores the surviving arms
with the problem's estimator, orders them by estimate with a stable sort and
keeps the first ``ceil(s_r / 2)``. The output round ``r_stop`` (the first
exact round, or the first with at most two survivors) scores its survivors
at their static shape, and the answer is the first-index argmin.

**How this differs from the JAX loop.** JAX runs the rounds before
``r_stop`` as banded ``lax.scan``s over fixed-width buffers: the survivor
buffer keeps its band's width with dead arms at ``+inf``, and each round
draws a reference buffer of the band's largest ``t_r`` weighted by
``position < t_r``. Eager PyTorch has no compile cost to amortise, so this
loop runs every round at its exact ``(s_r, t_r)`` shape: it scores
``data[idx]`` against ``data[perm[:t_r]]`` and sets
``idx = idx[order(theta)][:ceil(s_r / 2)]``. That selects the same arms as
JAX's positional masks — the same reference set, the same estimates up to
summation order, stable ties broken toward the smaller buffer position — and
skips the band's padded work (up to 2.3x the scheduled pulls). Only an exact
tie that summation order breaks differently could select differently.

The ragged engine's ``arm_mask``/``ref_mask`` and the quantized path's
``widen`` belong to later slices and are not here. The loop never reads a
device value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core.backend import DistanceBackend, get_backend
from repro_torch.engine import rng
from repro_torch.engine.estimators import ArmEstimator
from repro_torch.engine.schedule import Round, as_schedule, stop_round

BackendLike = Union[str, DistanceBackend, None]
OrderFn = Callable[[torch.Tensor], torch.Tensor]


def sample_refs(key: rng.Key, n: int, t: int) -> torch.Tensor:
    """t reference indices, uniform without replacement (permutation prefix)."""
    if t >= n:
        return torch.arange(n, device=key.device)
    return rng.permutation(key, n)[:t]


def default_order(theta: torch.Tensor) -> torch.Tensor:
    """Full stable ascending ordering of ``theta``, as ``jnp.argsort`` gives
    it: ``-0.0`` and ``+0.0`` tie (index order), NaNs of either sign last."""
    return torch.argsort(theta, stable=True)


def resolve_order_fn(backend: BackendLike) -> OrderFn:
    """The halving step's survivor ordering: the backend's fused
    ``survivor_order`` when it has one, else :func:`default_order`.

    The two agree except on signed zeros and NaNs, exactly as in the JAX
    package: ``jnp.argsort`` ties ``-0.0`` with ``+0.0`` and puts every NaN
    last, while the rank/select kernels order the IEEE total order
    (``-NaN < -inf < -0.0 < +0.0 < +inf < +NaN``), like ``lax.top_k``."""
    fn = get_backend(backend).survivor_order
    return fn if fn is not None else default_order


def _mean(sums: torch.Tensor, count: int) -> torch.Tensor:
    # Divide by a device scalar: CUDA torch turns division by a Python number
    # into multiplication by its reciprocal, which can round one ulp away
    # from the IEEE quotient JAX computes.
    return sums / sums.new_full((), count)


@dataclass(frozen=True)
class HalvingProblem:
    """One bandit-argmin instance: ``data (n, d)`` — row i is both arm i and
    reference i — and the estimator that scores a reference batch per arm."""
    data: torch.Tensor
    estimator: ArmEstimator


@dataclass(frozen=True)
class HalvingOutcome:
    """What one ``run_halving`` pass produced: ``winner`` (0-d int64 global
    index), ``winner_pos`` its position in ``survivors`` (the output round's
    global indices), ``theta`` the output round's estimates over
    ``survivors``, the estimator's ``aux`` of that round, and ``r_stop``."""
    winner: torch.Tensor
    winner_pos: torch.Tensor
    survivors: torch.Tensor
    theta: torch.Tensor
    aux: Any
    r_stop: int


def run_halving(problem: HalvingProblem, schedule: Sequence[Round],
                backend: BackendLike = None, *, key: rng.Key,
                survivor_order: Optional[OrderFn] = None) -> HalvingOutcome:
    """Run correlated sequential halving over ``schedule`` (non-empty:
    ``n == 1`` has an empty schedule and the caller answers arm 0).

    ``backend`` only resolves the survivor ordering (pass ``survivor_order``
    to skip the lookup); the distance path lives in ``problem.estimator``.
    """
    sched = as_schedule(schedule)
    if not len(sched):
        raise ValueError("empty schedule: n == 1 needs no halving — the "
                         "caller should short-circuit to arm 0")
    order_fn = survivor_order if survivor_order is not None \
        else resolve_order_fn(backend)
    data, est = problem.data, problem.estimator
    n = data.shape[0]
    r_stop = stop_round(list(sched))
    idx = torch.arange(n, device=data.device)
    for r in range(r_stop):
        t = sched[r].num_refs
        key, sub = rng.split(key)
        refs = rng.permutation(sub, n)[:t]        # t < n before r_stop
        sums, _ = est.score(data[idx], data[refs], refs=refs)
        idx = idx[order_fn(_mean(sums, t))][:sched[r + 1].survivors]

    key, sub = rng.split(key)
    refs = sample_refs(sub, n, sched[r_stop].num_refs)
    sums, aux = est.score(data[idx], data[refs], refs=refs)
    theta = _mean(sums, refs.shape[0])
    pos = torch.argmin(theta)
    return HalvingOutcome(winner=idx[pos], winner_pos=pos, survivors=idx,
                          theta=theta, aux=aux, r_stop=r_stop)
