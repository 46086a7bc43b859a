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

**Masks** (the ragged engine and k-medoids). ``arm_mask`` marks the arms
that may survive and win: an arm outside it gets ``+inf`` before every
ordering and in the output round. ``ref_mask`` marks the points that may
serve as references: each round draws the valid-first stable partition of
``permutation(sub, n)`` (:func:`sample_refs_masked`), cut to ``t_r``, weights
the drawn references by ``ref_mask[refs]`` and divides by
``max(sum(weights), 1)``. JAX gives its dead buffer slots the same ``+inf``
as masked arms, with the dead slots behind every live position, and breaks
ties by buffer position; so the first ``s_{r+1}`` slots of its sorted buffer
are the arms this loop keeps, and its weighted ``t_r``-prefix of the same
partition is this loop's reference set. Without masks the loop is the plain
one above, operation for operation.

**Margin-widened halving** (``widen=``, the quantized path). Each round
keeps its scheduled ``keep_r = s_{r+1}`` arms plus every finite arm within
``widen`` of the cut (the ``keep_r``-th smallest estimate), so how many
arms live is data-dependent. This loop keeps JAX's fixed buffers for it:
the stacked schedule with ``WIDEN_SLACK``-fold widths, a live count that
stays a device tensor, and dead positions at ``+inf``. Each round scores the
band's full buffer width against its exact ``t_r`` references (JAX's
weighted ``ref_cap`` prefix of the same draw), and ``margin_ok`` records
whether a band boundary ever cut the live set, as in JAX.

**Telemetry** (``telemetry=True``): each executed round adds one
:func:`repro_torch.obs.telemetry.round_stats` row of the masked estimates
its ordering sees, kept on the device and stacked once after the loop into
``HalvingOutcome.telemetry`` — extra outputs only, so the answer is the
same with it on or off. The plain loop's rounds have ``s_r`` entries where
JAX's scanned rounds have the band's width with dead slots at ``+inf``; the
statistics are over the finite entries, so the rows are the same.

The loop reads no device value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core.backend import DistanceBackend, get_backend
from repro_torch.engine import rng
from repro_torch.engine.estimators import ArmEstimator
from repro_torch.engine.schedule import Round, as_schedule, stop_round
from repro_torch.kernels import ops as kops
from repro_torch.obs import telemetry as obs_telemetry

BackendLike = Union[str, DistanceBackend, None]
OrderFn = Callable[[torch.Tensor], torch.Tensor]

# Buffer-width slack of margin-widened halving (``widen=``): every band and
# the output round get ``min(n, WIDEN_SLACK * scheduled size)`` slots, so a
# round may keep up to twice its scheduled count before a band boundary
# falsifies ``margin_ok``.
WIDEN_SLACK = 2


def sample_refs(key: rng.Key, n: int, t: int) -> torch.Tensor:
    """t reference indices, uniform without replacement (permutation prefix)."""
    if t >= n:
        return torch.arange(n, device=key.device)
    return rng.permutation(key, n)[:t]


def sample_refs_masked(key: rng.Key, n: int, t: int,
                       valid: torch.Tensor) -> torch.Tensor:
    """t reference indices, valid points first: a uniform permutation of
    ``[0, n)`` stably partitioned so the indices with ``valid`` true come
    first, still in random order. With every point valid this is
    :func:`sample_refs`."""
    if t >= n:
        return torch.arange(n, device=key.device)
    perm = rng.permutation(key, n)
    order = torch.argsort(torch.where(valid[perm], 0, 1), stable=True)
    return perm[order][:t]


def default_select(theta: torch.Tensor, keep: int) -> torch.Tensor:
    """Survivor selection of the distributed engines and Med-dit: the
    indices (int64) of the ``keep`` smallest estimates, ascending, ties to
    the smaller index — ``lax.top_k(-theta, keep)[1]``, order included.
    ``lax.top_k`` orders the IEEE total order (``-NaN < -inf < -0.0 < +0.0
    < +inf < +NaN``), which :func:`default_order` does not; a CUDA tensor
    takes the ``topk_smallest`` kernel, a CPU tensor a stable sort of the
    same integer keys."""
    n = theta.shape[0]
    if not 0 <= keep <= n:
        raise ValueError(f"default_select: keep must be in [0, {n}], got "
                         f"{keep}")
    if theta.is_cuda:
        if keep == 0:
            return theta.new_empty(0, dtype=torch.int64)
        return kops.kernel_topk_smallest(theta, keep=keep)
    return torch.argsort(kops.totalorder_keys(theta), stable=True)[:keep]


def default_order(theta: torch.Tensor) -> torch.Tensor:
    """Full stable ascending ordering of ``theta``, as ``jnp.argsort`` gives
    it: ``-0.0`` and ``+0.0`` tie (index order), NaNs of either sign last."""
    return torch.argsort(theta, stable=True)


def resolve_order_fn(backend: BackendLike) -> OrderFn:
    """The halving step's survivor ordering: the backend's fused
    ``survivor_order`` when it has one, else :func:`default_order`.

    The two agree except on signed zeros and NaNs, exactly as in the JAX
    package: ``jnp.argsort`` ties ``-0.0`` with ``+0.0`` and puts every NaN
    last, while the ``topk_smallest`` kernel orders the IEEE total order
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
    reference i — the estimator that scores a reference batch per arm, and
    optional ``(n,)`` bool masks of the arms that may win (``arm_mask``) and
    of the points that may serve as references (``ref_mask``); ``None``
    means all."""
    data: torch.Tensor
    estimator: ArmEstimator
    arm_mask: Optional[torch.Tensor] = None
    ref_mask: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class HalvingOutcome:
    """What one ``run_halving`` pass produced: ``winner`` (0-d int64 global
    index), ``winner_pos`` its position in ``survivors`` (the output round's
    global indices), ``theta`` the output round's estimates over
    ``survivors``, the estimator's ``aux`` of that round, and ``r_stop``.

    ``telemetry`` is ``None`` unless the run carried round telemetry, then
    the per-round dict of :mod:`repro_torch.obs.telemetry` (one row per
    executed round). Margin-widened runs also report ``live``, the 0-d
    count of live finalists at the front of ``survivors``, and
    ``margin_ok``, a 0-d bool that is true iff every widened survivor set
    fit its buffer all the way down. Plain runs leave both ``None``."""
    winner: torch.Tensor
    winner_pos: torch.Tensor
    survivors: torch.Tensor
    theta: torch.Tensor
    aux: Any
    r_stop: int
    telemetry: Any = None
    live: Optional[torch.Tensor] = None
    margin_ok: Optional[torch.Tensor] = None


def _score_round(problem: HalvingProblem, idx: torch.Tensor, sub: rng.Key,
                 t: int):
    """One round's estimates of the arms ``idx`` against ``t`` references
    drawn with ``sub`` (the valid-first draw under a ``ref_mask``), and the
    estimator's aux."""
    data, est, ref_mask = problem.data, problem.estimator, problem.ref_mask
    n = data.shape[0]
    if ref_mask is None:
        refs = sample_refs(sub, n, t)
        sums, aux = est.score(data[idx], data[refs], refs=refs)
        return _mean(sums, refs.shape[0]), aux
    refs = sample_refs_masked(sub, n, t, ref_mask)
    w = ref_mask[refs].float()
    sums, aux = est.score(data[idx], data[refs], refs=refs, ref_mask=w)
    return sums / torch.clamp_min(w.sum(), 1.0), aux


def _telemetry(rows: list, sched, r_stop: int):
    if rows is None:
        return None
    return obs_telemetry.assemble(sched[: r_stop + 1],
                                  obs_telemetry.stack(rows))


def _run_halving_widened(problem: HalvingProblem, sched, order_fn: OrderFn,
                         key: rng.Key, widen,
                         telemetry: bool = False) -> HalvingOutcome:
    """The ``widen`` body of :func:`run_halving` (see the module
    docstring): JAX's ``_run_halving_widened`` with its positional masks."""
    data, arm_mask = problem.data, problem.arm_mask
    n, dev = data.shape[0], data.device
    stk = sched.stacked(n, slack=WIDEN_SLACK)
    widen = torch.as_tensor(widen, dtype=torch.float32, device=dev)
    idx = torch.arange(n, device=dev)
    live = torch.full((), n, dtype=torch.int64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    rows = [] if telemetry else None
    for band in stk.bands:
        # The band boundary is the only place a margin-kept arm can drop.
        ok = ok & (live <= band.width)
        live = torch.clamp_max(live, band.width)
        idx = idx[:band.width]
        pos = torch.arange(band.width, device=dev)
        for i, t in enumerate(band.num_refs):
            keep = stk.sizes[band.start + i + 1]
            key, sub = rng.split(key)
            theta, _ = _score_round(problem, idx, sub, t)
            theta = torch.where(pos < live, theta, torch.inf)
            if arm_mask is not None:
                theta = torch.where(arm_mask[idx], theta, torch.inf)
            if telemetry:
                rows.append(obs_telemetry.round_stats(theta))
            order = order_fn(theta)
            # The cut is the keep-th smallest estimate; an +inf cut (fewer
            # than keep finite arms) keeps every finite arm.
            cut = theta[order[keep - 1]]
            inband = torch.isfinite(theta) & (theta <= cut + widen)
            live = torch.clamp(inband.sum(), keep, band.width)
            idx = idx[order]          # stable: live ascending, dead last

    out_cap = min(n, WIDEN_SLACK * stk.sizes[stk.r_stop])
    ok = ok & (live <= out_cap)
    live = torch.clamp_max(live, out_cap)
    survivors = idx[:out_cap]
    key, sub = rng.split(key)
    theta, aux = _score_round(problem, survivors, sub,
                              sched[stk.r_stop].num_refs)
    theta = torch.where(torch.arange(out_cap, device=dev) < live, theta,
                        torch.inf)
    if arm_mask is not None:
        theta = torch.where(arm_mask[survivors], theta, torch.inf)
    if telemetry:
        rows.append(obs_telemetry.round_stats(theta))
    pos = torch.argmin(theta)
    return HalvingOutcome(winner=survivors[pos], winner_pos=pos,
                          survivors=survivors, theta=theta, aux=aux,
                          r_stop=stk.r_stop,
                          telemetry=_telemetry(rows, sched, stk.r_stop),
                          live=live, margin_ok=ok)


def run_halving(problem: HalvingProblem, schedule: Sequence[Round],
                backend: BackendLike = None, *, key: rng.Key,
                survivor_order: Optional[OrderFn] = None,
                telemetry: bool = False,
                widen: Optional[torch.Tensor] = None) -> HalvingOutcome:
    """Run correlated sequential halving over ``schedule`` (non-empty:
    ``n == 1`` has an empty schedule and the caller answers arm 0).

    ``backend`` only resolves the survivor ordering (pass ``survivor_order``
    to skip the lookup); the distance path lives in ``problem.estimator``.
    ``widen`` (a 0-d tensor, e.g. :func:`repro_torch.quant.error.margin`)
    switches to margin-widened halving, which also reports ``live`` and
    ``margin_ok``; ``widen=None`` runs the plain loop. A zero ``widen`` is
    not the plain loop: it still keeps exact ties at the cut and uses the
    widened buffers. ``telemetry`` fills ``HalvingOutcome.telemetry`` (see
    the module docstring).
    """
    sched = as_schedule(schedule)
    if not len(sched):
        raise ValueError("empty schedule: n == 1 needs no halving — the "
                         "caller should short-circuit to arm 0")
    order_fn = survivor_order if survivor_order is not None \
        else resolve_order_fn(backend)
    if widen is not None:
        return _run_halving_widened(problem, sched, order_fn, key, widen,
                                    telemetry)
    data, arm_mask = problem.data, problem.arm_mask
    n = data.shape[0]
    r_stop = stop_round(list(sched))
    idx = torch.arange(n, device=data.device)
    rows = [] if telemetry else None
    for r in range(r_stop + 1):
        key, sub = rng.split(key)
        theta, aux = _score_round(problem, idx, sub, sched[r].num_refs)
        if arm_mask is not None:
            theta = torch.where(arm_mask[idx], theta, torch.inf)
        if telemetry:
            rows.append(obs_telemetry.round_stats(theta))
        if r < r_stop:
            idx = idx[order_fn(theta)][:sched[r + 1].survivors]

    pos = torch.argmin(theta)
    return HalvingOutcome(winner=idx[pos], winner_pos=pos, survivors=idx,
                          theta=theta, aux=aux, r_stop=r_stop,
                          telemetry=_telemetry(rows, sched, r_stop))
