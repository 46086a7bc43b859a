"""Bandit k-medoids on the correlated-SH engine, the counterpart of
``repro/cluster/kmedoids.py``:

* **BUILD**: k correlated-SH argmin problems. Step 0 is the single-medoid
  problem and runs the same program as ``find_medoid``; steps t >= 1 run
  :func:`repro_torch.engine.halving.run_halving` with the ``build_delta``
  estimator (``sum_j min(d1_j, d(x_i, x_j))`` against the nearest-medoid
  cache ``d1``) under the key ``fold_in(key_build, t)``, chosen medoids
  masked out.
* **Ragged per-cluster refinement**: each cluster's medoid update is a
  single-medoid problem over its members, answered by bucketed
  :func:`repro_torch.core.corr_sh.ragged_medoids` dispatches. Only clusters
  whose membership changed since the previous sweep recompute.
* **SWAP**: FasterPAM-style bandit search with the ``swap_delta``
  estimator under ``fold_in(key_swap, round)``; the winning swap is checked
  against its exact delta (one n-vector of distances) before it is applied,
  and two consecutive rejections end the sweep.

JAX runs BUILD steps 1..k-1 and the SWAP sweep as two ``lax.scan``
programs; here each is a Python loop with the same key derivation. JAX's
SWAP rounds after the latch are masked no-ops, so this loop stops there and
reports the same ``executed`` count. Pull counters are scheduled counts,
equal to the JAX package's. ``bandit_kmedoids`` is the deprecated
pre-facade entry point (it warns once per process).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.bucketing import (DEFAULT_MIN_BUCKET, bucket_n,
                                        next_pow2, pack_queries, plan_buckets)
from repro_torch.core.corr_sh import _medoid_impl, ragged_medoids
from repro_torch.deprecation import warn_once
from repro_torch.engine import rng
from repro_torch.engine.estimators import build_delta, swap_delta
from repro_torch.engine.halving import (HalvingProblem, resolve_order_fn,
                                        run_halving)
from repro_torch.engine.schedule import round_schedule, schedule_pulls
from repro_torch.kernels.ops import totalorder_keys

# refiner hook: (cluster member tensors, key) -> (local medoid indices, pulls)
Refiner = Callable[[list, rng.Key], tuple[list, int]]


@dataclasses.dataclass
class KMedoidsResult:
    medoids: list[int]            # k point indices (cluster slot order)
    labels: np.ndarray            # (n,) cluster slot per point
    cost: float                   # sum of distances to assigned medoids
    pulls: int                    # total scheduled distance evaluations
    build_pulls: int
    assign_pulls: int
    refine_pulls: int
    swap_pulls: int
    swaps: int                    # accepted SWAP moves
    refine_updates: int           # per-cluster medoid changes during sweeps
    k: int = 0
    metric: str = "l2"
    backend: str = "reference"


def _row(data: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d device index) as a (1, d) block, without a host
    read."""
    return data.index_select(0, i.reshape(1))


def _top2_of(dmat: torch.Tensor):
    """(d1, d2, nearest) of the (n, k) cache: the two nearest medoids per
    point, ascending, ties to the smaller slot — ``lax.top_k(-dmat, 2)`` —
    by a stable sort in the IEEE total order; d2 = +inf when k == 1."""
    if dmat.shape[1] == 1:
        d1 = dmat[:, 0]
        return (d1, torch.full_like(d1, torch.inf),
                torch.zeros(d1.shape, dtype=torch.int64, device=d1.device))
    ids = torch.sort(totalorder_keys(dmat), dim=1, stable=True).indices[:, :2]
    vals = dmat.gather(1, ids)
    return vals[:, 0], vals[:, 1], ids[:, 0]


def _assign(data: torch.Tensor, meds: torch.Tensor, pw):
    """The (n, k) medoid-distance cache and its (d1, d2, nearest)."""
    dmat = pw(data, data[meds])
    return (dmat,) + _top2_of(dmat)


def _build(data: torch.Tensor, m0: torch.Tensor, key_build: rng.Key, *,
           k: int, budget: int, metric: str, backend: str) -> torch.Tensor:
    """BUILD steps 1..k-1 after the step-0 medoid ``m0``; returns the (k,)
    medoids. Winners stay on the device."""
    n = data.shape[0]
    pw = get_backend(backend).pairwise(metric)
    order_fn = resolve_order_fn(backend)
    rounds = round_schedule(n, budget)
    d1 = torch.minimum(torch.full((n,), torch.inf, device=data.device),
                       pw(_row(data, m0), data)[0])
    chosen = torch.zeros(n, dtype=torch.bool, device=data.device)
    chosen[m0.reshape(1)] = True
    meds = [m0]
    for t in range(1, k):
        problem = HalvingProblem(data, build_delta(backend, metric, d1=d1),
                                 arm_mask=~chosen)
        m = run_halving(problem, rounds, key=rng.fold_in(key_build, t),
                        survivor_order=order_fn).winner
        d1 = torch.minimum(d1, pw(_row(data, m), data)[0])
        chosen[m.reshape(1)] = True
        meds.append(m)
    return torch.stack(meds)


def _swap_sweep(data: torch.Tensor, dmat: torch.Tensor, meds: torch.Tensor,
                key_swap: rng.Key, *, max_rounds: int, k: int, budget: int,
                metric: str, backend: str):
    """The SWAP phase. Round ``rnd`` runs the bandit argmin under
    ``fold_in(key_swap, rnd)``, takes the winner's slot as the first
    minimum of its ``(k,)`` delta row, and checks the swap's exact delta
    against ``-1e-6 * max(1, sum(d1) / n)``. An accepted swap rewrites one
    cache column; two rejections in a row end the sweep (JAX's later rounds
    are masked no-ops). Each round reads its accept bit on the host.
    Returns ``(meds, nearest, cost (0-d), swaps, executed)``; updates
    ``dmat`` and ``meds`` in place."""
    n = data.shape[0]
    pw = get_backend(backend).pairwise(metric)
    order_fn = resolve_order_fn(backend)
    rounds = round_schedule(n, budget)
    swaps = rejections = executed = 0
    for rnd in range(max_rounds):
        d1, d2, nearest = _top2_of(dmat)
        chosen = torch.zeros(n, dtype=torch.bool, device=data.device)
        chosen[meds] = True
        problem = HalvingProblem(
            data, swap_delta(backend, metric, d1=d1, d2=d2, nearest=nearest,
                             k=k), arm_mask=~chosen)
        out = run_halving(problem, rounds, key=rng.fold_in(key_swap, rnd),
                          survivor_order=order_fn)
        cand = out.winner
        slot = torch.argmin(_row(out.aux, out.winner_pos)[0])
        dc = pw(_row(data, cand), data)[0]
        mine = nearest == slot
        delta = torch.where(mine, torch.minimum(dc, d2) - d1,
                            torch.clamp_max(dc - d1, 0.0)).sum()
        tol = -1e-6 * torch.clamp_min(d1.sum() / d1.new_full((), n), 1.0)
        accept, reject = torch.stack([delta < tol, delta >= tol]).tolist()
        executed += 1
        if accept:
            meds[slot.reshape(1)] = cand
            dmat.index_copy_(1, slot.reshape(1), dc[:, None])
            swaps += 1
        rejections = 0 if accept else rejections + reject
        if rejections >= 2:
            break
    d1, _, nearest = _top2_of(dmat)
    return meds, nearest, d1.sum(), swaps, executed


def make_direct_refiner(*, metric: str, backend: str, budget_per_arm: int,
                        min_bucket: int = DEFAULT_MIN_BUCKET) -> Refiner:
    """The in-process refiner: group the cluster subproblems into
    power-of-two buckets and answer each bucket with one ``ragged_medoids``
    dispatch under ``fold_in(key, n_bucket)``, its slots padded to a power
    of two with dummy length-1 queries (which run, and count, like any
    other)."""
    def refine(arrays: list, key: rng.Key) -> tuple[list, int]:
        plan = plan_buckets([a.shape[0] for a in arrays], min_bucket)
        locals_: list = [None] * len(arrays)
        pulls = 0
        for nb, idxs in plan.items():
            slots = next_pow2(len(idxs))
            packed, lens = pack_queries([arrays[i] for i in idxs], min_bucket,
                                        pad_batch_to=slots)
            meds = ragged_medoids(packed, lens, rng.fold_in(key, nb),
                                  budget=budget_per_arm * nb, metric=metric,
                                  backend=backend, min_bucket=min_bucket)
            pulls += schedule_pulls(nb, budget_per_arm * nb) * slots
            host = meds.tolist()
            for s, i in enumerate(idxs):
                locals_[i] = int(host[s])
        return locals_, pulls
    return refine


def assign_to_medoids(points: torch.Tensor, med_rows: torch.Tensor, *,
                      metric: str = "l2", backend: str = "reference",
                      min_bucket: int = DEFAULT_MIN_BUCKET):
    """Nearest medoid of each arriving point, the points zero-padded to a
    power-of-two arrival bucket (as the JAX package pads them for one
    compiled program per bucket). Returns ``(labels (m,) np.int32,
    d1 (m,) np.float32, pulls)``; the pulls charge the padded rows too."""
    if points.ndim != 2 or med_rows.ndim != 2:
        raise ValueError(f"expected (m, d) points and (k, d) medoid rows, "
                         f"got {tuple(points.shape)} and "
                         f"{tuple(med_rows.shape)}")
    m = int(points.shape[0])
    mb = bucket_n(max(1, m), min_bucket)
    padded = torch.zeros((mb, points.shape[1]), dtype=torch.float32,
                         device=points.device)
    padded[:m] = points
    dmat = get_backend(backend).pairwise(metric)(padded, med_rows.float())
    labels = torch.argmin(dmat, dim=1)[:m].to(torch.int32)
    d1 = torch.min(dmat, dim=1).values[:m]
    return (labels.cpu().numpy(), d1.cpu().numpy(),
            mb * int(med_rows.shape[0]))


def _kmedoids_impl(data: torch.Tensor, k: int, key: rng.Key, *,
                   metric: str = "l2", backend: str = "reference",
                   build_budget_per_arm: int = 16,
                   swap_budget_per_arm: int = 16,
                   refine_budget_per_arm: int = 20,
                   refine_sweeps: int = 1, max_swap_rounds: int = 8,
                   min_bucket: int = DEFAULT_MIN_BUCKET,
                   refiner: Optional[Refiner] = None) -> KMedoidsResult:
    """BUILD -> ragged per-cluster refinement -> bandit SWAP on ``data
    (n, d)`` (a float32 tensor on its device). Phase keys are
    ``fold_in(key, 0/1/2)`` for BUILD / refine / SWAP."""
    if data.ndim != 2:
        raise ValueError(f"expected (n, d) data, got shape "
                         f"{tuple(data.shape)}")
    n = int(data.shape[0])
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    pw = get_backend(backend).pairwise(metric)     # fail before any work
    if refiner is None:
        refiner = make_direct_refiner(metric=metric, backend=backend,
                                      budget_per_arm=refine_budget_per_arm,
                                      min_bucket=min_bucket)
    build_budget = build_budget_per_arm * n
    swap_budget = swap_budget_per_arm * n

    # BUILD: step 0 is find_medoid's program, steps 1..k-1 the loop above.
    key_build = rng.fold_in(key, 0)
    m0 = _medoid_impl(data, rng.fold_in(key_build, 0), budget=build_budget,
                      metric=metric, backend=backend)
    if k > 1:
        meds_dev = _build(data, m0, key_build, k=k, budget=build_budget,
                          metric=metric, backend=backend)
    else:
        meds_dev = m0.reshape(1)
    meds: list[int] = meds_dev.tolist()
    build_pulls = k * (schedule_pulls(n, build_budget) + n)

    dmat, d1, d2, nearest = _assign(data, meds_dev, pw)
    assign_pulls = n * k

    # Refinement: the labels are read on the host to split the clusters.
    key_refine = rng.fold_in(key, 1)
    refine_pulls = refine_updates = 0
    changed = set(range(k))
    for sweep in range(refine_sweeps):
        if not changed:
            break
        labels_np = nearest.cpu().numpy()
        which = [(c, np.flatnonzero(labels_np == c)) for c in sorted(changed)]
        which = [(c, mem) for c, mem in which if mem.size > 0]
        if not which:
            break
        locals_, p = refiner(
            [data[torch.from_numpy(mem).to(data.device)] for _, mem in which],
            rng.fold_in(key_refine, sweep))
        refine_pulls += p
        updates = 0
        for (c, mem), loc in zip(which, locals_):
            g = int(mem[int(loc)])
            if g != meds[c]:
                meds[c] = g
                updates += 1
        refine_updates += updates
        if updates == 0:
            break
        dmat, d1, d2, nearest = _assign(
            data, torch.tensor(meds, device=data.device), pw)
        assign_pulls += n * k
        new_np = nearest.cpu().numpy()
        moved = new_np != labels_np
        changed = (set(new_np[moved].tolist())
                   | set(labels_np[moved].tolist())) if moved.any() else set()

    # SWAP (k == n leaves no swap-in candidate; that covers n == 1 too).
    key_swap = rng.fold_in(key, 2)
    swap_pulls = swaps = 0
    if k < n and max_swap_rounds > 0:
        meds_dev, nearest, cost_dev, swaps, executed = _swap_sweep(
            data, dmat, torch.tensor(meds, device=data.device), key_swap,
            max_rounds=max_swap_rounds, k=k, budget=swap_budget,
            metric=metric, backend=backend)
        meds = meds_dev.tolist()
        swap_pulls = executed * (schedule_pulls(n, swap_budget) + n)
        cost = float(cost_dev)
    else:
        cost = float(d1.sum())
    labels = nearest.cpu().numpy().astype(np.int32)

    pulls = build_pulls + assign_pulls + refine_pulls + swap_pulls
    return KMedoidsResult(
        medoids=meds, labels=labels, cost=cost,
        pulls=pulls, build_pulls=build_pulls, assign_pulls=assign_pulls,
        refine_pulls=refine_pulls, swap_pulls=swap_pulls, swaps=swaps,
        refine_updates=refine_updates, k=k, metric=metric, backend=backend)


def bandit_kmedoids(data: torch.Tensor, k: int, key: rng.Key,
                    **kwargs) -> KMedoidsResult:
    """Deprecated: use :func:`repro_torch.api.kmedoids` (the same pipeline,
    config-driven). Signature-compatible with the pre-facade entry point:
    ``data`` a float32 tensor on its device, the keywords of
    ``_kmedoids_impl``."""
    warn_once("repro_torch.cluster.kmedoids.bandit_kmedoids",
              "repro_torch.api.kmedoids")
    return _kmedoids_impl(data, k, key, **kwargs)
