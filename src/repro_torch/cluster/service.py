"""Clustering against the continuous-batching medoid service, the
counterpart of ``repro/cluster/service.py``. Every entry point runs on
``device`` (CUDA unless ``"cpu"`` is asked; without CUDA and without
``device`` it raises).

The refinement phase of :func:`repro_torch.api.kmedoids` is a
stream of independent single-medoid queries with heterogeneous sizes — which
is exactly the workload :class:`repro_torch.launch.serve_medoid.MedoidServer`
exists for. :class:`ServiceRefiner` adapts the refiner hook to submit each
cluster subproblem as a service request, so a clustering job shares the
server's bucketed dispatch, fixed-slot batching, and compile-odometer
guarantees with every other tenant's medoid traffic (and its per-request
accounting: the pulls reported are the server's scheduled pulls).

:class:`ClusterService` is the observability facade over a live server: a
tiny route table (``/stats``, ``/metrics``, ``/buckets``, and ``/stream``
when a :class:`ClusterStream` is attached) serving the scheduler
accounting, the JSON metrics snapshot, and the Prometheus text
exposition — the same payloads an HTTP front-end would mount, minus the
HTTP (the tests exercise the routes directly).

:class:`ClusterStream` is the streaming maintenance layer: fit once with
the full BUILD/refine/SWAP pipeline, then ``add(points)`` assigns arrivals
to their nearest medoid through the padded assignment
(:func:`repro_torch.cluster.kmedoids.assign_to_medoids`, one shape per arrival
bucket) and re-refines ONLY the clusters that received points
(one bounded ragged sweep through the same refiner hook the fit used),
instead of re-clustering from scratch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.cluster.kmedoids import (KMedoidsResult, _kmedoids_impl,
                                          assign_to_medoids,
                                          make_direct_refiner)
from repro_torch.convert import resolve_device
from repro_torch.core.bucketing import DEFAULT_MIN_BUCKET
from repro_torch.engine import rng


class ServiceRefiner:
    """Refiner hook that routes per-cluster medoid queries through a
    ``MedoidServer``. The server owns its key stream and budget policy
    (``budget_per_arm * n_bucket`` per request — the same shape as the
    direct refiner), so the ``key`` argument of the hook is unused."""

    def __init__(self, server):
        self.server = server

    def __call__(self, arrays: list, key: rng.Key) -> tuple[list, int]:
        rids = [self.server.submit(a) for a in arrays]
        self.server.drain()
        answered = [self.server.done[r] for r in rids]
        return ([int(r.medoid) for r in answered],
                sum(r.pulls for r in answered))


class ClusterStream:
    """Streaming cluster maintenance over a fitted k-medoids model.

    The constructor runs the full pipeline once (identical to
    :func:`repro_torch.api.kmedoids` — same key policy, same result). Each
    :meth:`add` then:

    1. assigns the arriving points to their nearest current medoid
       (padded to a power-of-two arrival bucket);
    2. re-refines ONLY the affected clusters — the ones that received
       points — with one bounded ragged sweep through the refiner hook
       (direct bucketed dispatches by default; pass
       ``refiner=ServiceRefiner(server)`` to ride a live MedoidServer);
    3. re-assigns the members of those clusters against the updated
       medoids (other clusters are untouched — bounded maintenance, not a
       global re-fit; :meth:`refit` re-runs the full pipeline when drift
       accumulates).

    Medoids are stable indices into the growing point store, and every
    distance evaluation is accounted in :attr:`assign_pulls` /
    :attr:`refine_pulls` on top of the initial fit's.
    """

    def __init__(self, data, k: int, key: rng.Key, *,
                 metric: str = "l2", backend: str = "reference",
                 refine_budget_per_arm: int = 20,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 refiner=None, device=None, **kwargs):
        self.device = resolve_device(device)
        data = _points(data, self.device)
        key = key.to(self.device)
        self.metric = metric
        self.backend = backend
        self.min_bucket = min_bucket
        self.k = k
        self._key = key
        self._refiner = refiner if refiner is not None else \
            make_direct_refiner(metric=metric, backend=backend,
                                budget_per_arm=refine_budget_per_arm,
                                min_bucket=min_bucket)
        self.fit = _kmedoids_impl(
            data, k, key, metric=metric, backend=backend,
            refine_budget_per_arm=refine_budget_per_arm,
            min_bucket=min_bucket, refiner=refiner, **kwargs)
        self.data = data.clone()
        self.labels = self.fit.labels.copy()
        self.medoids = list(self.fit.medoids)   # point indices, stable
        self.arrivals = 0
        self.batches = 0
        self.assign_pulls = 0
        self.refine_pulls = 0
        self.medoid_updates = 0

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @property
    def pulls(self) -> int:
        """Total distance evaluations: initial fit + streaming maintenance."""
        return self.fit.pulls + self.assign_pulls + self.refine_pulls

    def add(self, points) -> dict:
        """Ingest ``points (m, d)``; returns what the maintenance pass did:
        ``{"assigned": (m,) labels, "affected": [cluster slots],
        "medoid_updates": int, "pulls": int}``."""
        points = _points(points, self.device)
        if points.ndim != 2 or points.shape[1] != self.data.shape[1]:
            raise ValueError(f"expected (m, {self.data.shape[1]}) points, "
                             f"got shape {tuple(points.shape)}")
        pulls0 = self.assign_pulls + self.refine_pulls
        labels_new, _, p = assign_to_medoids(
            points, self.data[self.medoids], metric=self.metric,
            backend=self.backend, min_bucket=self.min_bucket)
        self.assign_pulls += p
        self.data = torch.cat([self.data, points])
        self.labels = np.concatenate([self.labels, labels_new])
        self.arrivals += int(points.shape[0])
        self.batches += 1

        affected = sorted(set(labels_new.tolist()))
        members = [(c, np.flatnonzero(self.labels == c)) for c in affected]
        members = [(c, mem) for c, mem in members if mem.size > 0]
        updates = 0
        if members:
            key = rng.fold_in(self._key, 3 + self.batches)
            locals_, p = self._refiner(
                [self.data[self._rows(mem)] for _, mem in members], key)
            self.refine_pulls += p
            for (c, mem), loc in zip(members, locals_):
                g = int(mem[int(loc)])
                if g != self.medoids[c]:
                    self.medoids[c] = g
                    updates += 1
            if updates:
                # bounded re-assignment: only the affected clusters'
                # members are re-priced against the updated medoids
                mem_all = np.concatenate([mem for _, mem in members])
                lab, _, p = assign_to_medoids(
                    self.data[self._rows(mem_all)], self.data[self.medoids],
                    metric=self.metric, backend=self.backend,
                    min_bucket=self.min_bucket)
                self.assign_pulls += p
                self.labels[mem_all] = lab
        self.medoid_updates += updates
        return {"assigned": labels_new, "affected": affected,
                "medoid_updates": updates,
                "pulls": self.assign_pulls + self.refine_pulls - pulls0}

    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(idx).to(self.device)

    def refit(self, **kwargs) -> KMedoidsResult:
        """Full re-clustering of the current store (fresh BUILD/refine/SWAP
        under a fresh fold of the stream key) — the escape hatch when
        bounded maintenance has drifted. Resets labels and medoids."""
        # fold constant 2 is reserved for SWAP inside the fit; batches fold
        # from 4 upward — 3 is the refit lane
        self._key = rng.fold_in(self._key, 3)
        self.fit = _kmedoids_impl(
            self.data, self.k, self._key, metric=self.metric,
            backend=self.backend, min_bucket=self.min_bucket,
            refiner=self._refiner, **kwargs)
        self.labels = self.fit.labels.copy()
        self.medoids = list(self.fit.medoids)
        return self.fit

    def cost(self) -> float:
        """Current summed distance to assigned medoids (host recompute —
        an observability number, not on the serving path)."""
        _, d1, _ = assign_to_medoids(
            self.data, self.data[self.medoids], metric=self.metric,
            backend=self.backend, min_bucket=self.min_bucket)
        return float(d1.sum())

    def stats(self) -> dict:
        return {
            "n": self.n, "k": self.k, "arrivals": self.arrivals,
            "batches": self.batches, "medoids": list(self.medoids),
            "medoid_updates": self.medoid_updates,
            "fit_pulls": self.fit.pulls,
            "assign_pulls": self.assign_pulls,
            "refine_pulls": self.refine_pulls,
            "total_pulls": self.pulls,
        }


class ClusterService:
    """Route-level view of a :class:`~repro_torch.launch.serve_medoid.MedoidServer`
    (observability endpoints a front-end would mount verbatim)::

        svc = ClusterService(server, stream=stream)
        svc.handle("/stats")     # scheduler accounting + metrics snapshot
        svc.handle("/metrics")   # Prometheus text exposition (str)
        svc.handle("/buckets")   # compiled-bucket inventory
        svc.handle("/stream")    # streaming-maintenance accounting

    ``routes()`` lists the table; unknown paths raise ``KeyError`` (a 404).
    The ``/stream`` route exists only when a :class:`ClusterStream` is
    attached (at construction or via :meth:`attach_stream`).
    """

    def __init__(self, server, stream: Optional[ClusterStream] = None):
        self.server = server
        self.stream = None
        self._routes = {"/stats": self.stats, "/metrics": self.metrics,
                        "/buckets": self.buckets}
        if stream is not None:
            self.attach_stream(stream)

    def attach_stream(self, stream: ClusterStream) -> None:
        """Mount a live :class:`ClusterStream` under ``/stream``."""
        self.stream = stream
        self._routes["/stream"] = self.stream_stats

    def routes(self) -> tuple:
        return tuple(sorted(self._routes))

    def handle(self, path: str):
        try:
            route = self._routes[path]
        except KeyError:
            raise KeyError(f"no route {path!r}; one of {self.routes()}"
                           ) from None
        return route()

    def stats(self) -> dict:
        """The ``/stats`` payload: the server's scheduler accounting plus
        the JSON metrics snapshot (one response answers both "is the queue
        healthy" and "what are the per-bucket latency/wait distributions")."""
        return {**self.server.stats(), "metrics": self.server.metrics()}

    def metrics(self) -> str:
        """The ``/metrics`` payload: Prometheus text exposition."""
        return self.server.exposition()

    def buckets(self) -> dict:
        """The ``/buckets`` payload: compiled-shape inventory."""
        return {"buckets": sorted(f"{nb}x{d}"
                                  for nb, d in self.server.buckets_seen),
                "recompiles": self.server.recompiles,
                "dispatches": self.server.dispatches}

    def stream_stats(self) -> dict:
        """The ``/stream`` payload: streaming-maintenance accounting."""
        if self.stream is None:
            raise KeyError("no ClusterStream attached")
        return self.stream.stats()


def _points(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)


def kmedoids_via_service(data, k: int, key: rng.Key, *,
                         server: Optional[object] = None,
                         metric: str = "l2", backend: str = "reference",
                         refine_budget_per_arm: int = 20, max_batch: int = 8,
                         device=None,
                         **kwargs) -> tuple[KMedoidsResult, object]:
    """Run bandit k-medoids with refinement served by a continuous-batching
    ``MedoidServer`` (a fresh one on ``device`` unless ``server`` is passed
    — pass a live server to co-schedule clustering with other medoid
    traffic; the job then runs on the server's device). Returns ``(result,
    server)`` so callers can read the server's dispatch stats."""
    from repro_torch.launch.serve_medoid import MedoidServer

    srv = server
    if srv is None:
        srv = MedoidServer(metric=metric, backend=backend,
                           budget_per_arm=refine_budget_per_arm,
                           max_batch=max_batch, device=device)
    data = _points(data, srv.device)
    result = _kmedoids_impl(data, k, key.to(srv.device), metric=metric,
                            backend=backend,
                            refine_budget_per_arm=refine_budget_per_arm,
                            refiner=ServiceRefiner(srv), **kwargs)
    return result, srv
