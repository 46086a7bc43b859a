"""The public facade of the port, the counterpart of ``repro/api.py``::

    from repro_torch.api import (KMedoidsConfig, MedoidConfig, find_medoid,
                                 find_medoids_batch, find_medoids_ragged,
                                 kmedoids)

    res = find_medoid(data, key)                          # MedoidResult
    res = find_medoid(data, key, backend="pallas_fused", budget_per_arm=32)
    meds = find_medoids_batch(batch, key)                 # (B,) indices
    meds = find_medoids_ragged([q1, q2, q3], key=key)     # any sizes
    clust = kmedoids(data, k=8, key=key)                  # KMedoidsResult
    live = maintain_medoid(data)                          # MaintainedMedoid
    live.insert(x); live.delete(slot); live.query()       # mutable corpus

``data`` is a torch tensor (it keeps its device) or anything numpy takes (it
goes to CUDA); ``device=`` overrides both, and ``device="cpu"`` runs the
plain-torch path on the CPU. Without CUDA and without ``device`` a numpy
input raises. ``key`` is a :class:`repro_torch.engine.rng.Key`
(``rng.key(seed)``, or :func:`repro_torch.convert.key_from_jax_data` for a
JAX key); ``None`` means ``rng.key(config.seed)``.

Every ``algo`` is ported: ``"corr_sh"`` (the paper's Algorithm 1) for one
query, a batch and ragged queries, in fp32 and in the quantized precisions
(``precision="bf16"`` / ``"int8"``: quantized distances, margin-widened
halving, an exact fp32 check of the finalists, and a same-key fp32 re-run
when the margins overflowed), with per-round telemetry
(``telemetry=True``); the paper's baselines ``"meddit"`` (UCB, its steps a
CUDA graph on the card) and ``"rand"``; and ``"exact"``. Beside them:
bandit k-medoids, the live corpus (:func:`maintain_medoid`), and the
distributed engines behind ``find_medoid(..., mesh=)``::

    mesh = init_device_mesh("cuda", (world,))             # under torchrun
    res = find_medoid(data, key, mesh=mesh, distributed_impl="v2")
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import quant
from repro_torch.convert import data_from_numpy, resolve_device
from repro_torch.core.bucketing import (DEFAULT_MIN_BUCKET, bucket_n,
                                        pack_queries)
from repro_torch.core.corr_sh import _batch_impl, _medoid_impl, ragged_medoids
from repro_torch.core.exact import exact_medoid
from repro_torch.core.meddit import meddit_medoid
from repro_torch.core.rand import rand_medoid
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, stop_round
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs import telemetry_to_host

ALGOS = ("corr_sh", "meddit", "rand", "exact")

__all__ = ["ALGOS", "KMedoidsConfig", "MedoidConfig", "MedoidResult",
           "find_medoid", "find_medoids_batch", "find_medoids_ragged",
           "kmedoids", "maintain_medoid"]


@dataclass(frozen=True)
class MedoidConfig:
    """How a medoid query runs; the fields of ``repro.api.MedoidConfig``.
    ``budget = budget_per_arm * n`` (``n`` is the power-of-two bucket for
    ragged traffic).

    ``precision`` is ``"fp32"`` or a quantized ``"bf16"`` / ``"int8"``
    (:mod:`repro_torch.quant`): halving runs widened by the error model
    (``quant_error_model``: measured ``"probe"`` or worst-case
    ``"analytic"``), the finalists are checked in exact fp32, and a run
    whose widened margins overflowed falls back to a same-key fp32 re-run,
    so the answer is exact either way. ``corr_sh`` only.

    ``telemetry`` also returns the per-round telemetry of
    :mod:`repro_torch.obs.telemetry` (host numpy, one row per executed
    round) and, for one query, the instance's hardness; the answer is the
    same with it on or off. ``corr_sh`` only."""
    metric: str = "l2"
    backend: str = "reference"
    budget_per_arm: int = 24
    algo: str = "corr_sh"
    min_bucket: int = DEFAULT_MIN_BUCKET
    seed: int = 0          # key when the caller passes none
    telemetry: bool = False
    precision: str = "fp32"
    quant_error_model: str = "probe"


@dataclass(frozen=True)
class KMedoidsConfig:
    """How a k-medoids job runs (BUILD -> ragged per-cluster refinement ->
    bandit SWAP); the fields and defaults of ``repro.api.KMedoidsConfig``."""
    metric: str = "l2"
    backend: str = "reference"
    build_budget_per_arm: int = 16
    swap_budget_per_arm: int = 16
    refine_budget_per_arm: int = 20
    refine_sweeps: int = 1
    max_swap_rounds: int = 8
    min_bucket: int = DEFAULT_MIN_BUCKET
    seed: int = 0


@dataclass(frozen=True)
class MedoidResult:
    """One answered medoid query: the winning index plus exact (scheduled)
    pull accounting and the executed round plan (survivors, num_refs).

    ``precision`` echoes the config. ``verified`` is ``None`` for fp32; for
    a quantized run it is ``True`` when the widened margins held all the
    way down and ``False`` when they overflowed, and then ``medoid`` comes
    from the same-key fp32 re-run, whose pulls ``pulls`` includes (and
    whose telemetry replaces the quantized run's). ``hardness`` (telemetry
    runs only) holds the Theorem 2.1 quantities of
    :mod:`repro_torch.core.hardness`: the gap ``delta2``, ``sigma``, ``h2``
    and ``h2_tilde``."""
    medoid: int
    pulls: int
    n: int
    algo: str
    metric: str
    backend: str
    rounds: tuple = ()
    telemetry: Optional[dict] = None
    precision: str = "fp32"
    verified: Optional[bool] = None
    hardness: Optional[dict] = None


def _resolve(config, overrides, cls=MedoidConfig):
    cfg = config if config is not None else cls()
    if not isinstance(cfg, cls):
        raise TypeError(f"config must be a {cls.__name__}, got {type(cfg)!r}")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _tensor(data, dev: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=dev, dtype=torch.float32).contiguous()
    return data_from_numpy(data, dev)


def _key(key: Optional[rng.Key], seed: int, dev: torch.device) -> rng.Key:
    return rng.key(seed, dev) if key is None else key.to(dev)


def _split_telemetry(out, telemetry: bool):
    """A program's outputs as (the answer part, the telemetry dict or
    None): with telemetry the dict comes last."""
    if not telemetry:
        return out, None
    *rest, tel = out
    return (rest[0] if len(rest) == 1 else tuple(rest)), tel


def _check_ported(cfg: MedoidConfig) -> None:
    if cfg.algo not in ALGOS:
        raise ValueError(f"unknown algo {cfg.algo!r}; one of {ALGOS}")
    if cfg.precision != "fp32":
        quant.check_precision(cfg.precision)
        if cfg.algo != "corr_sh":
            raise ValueError("precision != 'fp32' requires algo='corr_sh' "
                             "(only the engine round loop has the "
                             "widened-margin + verification path)")
    if cfg.telemetry and cfg.algo != "corr_sh":
        raise ValueError("telemetry=True requires algo='corr_sh' (only the "
                         "engine round loop is instrumented)")


def find_medoid(data, key: Optional[rng.Key] = None, *,
                config: Optional[MedoidConfig] = None, device=None,
                mesh=None, distributed_impl: str = "v2",
                **overrides) -> MedoidResult:
    """Find the medoid of ``data (n, d)`` — the paper's correlated
    sequential halving on the configured backend (``algo="corr_sh"``), the
    Med-dit or RAND baseline (``"meddit"``, ``"rand"`` with
    ``budget_per_arm`` references), or the exact O(n^2) oracle
    (``"exact"``).

    ``mesh=`` (a :class:`torch.distributed.device_mesh.DeviceMesh`, every
    rank of it calling) runs the distributed engine instead
    (``distributed_impl="v2"`` communication-optimal, ``"v1"`` replicated):
    ``data`` is a DTensor row-sharded over every mesh dimension
    (:func:`repro_torch.core.distributed.shard_rows`) or a tensor that every
    rank holds whole; each rank scores its own rows and all return the same
    answer."""
    cfg = _resolve(config, overrides)
    _check_ported(cfg)
    if mesh is not None:
        return _find_medoid_distributed(data, key, cfg, mesh,
                                        distributed_impl)
    dev = resolve_device(device, data)
    data = _tensor(data, dev)
    if data.ndim != 2:
        raise ValueError(f"expected (n, d) data, got shape {tuple(data.shape)}")
    n = int(data.shape[0])
    key = _key(key, cfg.seed, dev)
    budget = cfg.budget_per_arm * n

    if cfg.algo == "exact":
        return MedoidResult(medoid=int(exact_medoid(data, cfg.metric)),
                            pulls=n * n, n=n, algo="exact",
                            metric=cfg.metric, backend=cfg.backend)
    if cfg.algo == "rand":
        refs = max(1, cfg.budget_per_arm)
        m = rand_medoid(data, key, num_refs=refs, metric=cfg.metric)
        return MedoidResult(medoid=int(m), pulls=n * refs, n=n, algo="rand",
                            metric=cfg.metric, backend=cfg.backend)
    if cfg.algo == "meddit":
        res = meddit_medoid(data, key, metric=cfg.metric)
        return MedoidResult(medoid=int(res.medoid), pulls=int(res.pulls),
                            n=n, algo="meddit", metric=cfg.metric,
                            backend=cfg.backend)
    quantized = cfg.precision != "fp32"
    if n == 1:
        return MedoidResult(medoid=0, pulls=0, n=1, algo="corr_sh",
                            metric=cfg.metric, backend=cfg.backend,
                            telemetry=telemetry_to_host(obs_telemetry.empty())
                            if cfg.telemetry else None,
                            precision=cfg.precision,
                            verified=True if quantized else None)
    out = _medoid_impl(data, key, budget=budget, metric=cfg.metric,
                       backend=cfg.backend, telemetry=cfg.telemetry,
                       precision=cfg.precision,
                       error_model=cfg.quant_error_model)
    rounds = round_schedule(n, budget)
    executed = rounds[: stop_round(rounds) + 1]
    pulls = sum(r.pulls for r in executed)
    verified = None
    out, tel = _split_telemetry(out, cfg.telemetry)
    if not quantized:
        medoid = int(out)
    else:
        out, ver = out
        verified = bool(ver)
        pulls += quant.verify_pulls(n, rounds)
        if verified:
            medoid = int(out)
        else:
            # The widened margins overflowed a buffer somewhere and the
            # quantized answer lost its certificate: re-run in fp32 with
            # the same key (the same draws, exact estimates, and the exact
            # telemetry in place of the quantized run's).
            fout = _medoid_impl(data, key, budget=budget, metric=cfg.metric,
                                backend=cfg.backend, telemetry=cfg.telemetry)
            if cfg.telemetry:
                fout, tel = fout
            medoid = int(fout)
            pulls += sum(r.pulls for r in executed)
    hardness = None
    if cfg.telemetry:
        from repro_torch.core.hardness import hardness_stats

        tel = telemetry_to_host(tel)
        hs = hardness_stats(data, metric=cfg.metric)
        hardness = {"delta2": float(hs.delta[1]), "sigma": float(hs.sigma),
                    "h2": float(hs.h2), "h2_tilde": float(hs.h2_tilde)}
    return MedoidResult(medoid=medoid, pulls=pulls, n=n, algo="corr_sh",
                        metric=cfg.metric, backend=cfg.backend,
                        rounds=tuple((r.survivors, r.num_refs)
                                     for r in executed),
                        telemetry=tel, precision=cfg.precision,
                        verified=verified, hardness=hardness)


DISTRIBUTED_IMPLS = ("v1", "v2")


def _find_medoid_distributed(data, key: Optional[rng.Key],
                             cfg: MedoidConfig, mesh,
                             impl: str) -> MedoidResult:
    """``find_medoid``'s ``mesh=`` branch (see there)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import distributed, distributed_v2

    if cfg.telemetry or cfg.precision != "fp32":
        raise ValueError("telemetry=True and precision != 'fp32' require "
                         "find_medoid without mesh= (only the engine round "
                         "loop is instrumented and widened)")
    if cfg.algo != "corr_sh":
        raise ValueError(f"mesh= requires algo='corr_sh', got {cfg.algo!r}")
    impls = {"v1": distributed.distributed_corr_sh,
             "v2": distributed_v2.distributed_corr_sh_v2}
    if impl not in impls:
        raise ValueError(f"distributed_impl must be one of "
                         f"{sorted(impls)}, got {impl!r}")
    lay = distributed.mesh_layout(mesh)
    if isinstance(data, DTensor):
        if data.device_mesh != mesh or any(
                p != Shard(0) for p in data.placements):
            raise ValueError("a DTensor must be row-sharded over every "
                             "dimension of mesh (make_row_sharding)")
        n = int(data.shape[0])
        local = data.to_local().float().contiguous()
    else:
        whole = _tensor(data, resolve_device(mesh.device_type, data))
        n = int(whole.shape[0])
        lo = lay.shard_id * (n // lay.shards)
        local = whole[lo:lo + n // lay.shards].contiguous()
    if local.ndim != 2:
        raise ValueError(f"expected (n, d) data, got {local.ndim} dims")
    if n % lay.shards or local.shape[0] * lay.shards != n:
        raise ValueError(f"n={n} must be divisible by device count "
                         f"{lay.shards}")
    want = "nccl" if local.is_cuda else "gloo"
    if want not in dist.get_backend(lay.group):
        raise ValueError(f"{local.device.type} rows need a {want} process "
                         f"group, got {dist.get_backend(lay.group)!r}")
    key = _key(key, cfg.seed, local.device)
    budget = cfg.budget_per_arm * n
    medoid = int(impls[impl](local, key, mesh, budget=budget,
                             metric=cfg.metric, backend=cfg.backend))
    rounds = round_schedule(n, budget)
    return MedoidResult(medoid=medoid, pulls=sum(r.pulls for r in rounds),
                        n=n, algo=f"corr_sh_distributed_{impl}",
                        metric=cfg.metric, backend=cfg.backend,
                        rounds=tuple((r.survivors, r.num_refs)
                                     for r in rounds))


def _with_fallback(out, cfg: MedoidConfig, fp32_run):
    """The medoids of a batch or ragged run: a quantized run's unverified
    queries take the answers of one same-key fp32 re-run of the batch
    (without telemetry: the batch keeps the quantized run's rows, as in
    JAX). With telemetry, ``(medoids, host telemetry)``."""
    out, tel = _split_telemetry(out, cfg.telemetry)
    if cfg.precision == "fp32":
        medoids = out
    else:
        medoids, verified = out
        if not bool(verified.all()):
            medoids = torch.where(verified, medoids, fp32_run())
    if tel is not None:
        return medoids, telemetry_to_host(tel)
    return medoids


def _check_multi(cfg: MedoidConfig, mode: str) -> None:
    if cfg.algo != "corr_sh":
        raise ValueError(f"{mode} mode requires algo='corr_sh', "
                         f"got {cfg.algo!r}")
    _check_ported(cfg)


def find_medoids_batch(data, key: Optional[rng.Key] = None, *,
                       config: Optional[MedoidConfig] = None, device=None,
                       **overrides) -> torch.Tensor:
    """Answer a ``(B, n, d)`` batch of independent medoid queries (one
    shared schedule, per-query reference draws). Returns the ``(B,)`` int64
    medoid indices on the data's device, or with ``telemetry=True``
    ``(indices, telemetry)`` with host ``(B, R)`` leaves."""
    cfg = _resolve(config, overrides)
    _check_multi(cfg, "batched")
    dev = resolve_device(device, data)
    data = _tensor(data, dev)
    n = int(data.shape[1]) if data.ndim == 3 else 0
    key = _key(key, cfg.seed, dev)
    kw = dict(budget=cfg.budget_per_arm * max(n, 1), metric=cfg.metric,
              backend=cfg.backend)
    out = _batch_impl(data, key, telemetry=cfg.telemetry,
                      precision=cfg.precision,
                      error_model=cfg.quant_error_model, **kw)
    return _with_fallback(out, cfg, lambda: _batch_impl(data, key, **kw))


def find_medoids_ragged(data, lengths=None, key: Optional[rng.Key] = None, *,
                        config: Optional[MedoidConfig] = None, device=None,
                        **overrides) -> torch.Tensor:
    """Answer mixed-size medoid queries: a list of ``(n_i, d)`` arrays
    (packed into power-of-two buckets here), or a pre-packed
    ``(B, n_max, d)`` array with per-query ``lengths (B,)``. The budget is
    ``budget_per_arm * n_bucket``; padding is masked inside every round,
    and a query that fills its bucket gets the single-query answer. Returns
    the ``(B,)`` int64 indices, each below its query's length, or with
    ``telemetry=True`` ``(indices, telemetry)`` with host ``(B, R)``
    leaves (the bucket's schedule columns)."""
    cfg = _resolve(config, overrides)
    _check_multi(cfg, "ragged")
    if isinstance(data, (list, tuple)):
        if lengths is not None:
            raise ValueError("pass lengths only with pre-packed array data")
        if not data:
            raise ValueError("pack_queries needs at least one query")
        dev = resolve_device(device, data[0])
        data, lengths = pack_queries([_tensor(a, dev) for a in data],
                                     min_bucket=cfg.min_bucket)
    elif lengths is None:
        raise ValueError("pre-packed array data needs explicit lengths")
    else:
        dev = resolve_device(device, data)
        data = _tensor(data, dev)
    n_bucket = bucket_n(int(data.shape[1]) if data.ndim == 3 else 1,
                        cfg.min_bucket)
    key = _key(key, cfg.seed, dev)
    kw = dict(budget=cfg.budget_per_arm * n_bucket, metric=cfg.metric,
              backend=cfg.backend, min_bucket=cfg.min_bucket)
    out = ragged_medoids(data, lengths, key, telemetry=cfg.telemetry,
                         precision=cfg.precision,
                         error_model=cfg.quant_error_model, **kw)
    return _with_fallback(out, cfg,
                          lambda: ragged_medoids(data, lengths, key, **kw))


def maintain_medoid(data=None, *, d: Optional[int] = None,
                    config: Optional[MedoidConfig] = None, device=None,
                    **overrides):
    """A live, incrementally maintained medoid over a mutable corpus: a
    :class:`repro_torch.serve.MaintainedMedoid`. ``insert(x)`` /
    ``delete(slot)`` cost one exact (1, cap) distance row each,
    ``query()`` serves the maintained answer of the current corpus version,
    and only a dethroned (or deleted) incumbent re-runs correlated SH,
    through the same ragged programs as :func:`find_medoids_ragged`, under
    the key ``fold_in(key(seed), version)``. Pass ``data (n, d)`` to
    bootstrap from a corpus, or ``d=`` alone to start empty. The store
    lives on ``device`` (CUDA unless ``device="cpu"``)."""
    from repro_torch.serve import CorpusStore, MaintainedMedoid

    cfg = _resolve(config, overrides)
    if cfg.algo != "corr_sh":
        raise ValueError(f"maintain_medoid requires algo='corr_sh', "
                         f"got {cfg.algo!r}")
    kw = dict(metric=cfg.metric, backend=cfg.backend,
              min_bucket=cfg.min_bucket, precision=cfg.precision,
              device=device)
    if data is not None:
        store = CorpusStore.from_points(data, **kw)
    elif d is not None:
        store = CorpusStore(d, **kw)
    else:
        raise ValueError("pass data (n, d) or d= to start an empty corpus")
    return MaintainedMedoid(store, budget_per_arm=cfg.budget_per_arm,
                            seed=cfg.seed)


def kmedoids(data, k: int, key: Optional[rng.Key] = None, *,
             config: Optional[KMedoidsConfig] = None, refiner=None,
             device=None, **overrides):
    """Bandit k-medoids (BUILD -> ragged refinement -> bandit SWAP) on the
    port's engine. Returns a :class:`repro_torch.cluster.KMedoidsResult`
    (point indices, labels, cost, scheduled pull counters). ``refiner``
    replaces the in-process refiner of the per-cluster subproblems (see
    :func:`repro_torch.cluster.service.kmedoids_via_service` for the
    medoid server's). A ``quant_*`` backend runs the phases on quantized
    distances, as in the JAX package; ``KMedoidsConfig`` has no
    ``precision`` or ``telemetry`` field, so either raises ``TypeError``
    like any unknown field, as in JAX."""
    from repro_torch.cluster.kmedoids import _kmedoids_impl

    cfg = _resolve(config, overrides, KMedoidsConfig)
    dev = resolve_device(device, data)
    return _kmedoids_impl(
        _tensor(data, dev), k, _key(key, cfg.seed, dev), metric=cfg.metric,
        backend=cfg.backend, build_budget_per_arm=cfg.build_budget_per_arm,
        swap_budget_per_arm=cfg.swap_budget_per_arm,
        refine_budget_per_arm=cfg.refine_budget_per_arm,
        refine_sweeps=cfg.refine_sweeps,
        max_swap_rounds=cfg.max_swap_rounds,
        min_bucket=cfg.min_bucket, refiner=refiner)
