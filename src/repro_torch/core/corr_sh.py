"""Correlated Sequential Halving (Algorithm 1 of the paper) — engine adapters,
the counterpart of ``repro/core/corr_sh.py``.

* :func:`correlated_sequential_halving` — the research-level function that
  returns the full :class:`CorrSHResult` (medoid, pulls, rounds, final
  estimates);
* ``_medoid_impl`` / ``_batch_impl`` / :func:`ragged_medoids` — what the
  facade dispatches: the memoized programs of
  :mod:`repro_torch.engine.programs` for this (bucket, budget, metric,
  backend);
* ``corr_sh_medoid`` / ``corr_sh_medoid_batch`` / ``corr_sh_medoid_ragged``
  — the deprecated pre-facade entry points, each warning once per process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.bucketing import DEFAULT_MIN_BUCKET, bucket_n
from repro_torch.deprecation import warn_once
from repro_torch.engine import instrument, programs, rng
from repro_torch.engine.estimators import medoid_centrality
from repro_torch.engine.halving import HalvingProblem, run_halving
from repro_torch.engine.schedule import Round, round_schedule


@dataclass
class CorrSHResult:
    medoid: torch.Tensor                # 0-d int64 index
    pulls: int                          # total distance computations (static)
    rounds: list[Round] = field(default_factory=list)
    theta_hat: Optional[torch.Tensor] = None   # output-round estimates


def correlated_sequential_halving(data: torch.Tensor, budget: int,
                                  key: rng.Key, metric: str = "l2",
                                  backend: str = "reference") -> CorrSHResult:
    """Run Algorithm 1 on ``data (n, d)`` with ``backend`` from
    :mod:`repro_torch.core.backend`."""
    n = int(data.shape[0])
    rounds = round_schedule(n, budget)
    if not rounds:  # n == 1
        return CorrSHResult(medoid=torch.zeros((), dtype=torch.int64,
                                               device=data.device), pulls=0)
    problem = HalvingProblem(data, medoid_centrality(backend, metric))
    out = run_halving(problem, rounds, backend, key=key)
    return CorrSHResult(
        medoid=out.winner,
        pulls=sum(x.pulls for x in rounds[: out.r_stop + 1]),
        rounds=rounds[: out.r_stop + 1],
        theta_hat=out.theta,
    )


def _medoid_impl(data: torch.Tensor, key: rng.Key, *, budget: int,
                 metric: str = "l2", backend: str = "reference",
                 telemetry: bool = False, precision: str = "fp32",
                 error_model: str = "probe"):
    """Single-query medoid: run the cached program for this
    (budget, metric, backend, telemetry, precision, error model). Returns a
    0-d int64 tensor, or ``(index, verified)`` when quantized, with the
    per-round telemetry dict last when ``telemetry``."""
    instrument.note_dispatch("medoid")
    fn = programs.medoid_program(budget=budget, metric=metric,
                                 backend=backend, telemetry=telemetry,
                                 precision=precision,
                                 error_model=error_model)
    return fn(data, key)


def _batch_impl(data: torch.Tensor, key: rng.Key, *, budget: int,
                metric: str = "l2", backend: str = "reference",
                telemetry: bool = False, precision: str = "fp32",
                error_model: str = "probe"):
    """Batched medoid: ``data (B, n, d) -> (B,)`` int64 indices (and
    ``(B,)`` verified when quantized, and ``(B, R)`` telemetry leaves with
    ``telemetry``), one shared schedule and an independent reference draw
    per query."""
    if data.ndim != 3:
        raise ValueError(f"expected (B, n, d) batch, got shape "
                         f"{tuple(data.shape)}")
    instrument.note_dispatch("batch")
    fn = programs.batch_program(budget=budget, metric=metric,
                                backend=backend, telemetry=telemetry,
                                precision=precision, error_model=error_model)
    return fn(data, key)


def ragged_compile_count() -> int:
    """Ragged programs built so far (the ``"ragged"`` trace odometer): at
    most one per bucket and configuration."""
    return instrument.trace_count("ragged")


def ragged_medoids(data: torch.Tensor, lengths, key: rng.Key, *,
                   budget: int, metric: str = "l2",
                   backend: str = "reference",
                   min_bucket: int = DEFAULT_MIN_BUCKET,
                   telemetry: bool = False, precision: str = "fp32",
                   error_model: str = "probe", live: int | None = None):
    """Ragged multi-query medoid: ``data (B, n_max, d)`` + per-query
    ``lengths (B,)`` -> ``(B,)`` int64 indices, each below its query's
    length (and ``(B,)`` verified when quantized, and ``(B, R)`` telemetry
    leaves with ``telemetry``). ``n_max`` is padded up
    to its power-of-two bucket and one schedule runs for ``(n_bucket,
    budget)``; padded arms are masked out of every round. A query with
    ``length == n_bucket`` gets ``find_medoid(data[i], split_many(key,
    B)[i])``'s answer. With ``live`` only the first ``live`` queries run
    (each under the key it has without ``live``); the rest are padding and
    answer 0 (verified, telemetry rows without an alive arm).

    Raises ``ValueError`` on a length below 1 or above ``n_max``, or a
    ``live`` outside ``1 .. B``, before any work."""
    if data.ndim != 3:
        raise ValueError(f"expected (B, n_max, d) batch, got shape "
                         f"{tuple(data.shape)}")
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    if tuple(lengths.shape) != (data.shape[0],):
        raise ValueError(f"lengths must be ({data.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    lens = lengths.cpu().numpy()
    if (lens < 1).any():
        raise ValueError("all-padding query rejected: every query needs "
                         f"length >= 1, got lengths={lens.tolist()}")
    if (lens > data.shape[1]).any():
        raise ValueError(f"length exceeds padded arm count {data.shape[1]}: "
                         f"lengths={lens.tolist()}")
    if live is not None and not 1 <= live <= data.shape[0]:
        raise ValueError(f"live={live} outside 1 .. {data.shape[0]}")
    n_bucket = bucket_n(data.shape[1], min_bucket)
    if data.shape[1] < n_bucket:
        data = torch.nn.functional.pad(data,
                                       (0, 0, 0, n_bucket - data.shape[1]))
    instrument.note_dispatch("ragged")
    fn = programs.ragged_program(n_bucket=n_bucket, budget=budget,
                                 metric=metric, backend=backend,
                                 telemetry=telemetry, precision=precision,
                                 error_model=error_model)
    return fn(data, lengths.to(data.device), key, live)


# ---------------------------------------------------------------------------
# deprecated pre-facade entry points (use repro_torch.api)
# ---------------------------------------------------------------------------

def corr_sh_medoid(data: torch.Tensor, key: rng.Key, *, budget: int,
                   metric: str = "l2",
                   backend: str = "reference") -> torch.Tensor:
    """Deprecated: use :func:`repro_torch.api.find_medoid`."""
    warn_once("repro_torch.core.corr_sh.corr_sh_medoid",
              "repro_torch.api.find_medoid")
    return _medoid_impl(data, key, budget=budget, metric=metric,
                        backend=backend)


def corr_sh_medoid_batch(data: torch.Tensor, key: rng.Key, *, budget: int,
                         metric: str = "l2",
                         backend: str = "reference") -> torch.Tensor:
    """Deprecated: use :func:`repro_torch.api.find_medoids_batch`."""
    warn_once("repro_torch.core.corr_sh.corr_sh_medoid_batch",
              "repro_torch.api.find_medoids_batch")
    return _batch_impl(data, key, budget=budget, metric=metric,
                       backend=backend)


def corr_sh_medoid_ragged(data: torch.Tensor, lengths, key: rng.Key, *,
                          budget: int, metric: str = "l2",
                          backend: str = "reference",
                          min_bucket: int = DEFAULT_MIN_BUCKET
                          ) -> torch.Tensor:
    """Deprecated: use :func:`repro_torch.api.find_medoids_ragged`."""
    warn_once("repro_torch.core.corr_sh.corr_sh_medoid_ragged",
              "repro_torch.api.find_medoids_ragged")
    return ragged_medoids(data, lengths, key, budget=budget, metric=metric,
                          backend=backend, min_bucket=min_bucket)
