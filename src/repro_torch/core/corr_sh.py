"""Correlated Sequential Halving (Algorithm 1 of the paper) — engine adapters,
the counterpart of ``repro/core/corr_sh.py`` for one query.

* :func:`correlated_sequential_halving` — the research-level function that
  returns the full :class:`CorrSHResult` (medoid, pulls, rounds, final
  estimates);
* ``_medoid_impl`` — what the facade's ``find_medoid`` dispatches: the
  memoized program of :mod:`repro_torch.engine.programs` for this
  (budget, metric, backend).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

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
                 metric: str = "l2",
                 backend: str = "reference") -> torch.Tensor:
    """Single-query medoid: run the cached program for this
    (budget, metric, backend). Returns a 0-d int64 tensor."""
    instrument.note_dispatch("medoid")
    fn = programs.medoid_program(budget=budget, metric=metric,
                                 backend=backend)
    return fn(data, key)
