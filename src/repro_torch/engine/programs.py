"""Memoized entry points: one program per static configuration.

The counterpart of ``repro/engine/programs.py``. JAX builds one jitted
program per ``(budget, metric, backend)`` and caches it in ``_memo``; the
eager port keeps the same table, keyed the same way, holding the callable
that runs the round loop. The table is the slot where a CUDA graph of the
whole loop goes in a later change: nothing else needs to move for that.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.engine import instrument, rng
from repro_torch.engine.estimators import medoid_centrality
from repro_torch.engine.halving import (HalvingProblem, resolve_order_fn,
                                        run_halving)
from repro_torch.engine.schedule import round_schedule

_PROGRAMS: dict[tuple, Callable] = {}


def _memo(key: tuple, build: Callable[[], Callable]) -> Callable:
    fn = _PROGRAMS.get(key)
    if fn is None:
        instrument.note_trace(key[0])
        fn = _PROGRAMS[key] = build()
    return fn


def medoid_program(*, budget: int, metric: str = "l2",
                   backend: str = "reference") -> Callable:
    """Single-query medoid: ``(data (n, d), key) -> 0-d int64 index`` on the
    data's device."""
    def build():
        estimator = medoid_centrality(backend, metric)
        order_fn = resolve_order_fn(backend)

        def impl(data: torch.Tensor, key: rng.Key) -> torch.Tensor:
            rounds = round_schedule(data.shape[0], budget)
            if not rounds:                        # n == 1
                return torch.zeros((), dtype=torch.int64, device=data.device)
            out = run_halving(HalvingProblem(data, estimator), rounds,
                              key=key, survivor_order=order_fn)
            return out.winner
        return impl

    return _memo(("medoid", budget, metric, backend), build)
