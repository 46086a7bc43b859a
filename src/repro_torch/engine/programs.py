"""Memoized entry points: one program per static configuration.

The counterpart of ``repro/engine/programs.py``. JAX builds one jitted
program per ``(budget, metric, backend)`` (and per bucket for the ragged
engine) and caches it in ``_memo``; the eager port keeps the same table,
keyed the same way, holding the callable that runs the round loop. JAX's
``vmap`` over a batch is a loop over the queries here, each under its own
key of ``split_many(key, B)``. The table is the slot where a CUDA graph of
the whole loop goes in a later change: nothing else needs to move for that.
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


def batch_program(*, budget: int, metric: str = "l2",
                  backend: str = "reference") -> Callable:
    """Batched medoid: ``(data (B, n, d), key) -> (B,)`` int64 indices, one
    shared schedule, per-query reference draws."""
    def build():
        estimator = medoid_centrality(backend, metric)
        order_fn = resolve_order_fn(backend)

        def impl(data: torch.Tensor, key: rng.Key) -> torch.Tensor:
            if data.ndim != 3:
                raise ValueError(f"expected (B, n, d) batch, got shape "
                                 f"{tuple(data.shape)}")
            b, n, _ = data.shape
            rounds = round_schedule(n, budget)
            if not rounds or b == 0:              # n == 1
                return torch.zeros(b, dtype=torch.int64, device=data.device)
            winners = [run_halving(HalvingProblem(x, estimator), rounds,
                                   key=k, survivor_order=order_fn).winner
                       for x, k in zip(data, rng.split_many(key, b))]
            return torch.stack(winners)
        return impl

    return _memo(("batch", budget, metric, backend), build)


def ragged_program(*, n_bucket: int, budget: int, metric: str = "l2",
                   backend: str = "reference") -> Callable:
    """Ragged medoid: ``(data (B, n_bucket, d), lengths (B,), key) -> (B,)``
    int64 indices. One validity mask per query serves as both ``arm_mask``
    and ``ref_mask``: padded arms never win and never serve as references.
    A query that fills its bucket runs exactly the single-query loop."""
    def build():
        estimator = medoid_centrality(backend, metric)
        order_fn = resolve_order_fn(backend)

        def impl(data: torch.Tensor, lengths: torch.Tensor,
                 key: rng.Key) -> torch.Tensor:
            b = data.shape[0]
            rounds = round_schedule(n_bucket, budget)
            if not rounds or b == 0:              # n_bucket == 1
                return torch.zeros(b, dtype=torch.int64, device=data.device)
            valid = (torch.arange(n_bucket, device=data.device)[None, :]
                     < lengths.to(data.device)[:, None])
            winners = [run_halving(HalvingProblem(x, estimator, arm_mask=v,
                                                  ref_mask=v),
                                   rounds, key=k,
                                   survivor_order=order_fn).winner
                       for x, v, k in zip(data, valid,
                                          rng.split_many(key, b))]
            return torch.stack(winners)
        return impl

    return _memo(("ragged", n_bucket, budget, metric, backend), build)
