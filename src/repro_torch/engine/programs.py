"""Memoized entry points: one program per static configuration.

The counterpart of ``repro/engine/programs.py``. JAX builds one jitted
program per ``(budget, metric, backend, precision, error model)`` (and per
bucket for the ragged engine) and caches it in ``_memo``; the eager port
keeps the same table, keyed the same way, holding the callable that runs
the round loop. JAX's ``vmap`` over a batch is a loop over the queries here,
each under its own key of ``split_many(key, B)``. The table is the slot
where a CUDA graph of the whole loop goes in a later change: nothing else
needs to move for that.

With ``precision`` "bf16" or "int8" a program runs the quantized pipeline:
the distances of the quantized backend, halving widened by the error
model's margin (:func:`repro_torch.quant.margin`), and the exact fp32 check
of the finalists (:func:`repro_torch.quant.exact_winner`); it returns
``(winner, verified)``, ``verified`` the margin-capacity certificate.
"""
from __future__ import annotations

from typing import Callable, Optional

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


def _quant_config(precision: str, error_model: str,
                  backend: str) -> tuple[str, Optional[str]]:
    """(effective backend, error model) for a precision. fp32 folds the
    error model to None, so every fp32 caller shares one program; otherwise
    the quantized backend replaces the caller's (a fused base keeps a fused
    quantized path). Imports :mod:`repro_torch.quant` lazily: the engine
    sits below it."""
    if precision == "fp32":
        return backend, None
    from repro_torch import quant

    return quant.backend_for(precision, base=backend), error_model


def _solver(metric: str, backend: str, precision: str,
            error_model: Optional[str]) -> Callable:
    """``(x, rounds, key, arm_mask=None, ref_mask=None) -> winner`` (fp32)
    or ``(winner, verified)`` (quantized) for one query."""
    estimator = medoid_centrality(backend, metric)
    order_fn = resolve_order_fn(backend)

    def solve(x, rounds, key, arm_mask=None, ref_mask=None):
        problem = HalvingProblem(x, estimator, arm_mask=arm_mask,
                                 ref_mask=ref_mask)
        if precision == "fp32":
            return run_halving(problem, rounds, key=key,
                               survivor_order=order_fn).winner
        from repro_torch import quant

        widen = quant.margin(x, metric, precision, model=error_model)
        out = run_halving(problem, rounds, key=key, survivor_order=order_fn,
                          widen=widen)
        return quant.exact_winner(problem, out, metric)
    return solve


def _trivial(b: Optional[int], precision: str, device) -> object:
    """The answer without a schedule (n == 1): arm 0, verified when
    quantized; ``b`` queries, or one when ``b`` is None."""
    shape = () if b is None else (b,)
    winners = torch.zeros(shape, dtype=torch.int64, device=device)
    if precision == "fp32":
        return winners
    return winners, torch.ones(shape, dtype=torch.bool, device=device)


def _stack(outs: list, precision: str):
    if precision == "fp32":
        return torch.stack(outs)
    return (torch.stack([w for w, _ in outs]),
            torch.stack([v for _, v in outs]))


def medoid_program(*, budget: int, metric: str = "l2",
                   backend: str = "reference", precision: str = "fp32",
                   error_model: str = "probe") -> Callable:
    """Single-query medoid: ``(data (n, d), key) -> 0-d int64 index`` on the
    data's device, or ``(index, verified)`` when quantized."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err)

        def impl(data: torch.Tensor, key: rng.Key):
            rounds = round_schedule(data.shape[0], budget)
            if not rounds:                        # n == 1
                return _trivial(None, precision, data.device)
            return solve(data, rounds, key)
        return impl

    return _memo(("medoid", budget, metric, eff_backend, precision, eff_err),
                 build)


def batch_program(*, budget: int, metric: str = "l2",
                  backend: str = "reference", precision: str = "fp32",
                  error_model: str = "probe") -> Callable:
    """Batched medoid: ``(data (B, n, d), key) -> (B,)`` int64 indices (and
    ``(B,)`` verified when quantized), one shared schedule, per-query
    reference draws."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err)

        def impl(data: torch.Tensor, key: rng.Key):
            if data.ndim != 3:
                raise ValueError(f"expected (B, n, d) batch, got shape "
                                 f"{tuple(data.shape)}")
            b, n, _ = data.shape
            rounds = round_schedule(n, budget)
            if not rounds or b == 0:              # n == 1
                return _trivial(b, precision, data.device)
            return _stack([solve(x, rounds, k)
                           for x, k in zip(data, rng.split_many(key, b))],
                          precision)
        return impl

    return _memo(("batch", budget, metric, eff_backend, precision, eff_err),
                 build)


def ragged_program(*, n_bucket: int, budget: int, metric: str = "l2",
                   backend: str = "reference", precision: str = "fp32",
                   error_model: str = "probe") -> Callable:
    """Ragged medoid: ``(data (B, n_bucket, d), lengths (B,), key) -> (B,)``
    int64 indices (and ``(B,)`` verified when quantized). One validity mask
    per query serves as both ``arm_mask`` and ``ref_mask``: padded arms
    never win and never serve as references. A query that fills its bucket
    runs exactly the single-query loop."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err)

        def impl(data: torch.Tensor, lengths: torch.Tensor, key: rng.Key):
            b = data.shape[0]
            rounds = round_schedule(n_bucket, budget)
            if not rounds or b == 0:              # n_bucket == 1
                return _trivial(b, precision, data.device)
            valid = (torch.arange(n_bucket, device=data.device)[None, :]
                     < lengths.to(data.device)[:, None])
            return _stack([solve(x, rounds, k, arm_mask=v, ref_mask=v)
                           for x, v, k in zip(data, valid,
                                              rng.split_many(key, b))],
                          precision)
        return impl

    return _memo(("ragged", n_bucket, budget, metric, eff_backend, precision,
                  eff_err), build)
