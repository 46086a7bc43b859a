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
``(winner, verified)``, ``verified`` the margin-capacity certificate. With
``telemetry=True`` the per-round telemetry dict of
:mod:`repro_torch.obs.telemetry` comes last (``(winner, tel)`` or
``(winner, verified, tel)``); the telemetry variant is its own table entry,
as in JAX.

**The trace odometer.** JAX traces a jitted program once per input
signature (shapes and dtypes). A table entry here notes one trace when it is
built and one more for each further signature it is called with, so the
``instrument`` trace counts (a server's ``recompiles``, "no retrace on
mutate") read as they do in JAX.

**Corpus programs** (the live corpus store, :mod:`repro_torch.serve`): the
bootstrap, insert, delete, grow and gather steps, each one table entry per
(kind, metric, backend) noting its traces under ``"corpus"``. They act on
the full power-of-two capacity bucket, so a mutation stream inside one
bucket builds nothing new. JAX donates the store's buffers to its insert
and delete programs; the port has no donation and updates them in place.

The JAX package's persistent XLA cache has no counterpart: the port
compiles no programs, and its CUDA kernels persist under
``build/kernels/<hash>/`` (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.engine import instrument, rng
from repro_torch.engine.estimators import medoid_centrality
from repro_torch.engine.halving import (HalvingProblem, resolve_order_fn,
                                        run_halving)
from repro_torch.engine.schedule import round_schedule
from repro_torch.obs import telemetry as obs_telemetry

_PROGRAMS: dict[tuple, Callable] = {}


class _Program:
    """One table entry: ``fn`` plus the input signatures it has seen (a
    new one after the first notes a trace, as a JAX retrace would)."""

    def __init__(self, fn: Callable, kind: str):
        self.fn, self.kind = fn, kind
        self._sigs: set = set()

    def __call__(self, *args):
        sig = tuple((tuple(a.shape), a.dtype) for a in args
                    if isinstance(a, torch.Tensor))
        if sig not in self._sigs:
            if self._sigs:
                instrument.note_trace(self.kind)
            self._sigs.add(sig)
        return self.fn(*args)


def _memo(key: tuple, build: Callable[[], Callable],
          kind: Optional[str] = None) -> Callable:
    fn = _PROGRAMS.get(key)
    if fn is None:
        kind = kind or key[0]
        instrument.note_trace(kind)
        fn = _PROGRAMS[key] = _Program(build(), kind)
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
            error_model: Optional[str], telemetry: bool) -> Callable:
    """``(x, rounds, key, arm_mask=None, ref_mask=None) -> winner`` (fp32)
    or ``(winner, verified)`` (quantized) for one query, with the
    telemetry dict appended when ``telemetry``."""
    estimator = medoid_centrality(backend, metric)
    order_fn = resolve_order_fn(backend)

    def solve(x, rounds, key, arm_mask=None, ref_mask=None):
        problem = HalvingProblem(x, estimator, arm_mask=arm_mask,
                                 ref_mask=ref_mask)
        if precision == "fp32":
            out = run_halving(problem, rounds, key=key,
                              survivor_order=order_fn, telemetry=telemetry)
            return (out.winner, out.telemetry) if telemetry else out.winner
        from repro_torch import quant

        widen = quant.margin(x, metric, precision, model=error_model)
        out = run_halving(problem, rounds, key=key, survivor_order=order_fn,
                          telemetry=telemetry, widen=widen)
        winner, verified = quant.exact_winner(problem, out, metric)
        return (winner, verified, out.telemetry) if telemetry \
            else (winner, verified)
    return solve


def _trivial(b: Optional[int], precision: str, telemetry: bool,
             device) -> object:
    """The answer without a schedule (n == 1): arm 0, verified when
    quantized, zero telemetry rows; ``b`` queries, or one when ``b`` is
    None."""
    shape = () if b is None else (b,)
    outs = (torch.zeros(shape, dtype=torch.int64, device=device),)
    if precision != "fp32":
        outs += (torch.ones(shape, dtype=torch.bool, device=device),)
    if telemetry:
        tel = obs_telemetry.empty(device)
        outs += (tel if b is None else obs_telemetry.broadcast(tel, b),)
    return outs[0] if len(outs) == 1 else outs


def _idle_slot(out, precision: str, telemetry: bool):
    """The outputs of a padding slot that ran no query, shaped like ``out``
    (a real slot's): arm 0, verified when quantized, and telemetry rows
    with the schedule columns and no alive arm."""
    parts = out if isinstance(out, tuple) else (out,)
    pad = (torch.zeros_like(parts[0]),)
    if precision != "fp32":
        pad += (torch.ones_like(parts[1]),)
    if telemetry:
        pad += (obs_telemetry.idle(parts[-1]),)
    return pad[0] if len(pad) == 1 else pad


def _stack(outs: list, precision: str, telemetry: bool):
    """Per-query outputs of ``solve`` as the batch's: ``(B,)`` winners
    (and verified), ``(B, R)`` telemetry leaves."""
    if precision == "fp32" and not telemetry:
        return torch.stack(outs)
    cols = list(zip(*outs))
    tels = cols.pop() if telemetry else None
    stacked = tuple(torch.stack(c) for c in cols)
    if telemetry:
        return stacked + (obs_telemetry.stack(tels),)
    return stacked


def medoid_program(*, budget: int, metric: str = "l2",
                   backend: str = "reference", telemetry: bool = False,
                   precision: str = "fp32",
                   error_model: str = "probe") -> Callable:
    """Single-query medoid: ``(data (n, d), key) -> 0-d int64 index`` on the
    data's device, or ``(index, verified)`` when quantized; the telemetry
    dict last with ``telemetry``."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err, telemetry)

        def impl(data: torch.Tensor, key: rng.Key):
            rounds = round_schedule(data.shape[0], budget)
            if not rounds:                        # n == 1
                return _trivial(None, precision, telemetry, data.device)
            return solve(data, rounds, key)
        return impl

    return _memo(("medoid", budget, metric, eff_backend, telemetry,
                  precision, eff_err), build)


def batch_program(*, budget: int, metric: str = "l2",
                  backend: str = "reference", telemetry: bool = False,
                  precision: str = "fp32",
                  error_model: str = "probe") -> Callable:
    """Batched medoid: ``(data (B, n, d), key) -> (B,)`` int64 indices (and
    ``(B,)`` verified when quantized, and ``(B, R)`` telemetry leaves with
    ``telemetry``), one shared schedule, per-query reference draws."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err, telemetry)

        def impl(data: torch.Tensor, key: rng.Key):
            if data.ndim != 3:
                raise ValueError(f"expected (B, n, d) batch, got shape "
                                 f"{tuple(data.shape)}")
            b, n, _ = data.shape
            rounds = round_schedule(n, budget)
            if not rounds or b == 0:              # n == 1
                return _trivial(b, precision, telemetry, data.device)
            return _stack([solve(x, rounds, k)
                           for x, k in zip(data, rng.split_many(key, b))],
                          precision, telemetry)
        return impl

    return _memo(("batch", budget, metric, eff_backend, telemetry,
                  precision, eff_err), build)


def ragged_program(*, n_bucket: int, budget: int, metric: str = "l2",
                   backend: str = "reference", telemetry: bool = False,
                   precision: str = "fp32",
                   error_model: str = "probe") -> Callable:
    """Ragged medoid: ``(data (B, n_bucket, d), lengths (B,), key) -> (B,)``
    int64 indices (and ``(B,)`` verified when quantized, and ``(B, R)``
    telemetry leaves with ``telemetry``, the bucket's schedule columns and
    each query's own measured rows). One validity mask
    per query serves as both ``arm_mask`` and ``ref_mask``: padded arms
    never win and never serve as references. A query that fills its bucket
    runs exactly the single-query loop. With ``live`` only the first
    ``live`` slots run (each under its key of ``split_many(key, B)``); the
    rest are padding and answer :func:`_idle_slot`'s outputs."""
    eff_backend, eff_err = _quant_config(precision, error_model, backend)

    def build():
        solve = _solver(metric, eff_backend, precision, eff_err, telemetry)

        def impl(data: torch.Tensor, lengths: torch.Tensor, key: rng.Key,
                 live: Optional[int] = None):
            b = data.shape[0]
            rounds = round_schedule(n_bucket, budget)
            if not rounds or b == 0:              # n_bucket == 1
                return _trivial(b, precision, telemetry, data.device)
            live = b if live is None else live
            valid = (torch.arange(n_bucket, device=data.device)[None, :]
                     < lengths.to(data.device)[:, None])
            outs = [solve(x, rounds, k, arm_mask=v, ref_mask=v)
                    for x, v, k in zip(data[:live], valid[:live],
                                       rng.split_many(key, b)[:live])]
            return _stack(outs + [_idle_slot(outs[0], precision, telemetry)]
                          * (b - live), precision, telemetry)
        return impl

    return _memo(("ragged", n_bucket, budget, metric, eff_backend, telemetry,
                  precision, eff_err), build)


# ------------------------------ corpus programs -----------------------------
# The live corpus store's steps (see the module docstring). ``cent`` holds
# the exact summed distance of every live slot to all live slots (+inf at
# dead slots); each mutation maintains it with the one (1, cap) distance row
# that prices the mutated point.

def _pairwise_of(backend: str, metric: str):
    from repro_torch.core.backend import get_backend

    return get_backend(backend).pairwise(metric)


def corpus_init_program(*, metric: str = "l2",
                        backend: str = "reference") -> Callable:
    """Centrality bootstrap: ``(buf (cap, d), alive (cap,)) -> (cent
    (cap,), winner)`` from the one ``(cap, cap)`` distance block."""
    def build():
        pw = _pairwise_of(backend, metric)

        def impl(buf: torch.Tensor, alive: torch.Tensor):
            dmat = pw(buf, buf)                               # (cap, cap)
            sums = dmat.masked_fill_(~alive[None, :], 0.0).sum(dim=1)
            del dmat
            cent = torch.where(alive, sums, torch.inf)
            return cent, torch.argmin(cent)
        return impl

    return _memo(("corpus_init", metric, backend), build, kind="corpus")


def corpus_insert_program(*, metric: str = "l2",
                          backend: str = "reference") -> Callable:
    """Insert, in place: ``(buf, cent, alive, x (d,), slot) -> winner``.
    The row ``d(x, buf)`` prices the new point and adds its distance to
    every live slot's centrality; ``winner`` is the exact argmin after the
    mutation (a 0-d device tensor)."""
    def build():
        pw = _pairwise_of(backend, metric)

        def impl(buf: torch.Tensor, cent: torch.Tensor, alive: torch.Tensor,
                 x: torch.Tensor, slot: int):
            buf[slot] = x
            row = pw(x[None, :], buf)[0]                      # (cap,)
            cent_x = torch.where(alive, row, 0.0).sum()
            cent.copy_(torch.where(alive, cent + row, torch.inf))
            cent[slot] = cent_x
            alive[slot] = True
            return torch.argmin(cent)
        return impl

    return _memo(("corpus_insert", metric, backend), build, kind="corpus")


def corpus_delete_program(*, metric: str = "l2",
                          backend: str = "reference") -> Callable:
    """Delete, in place: ``(buf, cent, alive, slot) -> winner``. The
    deleted point's row backs its distance out of every surviving
    centrality; its data stays in the (now dead) row."""
    def build():
        pw = _pairwise_of(backend, metric)

        def impl(buf: torch.Tensor, cent: torch.Tensor, alive: torch.Tensor,
                 slot: int):
            row = pw(buf[slot][None, :], buf)[0]              # (cap,)
            alive[slot] = False
            cent.copy_(torch.where(alive, cent - row, torch.inf))
            return torch.argmin(cent)
        return impl

    return _memo(("corpus_delete", metric, backend), build, kind="corpus")


def corpus_grow_program() -> Callable:
    """Capacity doubling: ``(buf (cap, d), cent, alive) -> the same triple
    at 2 * cap``, the new tail dead (+inf centrality)."""
    def build():
        def impl(buf: torch.Tensor, cent: torch.Tensor, alive: torch.Tensor):
            cap = buf.shape[0]
            return (torch.nn.functional.pad(buf, (0, 0, 0, cap)),
                    torch.nn.functional.pad(cent, (0, cap), value=torch.inf),
                    torch.nn.functional.pad(alive, (0, cap)))
        return impl

    return _memo(("corpus_grow",), build, kind="corpus")


def corpus_gather_program() -> Callable:
    """Snapshot gather: ``(buf (cap, d), idx (n_bucket,)) -> (n_bucket,
    d)``, the dense prefix form the ragged programs take."""
    def build():
        def impl(buf: torch.Tensor, idx: torch.Tensor):
            return buf.index_select(0, idx)
        return impl

    return _memo(("corpus_gather",), build, kind="corpus")

