"""Per-round telemetry of the halving loop, the counterpart of
``repro/obs/telemetry.py``: the same fields, dtypes and meanings.

Schema — a dict of tensors, each with leading axis ``R`` = executed rounds
(``(B, R)`` from the batched and ragged programs):

======================  =======  ==============================================
key                     dtype    meaning (row r)
======================  =======  ==============================================
``survivors``           int32    scheduled arm count entering round r (s_r)
``num_refs``            int32    scheduled reference draws (t_r)
``pulls``               int32    scheduled distance evaluations (s_r * t_r)
``budget_frac``         float32  cumulative pulls through round r / total
                                 scheduled pulls (1.0 at the last row)
``alive``               int32    arms with finite estimates (< s_r under arm
                                 masking or ragged padding)
``theta_min``           float32  smallest estimate this round (the incumbent)
``theta_med``           float32  median estimate over the alive arms
``theta_max``           float32  largest finite estimate
``gap``                 float32  runner-up minus incumbent (+inf with one
                                 alive arm, NaN with none: +inf - +inf)
======================  =======  ==============================================

The schedule columns are constants of the static schedule, so their pulls
sum to the facade's scheduled pull count; the theta columns are measured on
the masked estimates the round's ordering sees. :func:`round_stats` reads
nothing back to the host: the loop keeps its rows on the device and stacks
them once after the last round.
"""
from __future__ import annotations

import torch

FIELDS = ("survivors", "num_refs", "pulls", "budget_frac", "alive",
          "theta_min", "theta_med", "theta_max", "gap")

_DTYPES = {"survivors": torch.int32, "num_refs": torch.int32,
           "pulls": torch.int32, "budget_frac": torch.float32,
           "alive": torch.int32, "theta_min": torch.float32,
           "theta_med": torch.float32, "theta_max": torch.float32,
           "gap": torch.float32}


def _at(st: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    # gather at a device index: indexing with a 0-d tensor would read it
    # back to the host
    return st.gather(0, i.reshape(1)).reshape(())


def round_stats(theta: torch.Tensor) -> dict:
    """Summary of one round's masked estimates (+inf at dead or ineligible
    arms), as ``jnp.sort`` orders them in the JAX package: ascending, NaN
    last, +inf before NaN. ``theta`` has at least two entries (every round
    of a non-empty schedule does)."""
    st = torch.sort(theta.float(), stable=True).values
    alive = torch.isfinite(st).sum().to(torch.int32)
    last = torch.clamp_min(alive - 1, 0).long()
    return {
        "alive": alive,
        "theta_min": st[0],
        "theta_med": _at(st, torch.div(last, 2, rounding_mode="floor")),
        "theta_max": _at(st, last),
        "gap": st[1] - st[0],
    }


def stack(dicts: list) -> dict:
    """Dicts of equal keys as one dict, each leaf stacked along a new
    leading axis: a loop's :func:`round_stats` rows as ``(R,)`` columns
    (once, after the loop), or per-query telemetry as ``(B, R)`` leaves."""
    return {k: torch.stack([t[k] for t in dicts]) for k in dicts[0]}


def schedule_constants(executed, device=None) -> dict:
    """The schedule columns for the executed rounds ``[0 .. r_stop]``:
    their ``pulls`` sum to the facade's scheduled pull count."""
    pulls = [r.pulls for r in executed]
    total = max(1, sum(pulls))
    cum, acc = [], 0
    for p in pulls:
        acc += p
        cum.append(acc / total)

    def col(vals, k):
        return torch.tensor(vals, dtype=_DTYPES[k], device=device)
    return {"survivors": col([r.survivors for r in executed], "survivors"),
            "num_refs": col([r.num_refs for r in executed], "num_refs"),
            "pulls": col(pulls, "pulls"),
            "budget_frac": col(cum, "budget_frac")}


def empty(device=None) -> dict:
    """The zero-round telemetry (n == 1: nothing to halve)."""
    return {k: torch.zeros((0,), dtype=_DTYPES[k], device=device)
            for k in FIELDS}


def assemble(executed, measured: dict) -> dict:
    """The schedule columns and the measured rows, ordered by
    :data:`FIELDS` (all leaves ``(R,)``, on the measured rows' device)."""
    dev = next(iter(measured.values())).device
    out = dict(schedule_constants(executed, dev))
    out.update(measured)
    return {k: out[k] for k in FIELDS}


def idle(tel: dict) -> dict:
    """``tel``'s rows for a slot that ran no query (a server's padding):
    the same schedule columns, and the measured columns of a round with no
    alive arm (``alive`` 0, theta +inf, ``gap`` NaN)."""
    out = {}
    for k, v in tel.items():
        if k == "alive":
            v = torch.zeros_like(v)
        elif k == "gap":
            v = torch.full_like(v, torch.nan)
        elif k.startswith("theta"):
            v = torch.full_like(v, torch.inf)
        out[k] = v
    return out


def broadcast(tel: dict, b: int) -> dict:
    """``tel`` repeated for ``b`` queries (leaves ``(b,) + shape``)."""
    return {k: v.expand((b,) + tuple(v.shape)).clone()
            for k, v in tel.items()}
