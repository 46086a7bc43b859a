"""Exact fp32 verification of a quantized halving run.

The counterpart of ``repro/quant/verify.py``. A widened run ends with up to
``WIDEN_SLACK * s_stop`` finalists, a live count on the device, and a
``margin_ok`` flag that says whether every margin-widened survivor set fit
its buffer all the way down (``run_halving(widen=...)``). This module scores
every live finalist against all (valid) references in exact fp32 with the
reference distances, one n-vector each, and returns the exact argmin: the
fp32 medoid of the finalist set. When ``margin_ok`` held, quantization never
evicted an arm that a same-draw fp32 round would have kept, which is the
``verified`` certificate the facade reports. No kernel runs here.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances
from repro_torch.engine.halving import (WIDEN_SLACK, HalvingOutcome,
                                        HalvingProblem)
from repro_torch.engine.schedule import as_schedule


def verify_width(n: int, rounds) -> int:
    """Width of the widened output round's survivor buffer (the finalists
    the check scores): ``min(n, WIDEN_SLACK * s_stop)``."""
    stk = as_schedule(rounds).stacked(n)
    return min(int(n), WIDEN_SLACK * stk.sizes[stk.r_stop])


def verify_pulls(n: int, rounds) -> int:
    """Distance evaluations the check spends: one n-vector per finalist."""
    return verify_width(n, rounds) * int(n)


def exact_winner(problem: HalvingProblem, out: HalvingOutcome,
                 metric: str):
    """``(winner, verified)``: the global index of the live finalist with
    the smallest exact fp32 centrality over all valid references, and the
    run's ``margin_ok`` flag, both 0-d tensors on the data's device."""
    data = problem.data
    surv = out.survivors
    ref_mask = None
    if problem.ref_mask is not None:
        ref_mask = problem.ref_mask.float()
    sums = distances.centrality_sums(data[surv], data, metric,
                                     ref_mask=ref_mask)
    alive = torch.arange(surv.shape[0], device=surv.device) < out.live
    theta = torch.where(alive, sums, torch.inf)
    if problem.arm_mask is not None:
        theta = torch.where(problem.arm_mask[surv], theta, torch.inf)
    return surv[torch.argmin(theta)], out.margin_ok
