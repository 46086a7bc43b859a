"""LR schedules (cosine with linear warmup, inverse-sqrt).

The port of ``repro.optim.schedule``: the same f32 expressions, on a step
that is an int, a float or a tensor (the train state's step stays on its
device, so reading the rate waits for nothing). Returns a 0-d f32 tensor.
"""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, final_frac: float = 0.1):
    step = _step_f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def inverse_sqrt(step, *, peak_lr: float, warmup_steps: int):
    step = _step_f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    decay = peak_lr * torch.sqrt(warmup_steps
                                 / torch.clamp_min(step, warmup_steps))
    return torch.where(step < warmup_steps, warm, decay)
