"""AdamW with decoupled weight decay, global-norm clipping and f32 moments.

The port of ``repro.optim.adamw``: plain functions on tensors keyed by each
parameter's dotted name (a weights module's ``named_parameters()`` names,
``layers.3.attn.wq``), with the reference's arithmetic:

* the clip scale ``min(1, max_norm / max(norm, 1e-9))`` is cast to each
  gradient's dtype before the multiply (bf16 gradients scale in bf16);
* ``b1 ** step`` and ``b2 ** step`` are computed in f32;
* ``mu`` and ``nu`` are f32 whatever the parameter's dtype; the update is
  computed in f32 and cast back to the parameter's dtype;
* weight decay applies to tensors with ``ndim >= 2`` only.

``torch.optim.AdamW`` is not this optimizer: it decays every tensor and
orders its arithmetic differently.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Tensors
    nu: Tensors


def named(params) -> Tensors:
    """``{dotted name: tensor}`` of a module's parameters, or the mapping
    itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params) -> AdamWState:
    ps = named(params)
    dev = next(iter(ps.values())).device if ps else None

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={k: f32(p) for k, p in ps.items()},
                      nu={k: f32(p) for k, p in ps.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    total = None
    for x in tree.values():
        s = x.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def update(grads: Mapping[str, torch.Tensor], state: AdamWState, params, *,
           lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns (new_params, new_state, metrics). The new values are written
    into ``params``' tensors and ``state``'s moments in place, one tensor
    at a time, and those are returned (the reference's launcher donates its
    state; a full-width trainer holds no second copy of either)."""
    ps = named(params)
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    lr = lr if isinstance(lr, torch.Tensor) else torch.tensor(
        lr, dtype=torch.float32)
    for k, p in ps.items():
        g = grads.pop(k)
        gf = g.float()
        del g
        m = b1 * state.mu[k] + (1 - b1) * gf
        v = b2 * state.nu[k] + (1 - b2) * gf * gf
        del gf
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        pn = (p.float() - lr.to(p.device) * delta).to(p.dtype)
        del delta
        with torch.no_grad():
            p.copy_(pn)
        state.mu[k].copy_(m)
        state.nu[k].copy_(v)
    return ps, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm}
