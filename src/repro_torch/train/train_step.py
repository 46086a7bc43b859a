"""train_step / serve_step factories.

The port of ``repro.train.train_step``. ``make_train_step(model, tcfg)``
returns ``train_step(state, batch) -> (state, metrics)`` with optional
gradient accumulation over microbatches (into f32 zeros, then divided by
their count; the loss is their mean and the other metrics the last
microbatch's) and optional int8 gradient compression with error feedback,
applied before AdamW. The learning rate is read at ``step + 1``.

The state's tensors are updated in place, one tensor at a time (the
reference's launcher donates the state to its jitted step), and the
returned state holds them. Gradients come from ``loss.backward()`` on the
weights module, whose parameters :func:`init_train_state` makes trainable;
a parameter the loss does not reach gets a zero gradient, as
``jax.grad`` gives it.

Sharded state (``launch/train.py`` under a mesh): the parameters, moments
and residuals are DTensors and the step runs as it is, DTensor placing
every op. A gradient comes back as DTensor leaves it (a replicated
weight's gradient is a partial sum over the ranks that shared its input)
and is reduced to its parameter's placements before the update; the global
norm's per-tensor sums are partial sums reduced once, at its square root;
AdamW updates each shard in place; ``torch.utils.checkpoint`` recomputes
the sharded ops, collectives included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import Model
from repro_torch.models.sharding import unflatten
from repro_torch.optim import adamw, compress, schedule


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    num_microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False


class TrainState(NamedTuple):
    params: Any                       # the weights module, trainable
    opt: adamw.AdamWState
    ef: Optional[compress.EFState]    # error feedback (grad compression)
    step: torch.Tensor                # 0-d int32


def init_train_state(model: Model, seed, tcfg: TrainCfg,
                     device=None) -> TrainState:
    """Fresh weights from ``seed`` (an int or a ``torch.Generator``) on
    ``device`` (CUDA unless asked otherwise), zero moments, step 0."""
    # the constructors freeze the weights for serving
    params = model.init(seed, device=device).requires_grad_(True)
    opt = adamw.init(params)
    return TrainState(
        params=params, opt=opt,
        ef=compress.init_error_feedback(params)
        if tcfg.grad_compression else None,
        step=torch.zeros((), dtype=torch.int32, device=opt.step.device))


def _value_and_grad(model: Model, tcfg: TrainCfg, params, batch):
    """(loss, metrics, {name: grad}) of one batch, detached."""
    for p in params.parameters():
        p.grad = None
    loss, metrics = model.loss(params, batch, remat=tcfg.remat)
    loss.backward()
    grads = {}
    for k, p in params.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        grads[k] = g
        p.grad = None
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _placed_as(part: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A microbatch on its batch's placements. Microbatch i is rows
    i B/n ... (i+1) B/n, the reference's ``reshape((n, B // n) + ...)[i]``;
    where the batch's data shards would cut the microbatches, ``unflatten``
    gathered the batch once (an all-gather, as GSPMD reshards there), and
    each microbatch is sliced back to the batch's shards here, locally."""
    if isinstance(whole, DTensor) and part.placements != whole.placements:
        part = part.redistribute(whole.device_mesh, whole.placements)
    return part


def make_train_step(model: Model, tcfg: TrainCfg):
    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        n = tcfg.num_microbatches
        if n > 1:
            # laid out as the weights (a DTensor's zeros are one)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state.step.device)
            split = {k: unflatten(v, 0, (n, v.shape[0] // n))
                     for k, v in batch.items()}
            for i in range(n):
                mb = {k: _placed_as(split[k][i], batch[k])
                      for k in batch}
                l, metrics, g = _value_and_grad(model, tcfg, state.params,
                                                mb)
                for k in grads:
                    grads[k] += g.pop(k)
                loss_sum = loss_sum + l
            for g in grads.values():
                g.div_(n)
            loss = loss_sum / n
        else:
            loss, metrics, grads = _value_and_grad(model, tcfg, state.params,
                                                   batch)

        ef = state.ef
        if tcfg.grad_compression:
            grads, ef = compress.apply_error_feedback(grads, ef)

        lr = schedule.cosine_with_warmup(
            state.step + 1, peak_lr=tcfg.peak_lr,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        _, opt, opt_metrics = adamw.update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm)
        del grads
        new_state = TrainState(params=state.params, opt=opt, ef=ef,
                               step=state.step + 1)
        return new_state, {"loss": loss, "lr": lr, **metrics, **opt_metrics}

    return train_step


def make_serve_steps(model: Model, max_len: int):
    """(prefill_fn, decode_fn) for the serving path."""

    def prefill(params, batch):
        return model.prefill(params, batch, max_len)

    def decode(params, token, cache, pos, batch=None):
        return model.decode_step(params, token, cache, pos, batch=batch)

    return prefill, decode
