"""Top-k routed Mixture-of-Experts with capacity-bounded one-hot dispatch.

The port of ``repro.models.moe``. Tokens are processed in groups of
``group`` (a Python loop where the reference scans); capacity is per group.
Within a group the router picks each token's top ``K`` experts, each
(token, choice) takes the next slot of its expert's queue, and a choice
past the expert's capacity is dropped. The dispatch and combine tensors are
the reference's one-hot einsums (Mesh-TF / Switch), so the kept slots, the
sums and the Switch auxiliary load-balancing loss are the reference's.

Parity details, each mirrored from the reference:

* ties in the router's top-k go to the lower expert index (``lax.top_k``):
  a stable descending sort, then the first ``K``;
* the queue order is token-major: ``onehot.reshape(B, g * K, E)`` puts
  token i's K choices at positions i*K .. i*K + K - 1;
* a sequence that is not a multiple of the group is zero-padded, and the
  padding rows are routed too (they take queue slots and enter the aux
  loss's means);
* the router runs in f32 on its f32 weight, the expert products in the
  model dtype with ``layers._silu``, the combine in f32 cast back.

:func:`record_routing` collects each group's routing (for the drop counts
and the card-vs-CPU checks of ``chip_smoke.py``); it costs nothing when no
recorder is open.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import MoECfg
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain

_ROUTING = contextvars.ContextVar("moe_routing", default=None)


@contextlib.contextmanager
def record_routing():
    """Collect every group's routing while open (in this thread or task).
    Yields a list that gains one dict a group, in call order: ``probs``
    (B, g, E) f32, ``idx`` (B, g, K) the chosen experts, ``kept`` (B, g, K)
    bool (False: dropped at capacity) and ``rows``, the group's rows that
    are not padding."""
    tape = []
    token = _ROUTING.set(tape)
    try:
        yield tape
    finally:
        _ROUTING.reset(token)


def moe_init(gen, d_model: int, cfg: MoECfg, d_ff_dense: int, dtype,
             device=None) -> dict:
    device = L.init_device(gen, device)
    d_e = cfg.d_expert or d_ff_dense
    p = {
        "router": L.dense_init(gen, d_model, cfg.num_experts, torch.float32,
                               device=device),
        "w_gate": _stack_init(gen, cfg.num_experts, d_model, d_e, dtype,
                              device),
        "w_up": _stack_init(gen, cfg.num_experts, d_model, d_e, dtype,
                            device),
        "w_down": _stack_init(gen, cfg.num_experts, d_e, d_model, dtype,
                              device),
    }
    if cfg.num_shared:
        p["shared"] = L.mlp_init(gen, d_model, d_e * cfg.num_shared, dtype,
                                 device=device)
    return p


def _stack_init(gen, e: int, d_in: int, d_out: int, dtype, device):
    return L._normal(gen, (e, d_in, d_out), 1.0 / (d_in ** 0.5), dtype,
                     device)


def route(router: torch.Tensor, xt: torch.Tensor, K: int):
    """The router of one group: ``xt`` (B, g, d) -> (probs (B, g, E) f32,
    gate values (B, g, K) normalised to sum 1, expert indices (B, g, K)),
    ties toward the lower expert index."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :K], idx[..., :K]
    vals = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, vals, idx


def _combine(combine: torch.Tensor, out_e: torch.Tensor) -> torch.Tensor:
    """``einsum("bgec,becd->bgd")``. On DTensors whose experts are sharded,
    each rank combines its own experts' slots and the partial sums are
    reduced over the expert shards, as GSPMD contracts a sharded dim: the
    plain einsum would flatten (e, c) into a strided shard that DTensor
    cannot contract."""
    if not isinstance(out_e, DTensor):
        return torch.einsum("bgec,becd->bgd", combine, out_e)
    place = [(Shard(0),) * 3 if p == Shard(0) else
             (Shard(2), Shard(1), Partial()) if p == Shard(1) else
             (Replicate(),) * 3 for p in out_e.placements]
    c_in, e_in, y_out = (list(t) for t in zip(*place))
    return local_map(lambda c, o: torch.einsum("bgec,becd->bgd", c, o),
                     out_placements=y_out, in_placements=(c_in, e_in),
                     device_mesh=out_e.device_mesh,
                     redistribute_inputs=True)(combine, out_e)


def moe_apply(params, x: torch.Tensor, cfg: MoECfg, *,
              group: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss f32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    g = min(group, S)
    pad = (-S) % g
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    ng = xp.shape[1] // g
    cap = max(1, int(cfg.capacity_factor * g * K / E))
    slots = torch.arange(cap, device=x.device)

    tape = _ROUTING.get()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for gi in range(ng):
        xt = xp[:, gi * g:(gi + 1) * g]                       # (B, g, d)
        probs, gate_vals, gate_idx = route(params["router"], xt, K)
        onehot = F.one_hot(gate_idx, E).float()               # (B, g, K, E)
        # each (token, k) slot's position in its expert's queue, in the
        # reference's token-major order
        flat = onehot.reshape(B, g * K, E)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, g, K, E)
        keep = (pos < cap).float() * onehot
        # one_hot of a position past the capacity is all zeros (as jax's)
        pos_oh = (pos.long()[..., None] == slots).float()     # (B,g,K,E,C)
        sel = pos_oh * onehot[..., None]
        dispatch = torch.einsum("bgke,bgkec->bgec", keep, sel)
        combine = torch.einsum("bgke,bgkec->bgec",
                               keep * gate_vals[..., None], sel)
        if tape is not None:
            tape.append({"probs": probs, "idx": gate_idx,
                         "kept": keep.sum(dim=-1) > 0,
                         "rows": min(g, S - gi * g)})

        ein = torch.einsum("bgec,bgd->becd", dispatch, xt.float())
        ein = constrain(ein.to(xt.dtype), "batch", "expert", None, None)
        h = L._silu(torch.einsum("becd,edf->becf", ein, params["w_gate"])) \
            * torch.einsum("becd,edf->becf", ein, params["w_up"])
        out_e = torch.einsum("becf,efd->becd", h, params["w_down"])
        out_e = constrain(out_e, "batch", "expert", None, None)
        y = _combine(combine, out_e.float())

        # Switch aux loss: fraction routed * mean router prob, per expert
        frac = torch.mean(onehot.sum(dim=2), dim=1)            # (B, E)
        imp = torch.mean(probs, dim=1)                         # (B, E)
        aux = aux + E * torch.mean(torch.sum(frac * imp, dim=-1))
        ys.append(y.to(xt.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], x)
    return y, aux / ng
