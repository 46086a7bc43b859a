"""Communication-optimal distributed correlated sequential halving (v2), the
counterpart of ``repro/core/distributed_v2.py``, over ``torch.distributed``.

v1 (:mod:`repro_torch.core.distributed`) gathers the surviving candidates'
rows to every rank each round. v2 keeps the work where the rows live:

* **Stratified references.** Round r draws ``ceil(t_r / P)`` references
  from every shard, ``permutation(fold_in(fold_in(key, r), shard), n/P)``
  prefixes (``t_r`` rounds up to a multiple of P). With ``t_r < P`` a
  rotating subset of ``t_r`` shards, those with ``(shard - 31 r) mod P <
  t_r``, contributes one reference each.
* **In place while many arms live** (``s_r > 4 n / P``): each rank scores
  its own rows against the gathered (t_r, d) reference rows, survivors are
  a mask over its rows, and the (n,) estimates are ``all_gather``\\ ed; the
  halving keeps exactly ``keep`` arms, ties to the smaller index
  (:func:`survivor_keep_mask`).
* **Replicated when few live**: the survivors' rows go over the wire in
  bf16 (exact on the wire, since each row has one owner, but rounded to
  bf16 before scoring, as in JAX), every rank scores them against its own
  references, and one ``all_reduce`` of the (s_r,) partial sums follows.

Every rank returns the same medoid; NCCL carries the collectives on the card
and gloo on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.distributed import all_gather_tiled, mesh_layout, psum
from repro_torch.engine import rng
from repro_torch.engine.halving import _mean, default_select
from repro_torch.engine.schedule import round_schedule

# replicate mode from s_r <= 4 n / P on; the survivors' rows travel in bf16
GATHER_THRESHOLD_FACTOR = 4
WIRE_DTYPE = torch.bfloat16


def survivor_keep_mask(theta_global: torch.Tensor, keep: int, offset: int,
                       n_local: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's membership mask over its ``n_local`` rows of the
    ``keep`` smallest global estimates, and those estimates' global indices
    in :func:`default_select` order. Membership in the selected index set
    keeps exactly ``keep`` arms where a value threshold (``theta <= kth``)
    would keep every arm tied at the cut."""
    order = default_select(theta_global, keep)
    keep_global = torch.zeros_like(theta_global, dtype=torch.bool)
    keep_global[order] = True
    return keep_global[offset:offset + n_local], order


def distributed_corr_sh_v2(x_local: torch.Tensor, key: rng.Key, mesh, *,
                           budget: int, metric: str = "l2",
                           backend: str = "reference") -> torch.Tensor:
    """The medoid (a 0-d int64 tensor, the same on every rank) of the (n,
    d) dataset whose rows ``x_local`` this rank holds, row-sharded over
    ``mesh``, a ``DeviceMesh`` or its ``MeshLayout`` (see
    :mod:`repro_torch.core.distributed`)."""
    lay = mesh_layout(mesh)
    p, sid = lay.shards, lay.shard_id
    n_local, d = x_local.shape
    n = n_local * p
    offset = sid * n_local
    dev, dtype = x_local.device, x_local.dtype
    theta_sums = get_backend(backend).centrality_sums(metric)
    threshold = GATHER_THRESHOLD_FACTOR * n_local

    alive = torch.ones(n_local, dtype=torch.bool, device=dev)
    surv_idx = None                        # compact survivors (replicated)
    theta_global = torch.full((n,), torch.inf, device=dev)
    for r, rd in enumerate(round_schedule(n, budget)):
        s_r = rd.survivors
        if rd.num_refs >= p:
            t_local = -(-rd.num_refs // p)
            t_r = t_local * p
            sel = 1.0
            slot = sid * t_local
        else:
            t_local, t_r = 1, rd.num_refs
            rot = (sid - r * 31) % p
            sel = float(rot < t_r)
            slot = min(max(rot, 0), t_r - 1)
        skey = rng.fold_in(rng.fold_in(key, r), sid)   # this shard's draw
        local_refs = x_local[rng.permutation(skey, n_local)[:t_local]]

        if s_r > threshold and surv_idx is None:
            # in place: gather the stratified references, score own rows
            ref_rows = torch.zeros((t_r, d), dtype=dtype, device=dev)
            ref_rows[slot:slot + t_local] = local_refs * sel
            psum(ref_rows, lay)
            theta_loc = _mean(theta_sums(x_local, ref_rows), t_r)
            theta_loc = torch.where(alive, theta_loc, torch.inf)
            theta_global = all_gather_tiled(theta_loc, lay)
            if rd.exact or s_r <= 2:
                return torch.argmin(theta_global)
            keep = math.ceil(s_r / 2)
            local_keep, order = survivor_keep_mask(theta_global, keep, offset,
                                                   n_local)
            alive = alive & local_keep
            if keep <= threshold:
                surv_idx = order           # the switch to replicate mode
        else:
            # replicate: gather the survivors' rows in bf16, refs stay local
            if surv_idx is None:           # the first round is small already
                surv_idx = torch.arange(n, device=dev)[:s_r]
            s = surv_idx.shape[0]
            local_pos = surv_idx - offset
            valid = (local_pos >= 0) & (local_pos < n_local)
            safe = torch.clamp(local_pos, 0, n_local - 1)
            contrib = x_local[safe] * valid[:, None].to(dtype)
            cand = psum(contrib.to(WIRE_DTYPE), lay).to(dtype)
            part = theta_sums(cand, local_refs) * sel
            theta = _mean(psum(part, lay), t_r)
            if rd.exact or s <= 2:
                # a one-element gather, on the device (see v1)
                return surv_idx[torch.argmin(theta).reshape(1)][0]
            surv_idx = surv_idx[default_select(theta, math.ceil(s / 2))]
    if surv_idx is not None:
        return surv_idx[0]
    return torch.argmin(theta_global)
