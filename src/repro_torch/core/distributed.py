"""Distributed correlated sequential halving over ``torch.distributed``, the
counterpart of ``repro/core/distributed.py`` (v1).

The dataset's rows are sharded over every dimension of a
:class:`torch.distributed.device_mesh.DeviceMesh` jointly: the rank whose
row-major mesh coordinate is ``s`` (``jax.lax.axis_index`` over all the axes)
holds rows ``[s n/P, (s + 1) n/P)``. Each round of correlated SH then:

1. derives the round's reference *indices* from the shared key,
   ``permutation(fold_in(key, r), n)[:t_r]`` — the same on every rank, so no
   index travels;
2. materialises the reference rows (t_r, d) on every rank by a masked row
   sum over ``all_reduce`` (each row has one owner, the others add zeros,
   so the sum is exact), and the surviving candidates' rows the same way;
3. scores this rank's slice of ``ceil(s_r / P)`` candidates against the
   references with the backend's ``centrality_sums`` (the
   ``pallas_fused`` kernels on the card);
4. ``all_gather``\\ s the (s_r,) estimates and halves with
   :func:`repro_torch.engine.halving.default_select` on every rank.

Each rank runs the loop in its own process on its own device; NCCL carries
the collectives on the card and gloo on the CPU, whichever backend the
process group was started with. Every rank returns the same medoid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.backend import get_backend
from repro_torch.engine import rng
from repro_torch.engine.halving import _mean, default_select
from repro_torch.engine.schedule import round_schedule


@dataclass(frozen=True)
class MeshLayout:
    """Where this rank sits in the row sharding of a mesh: ``shards`` ranks
    in all, this one ``shard_id`` (its row-major coordinate), the process
    ``group`` spanning the mesh (None for the default group) and the group
    rank of each shard id (``all_gather`` lists by group rank)."""
    shards: int
    shard_id: int
    group: Optional[dist.ProcessGroup]
    group_rank_of_shard: tuple


def mesh_layout(mesh) -> MeshLayout:
    """The row sharding of ``mesh`` as seen from this rank. A mesh of more
    than one dimension must span the default process group. A
    :class:`MeshLayout` is returned as it is: the engines take one in place
    of its mesh, so a caller can read the mesh's rank table on the host
    before a ``FakeTensorMode`` (where that read has no value) and hand
    them the layout."""
    if isinstance(mesh, MeshLayout):
        return mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    shard_id = 0
    for c, size in zip(coord, mesh.shape):
        shard_id = shard_id * size + c
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif mesh.size() == dist.get_world_size():
        group = None
    else:
        raise ValueError("a mesh of several dimensions must span the whole "
                         "process group")
    ranks = mesh.mesh.flatten().tolist()
    by_shard = tuple(dist.get_group_rank(group, g) if group is not None
                     else g for g in ranks)
    return MeshLayout(mesh.size(), shard_id, group, by_shard)


def make_row_sharding(mesh) -> list:
    """The placements that shard axis 0 of an (n, d) DTensor over every
    dimension of ``mesh`` (``NamedSharding(mesh, P(axes))`` in JAX)."""
    from torch.distributed.tensor import Shard

    return [Shard(0)] * mesh.ndim


def shard_rows(x: torch.Tensor, mesh):
    """A DTensor of ``x (n, d)``, which every rank holds whole, row-sharded
    by :func:`make_row_sharding`: each rank keeps its own rows."""
    from torch.distributed.tensor import DTensor

    lay = mesh_layout(mesh)
    n_local = _rows_per_shard(x.shape[0], lay.shards)
    local = x[lay.shard_id * n_local:(lay.shard_id + 1) * n_local]
    return DTensor.from_local(local.contiguous(), mesh, make_row_sharding(mesh),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _rows_per_shard(n: int, shards: int) -> int:
    if n % shards:
        raise ValueError(f"n={n} must be divisible by device count {shards}")
    return n // shards


def psum(t: torch.Tensor, lay: MeshLayout) -> torch.Tensor:
    """``jax.lax.psum`` over the mesh, in place on ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=lay.group)
    return t


def all_gather_tiled(t: torch.Tensor, lay: MeshLayout) -> torch.Tensor:
    """``jax.lax.all_gather(t, axes, tiled=True)``: every shard's ``t``
    concatenated in shard order."""
    parts = [torch.empty_like(t) for _ in range(lay.shards)]
    dist.all_gather(parts, t.contiguous(), group=lay.group)
    return torch.cat([parts[g] for g in lay.group_rank_of_shard])


def gather_rows(x_local: torch.Tensor, global_idx: torch.Tensor, offset: int,
                lay: MeshLayout) -> torch.Tensor:
    """The rows of the row-sharded global array at ``global_idx`` (the same
    indices on every rank) on every rank: each rank contributes the rows it
    owns, masked, and the sum assembles the rest."""
    n_local = x_local.shape[0]
    local_pos = global_idx - offset
    valid = (local_pos >= 0) & (local_pos < n_local)
    safe = torch.clamp(local_pos, 0, n_local - 1)
    rows = x_local[safe] * valid[:, None].to(x_local.dtype)
    return psum(rows, lay)


def distributed_corr_sh(x_local: torch.Tensor, key: rng.Key, mesh, *,
                        budget: int, metric: str = "l2",
                        backend: str = "reference") -> torch.Tensor:
    """The medoid (a 0-d int64 tensor, the same on every rank) of the (n,
    d) dataset whose rows ``x_local`` this rank holds, row-sharded over
    ``mesh`` (n = P rows of ``x_local``), a ``DeviceMesh`` or its
    :class:`MeshLayout`. ``key`` is the same on every rank."""
    lay = mesh_layout(mesh)
    n_local = x_local.shape[0]
    n = n_local * lay.shards
    offset = lay.shard_id * n_local
    dev = x_local.device
    theta_fn = get_backend(backend).centrality_sums(metric)
    idx = torch.arange(n, device=dev)
    theta_hat = None
    for r, rd in enumerate(round_schedule(n, budget)):
        rkey = rng.fold_in(key, r)      # the same on every rank
        if rd.num_refs >= n:
            refs = torch.arange(n, device=dev)
        else:
            refs = rng.permutation(rkey, n)[:rd.num_refs]
        ref_rows = gather_rows(x_local, refs, offset, lay)
        # every rank gathers all the survivors' rows (the indices must be
        # the same everywhere) and scores its own slice of them
        s = idx.shape[0]
        per_dev = -(-s // lay.shards)
        idx_p = torch.cat([idx, idx.new_full((per_dev * lay.shards - s,),
                                             -1)])
        cand_all = gather_rows(x_local, torch.clamp_min(idx_p, 0), offset,
                               lay)
        lo = lay.shard_id * per_dev
        my_valid = idx_p[lo:lo + per_dev] >= 0
        local_theta = _mean(theta_fn(cand_all[lo:lo + per_dev], ref_rows),
                            ref_rows.shape[0])
        local_theta = torch.where(my_valid, local_theta, torch.inf)
        theta_hat = all_gather_tiled(local_theta, lay)[:s]
        if rd.exact or s <= 2:
            break
        idx = idx[default_select(theta_hat, math.ceil(s / 2))]
    # a one-element gather keeps the index on the device (a 0-d index
    # tensor would be read on the host)
    return idx[torch.argmin(theta_hat).reshape(1)][0]
