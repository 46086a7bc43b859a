"""Logical-axis sharding annotations for model code.

The port of ``repro.models.sharding``. Model code annotates activations
with *logical* axes ("batch", "seq", "model", "ff", ...). The launcher
installs a logical -> mesh mapping (e.g. batch -> ("pod", "data")); outside
any mapping, and on a tensor that is not a DTensor, the annotations are the
identity, so the one-device paths never touch a process group.

:class:`P` is the port's ``PartitionSpec``: one entry a tensor dim, each a
mesh axis name, a tuple of names (the dim sharded over their product, the
first name major) or ``None`` (replicated). :func:`placements` turns it into
DTensor placements on a ``DeviceMesh``: a dim sharded over ("pod", "data")
is ``Shard(i)`` on both mesh dims, which DTensor nests in mesh order, the
row-major layout JAX gives the same spec. :class:`NamedSharding` pairs a
mesh with a spec, as JAX's does; ``constrain`` is ``redistribute`` to the
resolved spec, the counterpart of ``with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Optional, Sequence, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

Axis = Union[str, Sequence[str], None]

# Process-wide, not thread-local as the reference's: on CUDA the autograd
# engine runs the backward (and so every remat recompute) on its own device
# thread, which must see the rules the forward saw.
_state = types.SimpleNamespace(rules=None)


class P(tuple):
    """``P(None, "model")``, ``P(("pod", "data"), None)``: a tuple of
    entries, equal to JAX's ``PartitionSpec`` with the same entries. As
    JAX's, it keeps a one-name tuple as the name and an empty one as
    ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _rules() -> Optional[dict]:
    return _state.rules


@contextlib.contextmanager
def logical_axis_rules(rules: dict[str, Axis]):
    """Install logical->mesh axis mapping, e.g. {"batch": ("pod", "data"),
    "model": "model"}. Unknown logical names map to None (replicated)."""
    prev = _rules()
    _state.rules = dict(rules)
    try:
        yield
    finally:
        _state.rules = prev


def resolve(*logical: Optional[str]) -> P:
    rules = _rules() or {}
    return P(*[rules.get(a) if a is not None else None for a in logical])


def placements(mesh, spec: Sequence, ndim: Optional[int] = None) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with dim names) for
    ``spec``: ``Shard(i)`` on every mesh dim that tensor dim i names,
    ``Replicate()`` on the rest. The names of one tuple entry must come in
    mesh order (JAX's row-major nesting is DTensor's nesting then)."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    entries = tuple(spec)
    if ndim is not None and len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for i, ax in enumerate(entries):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} is not in mesh order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]} used twice in {spec}")
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`P`, JAX's ``NamedSharding``."""
    mesh: Any
    spec: P

    def placements(self, ndim: Optional[int] = None) -> tuple:
        return placements(self.mesh, self.spec, ndim)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the full array, the same on every rank) as a DTensor of
    ``sharding``: each rank keeps its own shard, with no communication."""
    return distribute_tensor(t, sharding.mesh, sharding.placements(t.ndim),
                             src_data_rank=None)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``redistribute`` to the resolved spec under the installed rules (the
    counterpart of ``with_sharding_constraint``); the identity without
    rules or on a tensor that is not a DTensor."""
    if _rules() is None or not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, resolve(*logical), x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. A DTensor whose shards of ``dim`` would
    cut ``sizes[0]`` apart (wk's 2 KV heads on 4 ranks) is gathered on that
    dim first, as GSPMD reshards there."""
    if isinstance(x, DTensor):
        d = dim % x.ndim
        cut = 1
        for p, n in zip(x.placements, x.device_mesh.shape):
            cut *= n if p.is_shard(d) else 1
        if sizes[0] % cut:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(d) else p for p in x.placements])
    return x.unflatten(dim, sizes)


def gather_weight(p: torch.Tensor) -> torch.Tensor:
    """A weight as the layer computes with it: a DTensor sharded over the
    batch axes of the installed rules (ZeRO / FSDP) is all-gathered over
    them (its backward reduce-scatters the gradient back), its model-axis
    (tensor-parallel) sharding kept. GSPMD gathers there because the
    activations are batch-sharded; DTensor's own choice could gather the
    activations instead. The identity without rules or sharding."""
    rules = _rules()
    if rules is None or not isinstance(p, DTensor):
        return p
    axes = rules.get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = p.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in axes else pl
                 for i, pl in enumerate(p.placements))
    if want == tuple(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


def local_value(x):
    """A DTensor's full value as a plain tensor (a collective: every rank
    calls it); any other value as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
