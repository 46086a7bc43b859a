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


def _axis_names(entry: Axis) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def seq_of(x: torch.Tensor) -> Optional[str]:
    """``"seq"`` where ``x``'s dim 1 is sharded on the mesh axes the
    installed rules give the sequence, else ``None``: the sequence entry of
    a constraint that keeps the layout the residual stream brings (the
    transformer's stream is sequence-sharded under the pure-FSDP rules of a
    (2, 16, 16) train cell; the recurrent and whisper streams are whole)
    and so moves no rows."""
    rules = _rules()
    if not rules or rules.get("seq") is None or not isinstance(x, DTensor):
        return None
    seq = _axis_names(rules["seq"])
    names = x.device_mesh.mesh_dim_names
    return "seq" if any(p.is_shard(1) and names[i] in seq
                        for i, p in enumerate(x.placements)) else None


def gather_weight(p: torch.Tensor) -> torch.Tensor:
    """A weight as the layer computes with it: a DTensor sharded over the
    batch axes of the installed rules (ZeRO / FSDP), or over the sequence
    axes where no tensor parallelism shares them (pure FSDP with the
    sequence sharded: those shards are FSDP's too), is all-gathered over
    them (its backward reduce-scatters the gradient back), its model-axis
    (tensor-parallel) sharding kept. GSPMD gathers there because the
    activations are batch- or sequence-sharded; DTensor's own choice could
    gather the activations instead, or find no way to contract a
    sequence-sharded activation with a weight sharded on its input dim.
    The identity without rules or sharding."""
    rules = _rules()
    if rules is None or not isinstance(p, DTensor):
        return p
    tp = _axis_names(rules.get("model"))
    axes = _axis_names(rules.get("batch")) + tuple(
        a for a in _axis_names(rules.get("seq")) if a not in tp)
    names = p.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in axes else pl
                 for i, pl in enumerate(p.placements))
    if want == tuple(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


def grad_as_value(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient reduced to ``x``'s own placements in the
    backward before autograd hands it on (``from_local``'s backward
    redistributes): a gradient that comes back a pending sum over a
    vocab-sharded contraction is all-reduced there, not left for DTensor
    to scatter onto the sequence or to meet a masked partial's backward.
    The identity on a tensor that is not a DTensor."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: an activation (..., d) times a weight (d, f). A DTensor
    ``x`` whose rows are sharded on two or more dims (the batch and the
    sequence, pure FSDP's layout) times a weight that is whole on those
    mesh dims is contracted shard by shard: each rank multiplies its own
    rows, and the weight's gradient there is each rank's partial sum.
    DTensor would flatten those rows into the product's one row dim, a
    strided shard it cannot contract (GSPMD contracts the 3-D operand
    as it is). Any other ``x @ w`` is DTensor's or torch's own."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    rows = {p.dim for p in x.placements if p.is_shard()}
    if (len(rows) < 2 or x.ndim - 1 in rows or w.ndim != 2
            or any(p.is_partial() for p in x.placements)
            or not all(q.is_replicate() for q in w.placements)):
        return x @ w
    from torch.distributed.tensor import Partial
    mesh = x.device_mesh
    grad_w = [Partial() if p.is_shard() else Replicate()
              for p in x.placements]
    out = x.to_local() @ w.to_local(grad_placements=grad_w)
    shape = x.shape[:-1] + w.shape[-1:]
    stride = [1]
    for n in reversed(shape[1:]):
        stride.insert(0, stride[0] * n)
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def local_value(x):
    """A DTensor's full value as a plain tensor (a collective: every rank
    calls it); any other value as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
