"""Per-rank flops, traffic and collective bytes of the ops a run dispatches.

The counterpart of ``repro.roofline.hlo_cost``. JAX compiles a step to HLO
and ``hlo_cost`` reads the roofline's inputs from that text, multiplying
each while body by its trip count because XLA's own ``cost_analysis``
counts a loop body once. PyTorch has no HLO: :class:`OpCounter` is a
``TorchDispatchMode`` that counts the aten ops one rank actually runs.
Eager execution dispatches every loop iteration, so the trip-count problem
``hlo_cost`` exists for does not arise: a 10-iteration loop counts 10.

Per rank, not global: an op on DTensors is passed on (``NotImplemented``)
to DTensor, which runs it on this rank's local shards, and those local ops
are what is counted; DTensor's sharding propagation also runs each op once
on global-shaped fake tensors to derive the output's shape, and those ops
(dispatched from ``torch/distributed/tensor/_sharding_prop.py``) are not
counted. (A ``FlopCounterMode`` around DTensor ops counts the global op.)

Counted, as ``hlo_cost`` counts them:

* dot flops: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, convolution, attention), 2 * M * N * K for a product;
* elementwise flops: one a result element of an arithmetic op, one an
  input element of a reduction;
* traffic: operand plus result bytes of every op that is not a view or a
  factory, the unfused upper bound (``traffic_upper``);
* collectives: the result bytes of every all-reduce (counted twice:
  reduce-scatter then all-gather on a ring), all-gather, reduce-scatter
  and all-to-all, whether DTensor issued it (``_c10d_functional``) or a
  ``torch.distributed`` call did (``c10d``, the medoid engines' own);
* memory: the bytes of the storages the ops allocate, live until freed
  (``peak_bytes``, the step's temporaries), apart from the storages of
  the tensors registered with :meth:`OpCounter.track_arguments`.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# the in-place ops of ``torch.distributed``'s calls (namespace ``c10d``)
C10D_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                    "_allgather_base_": "all-gather",
                    "allgather_into_tensor_coalesced_": "all-gather",
                    "reduce_scatter_": "reduce-scatter",
                    "_reduce_scatter_base_": "reduce-scatter",
                    "alltoall_": "all-to-all",
                    "alltoall_base_": "all-to-all"}

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "abs", "neg", "exp", "exp2", "expm1",
    "log", "log1p", "log2", "tanh", "maximum", "minimum", "pow", "rsqrt",
    "sqrt", "sin", "cos", "where", "sigmoid", "clamp", "clamp_min",
    "clamp_max", "reciprocal", "silu", "gelu", "round", "floor", "ceil",
    "addcmul", "addcdiv", "lerp", "square", "fill", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "remainder", "fmod", "sign", "atan2",
    "masked_fill", "threshold_backward", "tanh_backward", "sigmoid_backward",
    "silu_backward", "gelu_backward",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "var", "std", "var_mean", "norm",
           "linalg_vector_norm", "cumsum", "prod", "any", "all", "argmax",
           "argmin"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> dict:
    """``{storage key: bytes}`` of the tensors of a tree (a DTensor by its
    local shard), each storage once."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _in_sharding_prop() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


@dataclasses.dataclass
class OpCost:
    flops: float            # total (dot + elementwise)
    dot_flops: float        # tensor-core eligible
    elem_flops: float       # elementwise + reductions
    traffic_bytes: float    # unfused operand + result bytes
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    collective_count: Dict[str, int]
    peak_bytes: float       # most bytes the ops held allocated at once


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: ...``, then ``c.cost()``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.dot_flops = self.elem_flops = self.traffic = 0.0
        self.coll = {k: 0.0 for k in sorted(set(COLLECTIVES.values()))}
        self.coll_n = {k: 0 for k in self.coll}
        self.live = self.peak = 0
        self._held: dict = {}
        self._args: set = set()

    def track_arguments(self, tensors) -> int:
        """Register tensors (DTensors by their local shards) that exist
        before the counted region; returns their bytes on this rank."""
        held = storage_bytes(tensors)
        self._args |= set(held)
        return sum(held.values())

    def _free(self, key):
        self.live -= self._held.pop(key, 0)

    def _hold(self, t: torch.Tensor):
        st = t.untyped_storage()
        k = st._cdata
        if k in self._held or k in self._args:
            return
        n = st.nbytes()
        self._held[k] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, k)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace == "prim" or _in_sharding_prop():
            return out
        self._count(func, args, kwargs, out, leaves)
        return out

    def _count(self, func, args, kwargs, out, leaves):
        ns = func.namespace
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = (COLLECTIVES.get(name) if ns == "_c10d_functional" else
                C10D_COLLECTIVES.get(name) if ns == "c10d" else None)
        if kind is not None:
            b = float(sum(_nbytes(t) for t in outs))
            self.coll[kind] += 2.0 * b if kind == "all-reduce" else b
            self.coll_n[kind] += 1
        if func.overloadpacket in self._flop:
            self.dot_flops += float(self._flop[func.overloadpacket](
                *args, **kwargs, out_val=out))
        base = name[:-1] if name.endswith("_") else name
        if base in _ELEMENTWISE:
            self.elem_flops += float(sum(t.numel() for t in outs))
        elif base in _REDUCE:
            ins = [a for a in leaves if isinstance(a, torch.Tensor)]
            if ins:
                self.elem_flops += float(ins[0].numel())
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if view or name == "wait_tensor":
            return
        for t in outs:
            self._hold(t)
        if not name.startswith("empty"):
            self.traffic += float(sum(_nbytes(a) for a in leaves
                                      if isinstance(a, torch.Tensor))
                                  + sum(_nbytes(t) for t in outs))

    def cost(self) -> OpCost:
        return OpCost(flops=self.dot_flops + self.elem_flops,
                      dot_flops=self.dot_flops, elem_flops=self.elem_flops,
                      traffic_bytes=self.traffic,
                      collective_bytes=sum(self.coll.values()),
                      collective_by_kind=dict(self.coll),
                      collective_count=dict(self.coll_n),
                      peak_bytes=float(self.peak))


def analyze(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)`` of one call."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost()
