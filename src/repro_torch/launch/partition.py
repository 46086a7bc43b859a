"""Parameter / batch / cache partition specs.

The port of ``repro.launch.partition``, rule for rule. Each rule maps a
parameter path regex to a spec for the TRAILING dims of the leaf; leading
dims are padded with None, so the same rules cover every layer.

Tensor-parallel layout (Megatron-style):
  column-parallel:  wq/wk/wv/w_up/w_gate/w_in/w_uk/w_uv/lm_head  (out dim on model)
  row-parallel:     wo/w_down/w_out                              (in  dim on model)
  embeddings:       vocab dim on model
  MoE experts:      TP *inside* each expert (hidden dim on model) — works for
                    any expert count; EP (expert dim on model) is selected
                    instead when num_experts divides the model axis.
  norms/scalars:    replicated

Parameters come as the port holds them: a weights module or ``{dotted
name: tensor}`` (``layers.3.attn.wq``), one tensor a layer where the
reference stacks the layers on leading axes; the specs come back keyed the
same way, one :class:`~repro_torch.models.sharding.P` a tensor with an entry
a dim. Three rules of the reference read the stacked shape: ``zero_specs``
and ``pure_fsdp_specs`` skip leaves under 2**20 elements and shard the
first divisible dim, which can be a layer dim. Both decide on the stacked
shape (``convert``'s layer axes give it), so a leaf is sharded exactly
when the reference shards it; where the reference shards a layer dim, the
port shards the first divisible trailing dim of each layer's tensor
instead. A cache keeps the reference's stacked layout, so
``cache_specs_tree`` reads the same shapes the reference does.

A mesh is a ``DeviceMesh``, a JAX-like object with ``axis_names`` and
``devices.shape``, or a plain (axis names, sizes) pair; only
:func:`param_shardings` needs a ``DeviceMesh``.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.launch.mesh import axis_names, axis_sizes, batch_axes
from repro_torch.models.sharding import NamedSharding, P

# (path regex, spec for trailing dims)
_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$", ("model", None)),
    (r"(^|/)pos_dec$", (None, None)),
    (r"(^|/)lm_head$", (None, "model")),
    (r"(^|/)img_proj$", (None, "model")),
    (r"(^|/)router$", (None, None)),
    (r"(^|/)(wq|wk|wv|w_up|w_gate|w_in|w_q|w_k|w_v|w_uk|w_uv)$", (None, "model")),
    (r"(^|/)(wo|w_down|w_out)$", ("model", None)),
    (r"(^|/)(w_dkv|w_krope)$", (None, None)),
    (r"(^|/)(bq|bk|bv)$", ("model",)),
    (r"(^|/)conv_w$", (None, "model")),
    (r"(^|/)conv_b$", ("model",)),
    (r"(^|/)(w_i|w_f|R|A_log|D|dt_bias|b|gate)$", None),  # small: replicate
]

_MOE_EP_RULES = [
    # expert-parallel: expert dim on model axis
    (r"ffn.*(w_gate|w_up|w_down)$", ("model", None, None)),
]


def _spec_for(path: str, ndim: int, moe_ep: bool) -> P:
    rules = (_MOE_EP_RULES + _RULES) if moe_ep else _RULES
    for pat, spec in rules:
        if re.search(pat, path):
            if spec is None:
                return P()
            pad = (None,) * (ndim - len(spec))
            return P(*(pad + tuple(spec)))
    return P()  # default: replicate (norm scales etc.)


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _stacks(cfg: ModelCfg) -> dict:
    from repro_torch.convert import _stacked_axes
    return _stacked_axes(cfg)


def stacked_leaf(cfg: ModelCfg, name: str, shape) -> tuple:
    """(reference path, number of layer axes, stacked shape) of the port's
    tensor ``name`` of ``shape``: ``layers.3.attn.wq`` is the reference's
    ``layers/attn/wq`` of (num_layers,) + shape."""
    for spath, sizes in _stacks(cfg).items():
        if name.startswith(spath + "."):
            rest = name[len(spath) + 1:].split(".")[len(sizes):]
            return ("/".join(spath.split(".") + rest), len(sizes),
                    tuple(sizes) + tuple(shape))
    return name.replace(".", "/"), 0, tuple(shape)


def moe_uses_ep(cfg: ModelCfg, mesh) -> bool:
    if cfg.moe is None:
        return False
    return cfg.moe.num_experts % axis_sizes(mesh)["model"] == 0


def param_specs(params, cfg: ModelCfg, mesh) -> dict:
    """``{name: P}`` for a weights module or ``{name: tensor}``. The rule
    and the divisibility guard read the stacked shape, as the reference's
    do; a model axis that lands on a layer dim moves to the first free
    trailing dim it divides, or is dropped."""
    ep = moe_uses_ep(cfg, mesh)
    model_size = axis_sizes(mesh)["model"]
    out = {}
    for name, leaf in _named(params).items():
        shape = tuple(leaf.shape)
        path, k, stacked = stacked_leaf(cfg, name, shape)
        spec = _spec_for(path, len(stacked), ep)
        # divisibility guard: drop model-axis sharding where it doesn't divide
        clean = []
        for dim, ax in zip(stacked, tuple(spec) + (None,) * (len(stacked) - len(spec))):
            clean.append(None if ax == "model" and dim % model_size else ax)
        lead, clean = [a for a in clean[:k] if a is not None], clean[k:]
        for ax in lead:
            size = _axes_size(mesh, (ax,) if isinstance(ax, str) else ax)
            for j, d in enumerate(shape):
                if clean[j] is None and d % size == 0 and d >= size:
                    clean[j] = ax
                    break
        out[name] = P(*clean)
    return out


def param_shardings(params, cfg: ModelCfg, mesh) -> dict:
    """``{name: NamedSharding}`` on the ``DeviceMesh`` ``mesh``."""
    return {k: NamedSharding(mesh, s)
            for k, s in param_specs(params, cfg, mesh).items()}


def _axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _shard_first(cfg, name, leaf, cur, axes, size):
    """The reference's "first still-unsharded, divisible dim" on the
    stacked shape of ``name``; a layer dim there becomes the first such
    trailing dim of the port's tensor. None when no dim qualifies."""
    shape = tuple(leaf.shape)
    _, k, stacked = stacked_leaf(cfg, name, shape)
    full = (None,) * k + tuple(cur) + (None,) * (len(shape) - len(cur))
    for i, (d, ax) in enumerate(zip(stacked, full)):
        if ax is None and d % size == 0 and d >= size:
            break
    else:
        return None
    new = list(full[k:])
    if i >= k:
        new[i - k] = axes
        return P(*new)
    for j, (d, ax) in enumerate(zip(shape, new)):
        if ax is None and d % size == 0 and d >= size:
            new[j] = axes
            return P(*new)
    return None


def _stacked_size(cfg, name, leaf) -> int:
    return math.prod(stacked_leaf(cfg, name, tuple(leaf.shape))[2])


def zero_specs(params, pspecs: dict, mesh, cfg: ModelCfg, axes=None) -> dict:
    """ZeRO/FSDP extension of param specs: additionally shard the first
    still-unsharded, divisible dim of every large leaf over pod x data.
    Applied to optimizer moments always (ZeRO-2) and to params for very
    large models (FSDP)."""
    baxes = tuple(axes) if axes is not None else batch_axes(mesh)
    bsize = _axes_size(mesh, baxes)
    out = {}
    for name, leaf in _named(params).items():
        spec = pspecs[name]
        if _stacked_size(cfg, name, leaf) < (1 << 20):   # below 1M elements
            out[name] = spec
            continue
        new = _shard_first(cfg, name, leaf, tuple(spec), baxes, bsize)
        out[name] = spec if new is None else new
    return out


def pure_fsdp_specs(params, mesh, cfg: ModelCfg) -> dict:
    """ZeRO-3 layout: every large leaf sharded over ALL mesh axes jointly
    on its first divisible dim; no tensor parallelism."""
    axes = axis_names(mesh)
    total = _axes_size(mesh, axes)
    out = {}
    for name, leaf in _named(params).items():
        if _stacked_size(cfg, name, leaf) < (1 << 20):
            out[name] = P()
            continue
        new = _shard_first(cfg, name, leaf, (), axes, total)
        out[name] = P() if new is None else new
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_specs(batch_shape, mesh, axes=None):
    """Shard the leading (batch) dim of every batch leaf over pod x data
    (or an explicit axis tuple, e.g. all axes for pure-FSDP cells)."""
    baxes = tuple(axes) if axes is not None else batch_axes(mesh)
    bsize = _axes_size(mesh, baxes)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % bsize == 0 and shape[0] > 1:
            return P(baxes, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_map(one, batch_shape)


def cache_specs_tree(cache_shape, cfg: ModelCfg, mesh, batch: int,
                     seq_len: int = 0, shard_seq: bool = True):
    """Decode-cache sharding: batch dim over pod x data when it divides,
    and the SEQUENCE dim over the model axis (decode attention then works
    on partial softmaxes a shard); head / head-dim sharding where no dim
    matches ``seq_len``. The batch dim is the first dim equal to ``batch``
    among the first three (after 1-2 stacked layer dims)."""
    baxes = batch_axes(mesh)
    bsize = _axes_size(mesh, baxes)
    msize = axis_sizes(mesh)["model"]

    def one(leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = [None] * ndim
        bdim = None
        for i, d in enumerate(shape):
            if d == batch and i <= 2:
                bdim = i
                break
        if bdim is not None and batch % bsize == 0 and batch > 1:
            spec[bdim] = baxes
        if shard_seq and seq_len:
            for i in range((bdim + 1) if bdim is not None else 1, ndim):
                if shape[i] == seq_len and seq_len % msize == 0:
                    spec[i] = "model"
                    return P(*spec)
        start = (bdim or 0)
        for i in range(ndim - 1, max(ndim - 3, start), -1):
            d = shape[i]
            if d % msize == 0 and d >= msize:
                spec[i] = "model"
                break
        return P(*spec)

    return tree_map(one, cache_shape)


def shardings(specs, mesh):
    """A tree of :class:`P` as a tree of ``NamedSharding`` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def expected_params(cfg: ModelCfg) -> dict:
    """``{name: meta tensor}`` of a config's weights (shapes only)."""
    from repro_torch.models.model import weights_init
    return dict(weights_init(cfg, None, "meta").named_parameters())


