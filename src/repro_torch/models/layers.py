"""Shared building blocks: norms, RoPE, MLPs, initializers.

The port of ``repro.models.layers``. A node of parameters is anything read
as ``p["name"]``: a plain dict of tensors or the :class:`ParamTree` a
model holds them in. Weights keep the JAX layout ``(d_in, d_out)`` and
every product is ``x @ w``, so the arithmetic is the reference's. Compute
dtype is bf16 by default with f32 norms and f32 logits.

Initializers draw from a ``torch.Generator`` the caller passes with the
reference's distributions: normal * 1/sqrt(d_in) for a dense weight,
normal * 0.02 for an embedding. They build on ``device``, else on the
generator's device, else by the port's device rule (CUDA, or raise). On the
``meta`` device they draw nothing and only give shapes and dtypes (the
converter's expected tree).

Activations carry the reference's ``sharding.constrain`` annotations:
the identity on one device, a ``redistribute`` of a DTensor under a mesh's
logical rules (``models/sharding.py``). :func:`embed_lookup` gathers rows
with ``F.embedding``, which DTensor shards over a vocab-sharded table
(each rank looks up its own rows, then a sum over the model axis).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.convert import resolve_device
from repro_torch.models.sharding import (constrain, dot, gather_weight,
                                         grad_as_value, seq_of)


class ParamTree(nn.Module):
    """The reference's params tree as a module: a dict node's tensors are
    frozen parameters, its dicts child nodes, its lists ``ModuleList``s of
    nodes (the port's unstacked layer axes). Read as the reference reads
    its dict, ``node["name"]`` and ``"name" in node``; the state_dict names
    are the dotted paths (``layers.3.ffn.shared.w_up``). Under a mesh's
    rules a DTensor weight reads as ``sharding.gather_weight`` gives it
    (gathered over the batch axes that ZeRO / FSDP shard it on)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, (dict, list)):
                self.add_module(name, _node(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return gather_weight(getattr(self, name))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _node(v):
    """A dict as a :class:`ParamTree`, a list as a ``ModuleList``."""
    if isinstance(v, dict):
        return ParamTree(v)
    return nn.ModuleList(_node(x) for x in v)


def model_dtype(cfg) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name: bf16, float64 (a
    checking copy, see :func:`wide`), else f32."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the reference computes in f32, or kept in
    float64 when it is float64: a float64 copy of an xLSTM runs every step
    in float64 (the layers below and ``xlstm.py`` widen through this)."""
    return x if x.dtype == torch.float64 else x.float()


def init_device(gen, device=None) -> torch.device:
    """Where an initializer builds: ``device``, else the generator's
    device, else the port's device rule."""
    if device is None and isinstance(gen, torch.Generator):
        device = gen.device
    return resolve_device(device)


def _normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    """f32 normal draws times ``std``, cast to ``dtype`` (shape only on the
    meta device)."""
    device = init_device(gen, device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: float = 1.0,
               device=None) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device=None) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


def rmsnorm_init(d: int, device=None) -> dict:
    device = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 inside (float64 for float64 x), cast back to x's dtype."""
    xf = wide(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def layernorm_init(d: int, device=None) -> dict:
    device = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 inside (population variance, as ``jnp.var``), cast back."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return out.to(x.dtype)


def residual(x: torch.Tensor, out: torch.Tensor,
             seq: bool = False) -> torch.Tensor:
    """``x + out``, with ``out`` and the sum on the residual stream's layout
    under a mesh's rules: (batch, seq, -), the reference's transformer
    layer output, with ``seq``; (batch, -, -), its recurrent and whisper
    streams, without. GSPMD reduces a block's sum over the model axis
    there; DTensor would carry it pending into the next block, whose norm
    and products then cannot contract it (whisper's 1500 frames, which 16
    ranks cut unevenly, leave a padded shard its matmul cannot view). The
    plain sum without rules."""
    s = "seq" if seq else None
    return constrain(x + constrain(out, "batch", s, None), "batch", s, None)


# ----------------------------------------------------------------- RoPE ----

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies ``theta ** -(arange(0, hd, 2) / hd)`` in f32
    (theta taken as an f32 scalar, as the reference's per-layer array)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    # a Python scalar base, not a tensor built from it: a host-to-device
    # copy of it would wait for the card's queue at every layer
    return 1.0 / torch.pow(float(theta), exponents)         # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim), positions: (..., S) integers.

    Split-half rotation (the first and second halves of the head are the
    pair), not interleaved; the angles are f32 products of the integer
    positions and the f32 inverse frequencies."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP ----

def mlp_init(gen, d_model: int, d_ff: int, dtype, gated: bool = True,
             device=None) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device=device)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + exp(-x)), each step
    rounded to x's dtype (in bf16, ``F.silu``'s single rounding differs from
    the reference in about a third of the values)."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(params, x: torch.Tensor, act: str = "silu",
              gated: bool = True) -> torch.Tensor:
    up = dot(x, params["w_up"])
    if gated:
        gate = dot(x, params["w_gate"])
        h = (_silu(gate) if act == "silu" else _gelu(gate)) * up
    else:
        h = _gelu(up) if act == "gelu" else _silu(up)
    # the reference's (batch, None, model); a sequence shard the stream
    # brings is kept (GSPMD would gather it here only to slice it again)
    h = constrain(h, "batch", seq_of(h), "model")
    return dot(h, params["w_down"])


def pad_seq(t: torch.Tensor, axis: int, pad: int,
            value: float = 0.0) -> torch.Tensor:
    """Pad ``t``'s sequence axis ``axis`` at the end by ``pad`` entries of
    ``value``."""
    widths = [0, 0] * (t.ndim - 1 - axis) + [0, pad]
    return F.pad(t, widths, value=value)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (the reference's ``params["embed"][tokens]``). On a
    vocab-sharded DTensor table each rank looks up the ids in its rows and
    the masked partial rows are summed here, once (DTensor's masked
    partial can be reduced only once, and the rows have two readers). The
    rows' gradient is reduced to their placements before it reaches the
    masked partial's backward, which takes no pending sum (the layers
    behind a tensor-parallel weight give one)."""
    out = F.embedding(ids.long(), table)
    if isinstance(out, DTensor) and any(p.is_partial()
                                        for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = grad_as_value(out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements]))
    return out


def unembed(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding -> f32 logits (f32 by f32; float64 by float64)."""
    return wide(x) @ wide(embed).T


def remat_call(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with ``remat`` its activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint`` without reentry, the counterpart of
    ``jax.checkpoint``). The values are the same either way."""
    if not remat:
        return fn(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kwargs)
