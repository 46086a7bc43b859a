"""Gradient compression with error feedback.

The port of ``repro.optim.compress``: int8 block quantization (blocks of
``BLOCK`` values, the tail zero-padded, scale ``max|x| / 127``, rounding
half to even as ``jnp.round`` and ``torch.round`` both do) with a
persistent f32 error buffer that carries each step's quantization error
into the next (Karimireddy et al., 2019). Tensors are keyed by dotted
parameter name, as in :mod:`repro_torch.optim.adamw`. On one device there
is no reduction to shrink: the round trip is the lossy channel alone.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import Tensors, named

BLOCK = 256  # quantization block (per-block scale)


class EFState(NamedTuple):
    error: Tensors   # f32 residuals, the gradients' names and shapes


def init_error_feedback(params) -> EFState:
    return EFState(error={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in named(params).items()})


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization. Returns (q, scales)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    blocks = q.float() * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Round-trip int8 quantization (the lossy channel). A DTensor's blocks
    run over its full value, as the reference's over the global array:
    every rank quantizes the gathered tensor and keeps its own shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(g, DTensor):
        return distribute_tensor(compress_decompress(g.full_tensor()),
                                 g.device_mesh, g.placements,
                                 src_data_rank=None)
    q, s = _quantize(g.float())
    return _dequantize(q, s, g.shape)


def apply_error_feedback(grads: Mapping[str, torch.Tensor],
                         ef: EFState) -> Tuple[Tensors, EFState]:
    """Quantize (grads + carried error); carry the new residual."""
    sent, err = {}, {}
    for k, g in grads.items():
        gf = g.float() + ef.error[k]
        s = compress_decompress(gf)
        sent[k] = s.to(g.dtype)
        err[k] = gf - s
    return sent, EFState(error=err)
