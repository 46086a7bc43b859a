"""Deterministic, shardable synthetic data pipeline.

The port of ``repro.data.pipeline``, bit for bit on the port's threefry
stream (:mod:`repro_torch.engine.rng`):

* stateless indexing: batch t is a pure function of (seed, t), so a
  restart at any step reproduces the exact stream (a checkpoint stores only
  the step);
* per-rank slices: each data-parallel rank draws its own slice of the
  global batch from disjoint streams;
* modality stubs (audio frames, image embeddings) ride along per config.

Tokens are Zipf-ish with first-order structure, so cross entropy falls in
training (uniform tokens would pin it at log V). ``jax.random.categorical``
is the argmax over V of ``gumbel + logits`` with ``gumbel = -log(-log(u))``
of a uniform on ``[tiny, 1)`` (jax's "low" mode): a (B, S, V) draw, 1.5e9
values at internlm2's full width, whose int64 hash temporaries would take
12 GB a tensor. Element i of the draw hashes counter i alone, so
:func:`_categorical` draws it in contiguous counter ranges and keeps a
running argmax per row: bit-equal to the whole draw wherever the ranges'
edges fall.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.engine import rng

# the values of a range of the categorical draw (2**24: 128 MiB an int64
# temporary)
RANGE = 1 << 24
_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class DataCfg:
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1


def _zipf_logits(v: int, device=None) -> torch.Tensor:
    ranks = torch.arange(1, v + 1, dtype=torch.float32, device=device)
    return -1.1 * torch.log(ranks)


def _categorical(k: rng.Key, logits: torch.Tensor, rows: int,
                 chunk: int = RANGE) -> torch.Tensor:
    """``jax.random.categorical(k, logits, shape=(rows,))`` for 1-D logits
    of V classes, as int64: counters ``start:start + chunk`` at a time, a
    range's rows (whole or cut at its edges) reduced to their first max and
    merged into the running (value, index) of each row, an earlier range's
    index kept on a tie (the first max, as ``argmax``)."""
    V = logits.shape[0]
    dev = k.device
    best = torch.full((rows,), -math.inf, dtype=torch.float32, device=dev)
    arg = torch.zeros((rows,), dtype=torch.int64, device=dev)
    n = rows * V
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        u = rng.uniform_from_bits(rng.bits_range(k, start, stop), _TINY, 1.0)
        g = -torch.log(-torch.log(u))
        del u
        r0, head = divmod(start, V)
        r1 = (stop - 1) // V + 1
        buf = torch.full(((r1 - r0) * V,), -math.inf, dtype=torch.float32,
                         device=dev)
        buf[head:head + stop - start] = g
        del g
        vals = buf.view(r1 - r0, V) + logits
        del buf
        v, i = vals.max(dim=1)
        del vals
        take = v > best[r0:r1]
        best[r0:r1] = torch.where(take, v, best[r0:r1])
        arg[r0:r1] = torch.where(take, i, arg[r0:r1])
    return arg


def _normal(k: rng.Key, shape, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)``. bf16 is ``jax.random``'s
    8-bit path: a uniform on [-1, 1) from the low byte of each draw (7
    mantissa bits; exact in bf16), ``erfinv`` rounded to bf16, times
    sqrt(2) in bf16."""
    if dtype != torch.bfloat16:
        return rng.normal(k, shape).to(dtype)
    b = rng.bits(k, int(np.prod(shape, dtype=np.int64))).reshape(shape)
    f = (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    lo = -0.99609375   # nextafter(-1, 0) in bf16
    u = torch.clamp_min((f.float() - 1.0) * 2.0 + lo, lo)
    e = torch.erfinv(u).to(torch.bfloat16)
    return (e.float() * 1.4140625).to(torch.bfloat16)   # sqrt(2) in bf16


def batch_at(cfg: ModelCfg, shape: InputShape, step: int,
             data: DataCfg = DataCfg(), device=None) -> dict:
    """The global batch for ``step``, restricted to this rank's slice, on
    ``device`` (CUDA unless asked otherwise)."""
    assert shape.global_batch % data.dp_size == 0
    dev = resolve_device(device)
    local_b = shape.global_batch // data.dp_size
    key = rng.fold_in(rng.key(data.seed, dev), step)
    key = rng.fold_in(key, data.dp_rank)
    kt, km, kf = rng.split_many(key, 3)

    V = cfg.vocab_size
    S = shape.seq_len
    # Zipf-ish marginal + first-order structure: token ~ f(prev) with noise
    base = _categorical(kt, _zipf_logits(V, dev), local_b * S) \
        .reshape(local_b, S)
    prev = torch.roll(base, 1, dims=1)
    mix = rng.uniform(km, (local_b, S)) < 0.5
    tokens = torch.where(mix, (prev * 31 + 7) % V, base).to(torch.int32)
    batch = {"tokens": tokens}

    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "audio":
        batch["frames"] = _normal(
            kf, (local_b, cfg.num_audio_frames, cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["image_embed"] = _normal(
            kf, (local_b, cfg.num_image_tokens, cfg.d_model), dt)
    return batch


def stream(cfg: ModelCfg, shape: InputShape, start_step: int = 0,
           data: DataCfg = DataCfg(), device=None) -> Iterator[dict]:
    """Resumable iterator: ``stream(..., start_step=k)`` skips to batch k
    with O(1) work (stateless indexing, the fault-tolerance hook)."""
    t = start_step
    while True:
        yield batch_at(cfg, shape, t, data, device)
        t += 1
