"""Shape bucketing for ragged multi-query medoid batches, the counterpart of
``repro/core/bucketing.py`` (the same sizes and plans; the port imports
nothing of the JAX package).

A query of ``n`` points runs in a power-of-two bucket of ``bucket_n(n)``
arms (never below ``min_bucket``), so mixed-size traffic shares one round
schedule per bucket. :func:`plan_buckets` groups queries by bucket in
arrival order, and :func:`pack_queries` zero-pads a group into the
``(B, n_bucket, d)`` + ``lengths`` form the ragged engine consumes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch

# Floor bucket size: every query with n <= 8 shares one schedule.
DEFAULT_MIN_BUCKET = 8


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def bucket_n(n: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """The padded arm count a query of ``n`` points dispatches under."""
    if min_bucket < 1 or next_pow2(min_bucket) != min_bucket:
        raise ValueError(f"min_bucket must be a power of two, got {min_bucket}")
    return max(min_bucket, next_pow2(n))


def num_buckets_for_range(n_lo: int, n_hi: int,
                          min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Worst-case distinct buckets for queries whose sizes fall in
    ``[n_lo, n_hi]``: one per power of two between the two buckets."""
    lo = bucket_n(n_lo, min_bucket)
    hi = bucket_n(n_hi, min_bucket)
    return (hi // lo).bit_length()


def plan_buckets(lengths: Sequence[int],
                 min_bucket: int = DEFAULT_MIN_BUCKET
                 ) -> "OrderedDict[int, list[int]]":
    """``{n_bucket: [query indices]}``, ordered by first arrival."""
    plan: "OrderedDict[int, list[int]]" = OrderedDict()
    for i, n in enumerate(lengths):
        plan.setdefault(bucket_n(int(n), min_bucket), []).append(i)
    return plan


def pack_queries(arrays: Sequence[torch.Tensor],
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 pad_batch_to: int | None = None):
    """Zero-pad ``(n_i, d)`` query tensors into ``(data (B, n_bucket, d),
    lengths (B,) int32)`` on the first query's device. With
    ``pad_batch_to`` the batch is filled with dummy length-1 zero queries
    out to that many slots."""
    if not arrays:
        raise ValueError("pack_queries needs at least one query")
    if arrays[0].ndim != 2:
        raise ValueError(
            f"all queries must be (n_i, d) arrays, got shape "
            f"{tuple(arrays[0].shape)}")
    d = arrays[0].shape[1]
    for a in arrays:
        if a.ndim != 2 or a.shape[1] != d:
            raise ValueError(f"all queries must be (n_i, {d}) arrays, got "
                             f"shape {tuple(a.shape)}")
        if a.shape[0] < 1:
            raise ValueError("empty query (n == 0) — nothing to identify")
    nb = bucket_n(max(a.shape[0] for a in arrays), min_bucket)
    b = len(arrays) if pad_batch_to is None else pad_batch_to
    if b < len(arrays):
        raise ValueError(f"pad_batch_to={pad_batch_to} < batch size "
                         f"{len(arrays)}")
    first = arrays[0]
    data = torch.zeros((b, nb, d), dtype=first.dtype, device=first.device)
    for i, a in enumerate(arrays):
        data[i, :a.shape[0]] = a
    lengths = [a.shape[0] for a in arrays] + [1] * (b - len(arrays))
    return data, torch.tensor(lengths, dtype=torch.int32,
                              device=first.device)
