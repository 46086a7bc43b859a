"""Hand-written Hopper kernels for the medoid engine's hot loop.

The counterpart of ``repro/kernels/pairwise_distance.py``. Each kernel has a
wrapper and a plain PyTorch version of the same function in this module.
Wrapper, the TPU kernel it replaces in that file, and its CUDA source in
``csrc/``:

* ``dot_centrality``: ``dot_centrality`` / ``_dot_centrality_kernel``,
  ``dot_centrality.cu``;
* ``l1_centrality``: ``l1_centrality`` / ``_l1_centrality_kernel``,
  ``l1_centrality.cu``;
* ``topk_rank``: ``topk_smallest`` / ``_topk_rank_kernel``,
  ``topk_smallest.cu``;
* ``topk_select``: ``topk_smallest`` / ``_topk_select_kernel``,
  ``topk_smallest.cu``.

A wrapper checks device, dtype, shape and contiguity, then:

* on a CUDA tensor it launches its kernel on the current stream (building
  the libraries at first use, see :mod:`repro_torch.kernels.build`) and adds
  one to ``LAUNCHES[name]``; a failed build or launch raises;
* on a CPU tensor it returns its plain version — the CPU has no kernel;
* on any other device it raises.

What bounds each kernel on an H100 and how its design answers that is
written at the top of its CUDA source. The plain versions repeat each
kernel's arithmetic (Gram products in full fp32) and are the oracles the
kernels are held against on the card.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.core.distances import _gram
from repro_torch.kernels import build

# Launches per wrapper since the last reset_launches(); only a launch of the
# CUDA kernel counts, never a call that took the plain version.
LAUNCHES: Counter = Counter()

_TILE = 64                     # BC == BR in csrc/centrality_tile.cuh
_RANK_TILE = 1024              # RANK_TILE in csrc/topk_smallest.cu
DOT_METRICS = {"sql2": 0, "l2": 1, "cosine": 2}


def reset_launches() -> None:
    LAUNCHES.clear()


def _on_cuda(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise on anything else
    or on mixed devices."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {dev}")


def _check(name: str, t: Optional[torch.Tensor], dtype: torch.dtype,
           shape: tuple) -> None:
    if t is None:
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _splits(c: int, r: int, device: torch.device) -> int:
    """How many blocks share one candidate tile's references: enough to put
    about two blocks on every SM when C alone gives too few tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    c_tiles = -(-c // _TILE)
    r_tiles = -(-r // _TILE)
    return max(1, min(r_tiles, -(-2 * sms // c_tiles)))


def _split_scratch(c: int, r: int, device: torch.device):
    """(splits, the (splits, C) partial-sum scratch or None for one split)."""
    splits = _splits(c, r, device)
    partial = torch.empty((splits, c), dtype=torch.float32, device=device) \
        if splits > 1 else None
    return splits, partial


# ------------------------------- dot_centrality -----------------------------

def dot_centrality_plain(x: torch.Tensor, y: torch.Tensor,
                         xn2: Optional[torch.Tensor],
                         yn2: Optional[torch.Tensor],
                         w: Optional[torch.Tensor], *,
                         metric: str) -> torch.Tensor:
    """``S[c] = sum_r w[r] * f(x_c . y_r)`` with the full fp32 Gram."""
    g = _gram(x, y)
    if metric == "cosine":
        v = 1.0 - g
    else:
        v = torch.clamp_min(xn2[:, None] + yn2[None, :] - 2.0 * g, 0.0)
        if metric == "l2":
            v = torch.sqrt(v)
    if w is not None:
        v = v * w[None, :]
    return v.sum(1)


def dot_centrality(x: torch.Tensor, y: torch.Tensor,
                   xn2: Optional[torch.Tensor], yn2: Optional[torch.Tensor],
                   w: Optional[torch.Tensor] = None, *,
                   metric: str) -> torch.Tensor:
    """Row sums of a Gram-metric distance over weighted references.

    x: (C, d), y: (R, d) float32; xn2 (C,), yn2 (R,) squared row norms for
    l2/sql2 (None for cosine, whose rows the caller normalised); w: (R,)
    float32 reference weights or None (all 1). Returns (C,) float32 sums.

    Replaces ``dot_centrality`` (``src/repro/kernels/pairwise_distance.py``).
    Bound: the bytes of x and y in the rounds where C or R is small, the
    ``2 C R d`` fp32 flops elsewhere (``csrc/dot_centrality.cu``).
    """
    if metric not in DOT_METRICS:
        raise ValueError(f"dot_centrality does not support metric {metric!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"dot_centrality: bad shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    c, d = x.shape
    r = y.shape[0]
    if metric == "cosine":
        if xn2 is not None or yn2 is not None:
            raise ValueError("dot_centrality: cosine takes no norms")
    elif xn2 is None or yn2 is None:
        raise ValueError(f"dot_centrality: {metric} needs xn2 and yn2")
    for t, shape in ((x, (c, d)), (y, (r, d)), (xn2, (c,)), (yn2, (r,)),
                     (w, (r,))):
        _check("dot_centrality", t, torch.float32, shape)
    if not _on_cuda("dot_centrality", x, y, xn2, yn2, w):
        return dot_centrality_plain(x, y, xn2, yn2, w, metric=metric)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    if c == 0:
        return out
    splits, partial = _split_scratch(c, r, x.device)
    fn = build.function("dot_centrality_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), _ptr(xn2), _ptr(yn2), _ptr(w),
                  _ptr(partial), out.data_ptr(), c, r, d, DOT_METRICS[metric],
                  splits, stream)
    build.check("dot_centrality_launch", code)
    LAUNCHES["dot_centrality"] += 1
    return out


# ------------------------------- l1_centrality ------------------------------

def l1_centrality_plain(x: torch.Tensor, y: torch.Tensor,
                        w: Optional[torch.Tensor]) -> torch.Tensor:
    """``S[c] = sum_r w[r] * sum_k |x[c,k] - y[r,k]|``."""
    v = (x[:, None, :] - y[None, :, :]).abs().sum(-1)
    if w is not None:
        v = v * w[None, :]
    return v.sum(1)


def l1_centrality(x: torch.Tensor, y: torch.Tensor,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row sums of l1 distances over weighted references.

    x: (C, d), y: (R, d) float32; w: (R,) float32 weights or None (all 1).
    Returns (C,) float32 sums.

    Replaces ``l1_centrality`` (``src/repro/kernels/pairwise_distance.py``).
    Bound: the bytes of x and y in the rounds where C or R is small, the
    ``3 C R d`` fp32 operations elsewhere (``csrc/l1_centrality.cu``).
    """
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"l1_centrality: bad shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    c, d = x.shape
    r = y.shape[0]
    for t, shape in ((x, (c, d)), (y, (r, d)), (w, (r,))):
        _check("l1_centrality", t, torch.float32, shape)
    if not _on_cuda("l1_centrality", x, y, w):
        return l1_centrality_plain(x, y, w)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    if c == 0:
        return out
    splits, partial = _split_scratch(c, r, x.device)
    fn = build.function("l1_centrality_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), _ptr(w), _ptr(partial),
                  out.data_ptr(), c, r, d, splits, stream)
    build.check("l1_centrality_launch", code)
    LAUNCHES["l1_centrality"] += 1
    return out


# ------------------------------- topk_smallest ------------------------------

def topk_rank_plain(keys: torch.Tensor) -> torch.Tensor:
    """``rank[i] = #{j : v[j] < v[i] or (v[j] == v[i] and j < i)}`` (int32),
    a block of rows of the comparison matrix at a time."""
    n = keys.shape[0]
    idx = torch.arange(n, device=keys.device)
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    step = max(1, (1 << 24) // max(n, 1))
    for i0 in range(0, n, step):
        vi = keys[i0:i0 + step, None]
        ii = idx[i0:i0 + step, None]
        beats = (keys[None, :] < vi) | ((keys[None, :] == vi)
                                        & (idx[None, :] < ii))
        rank[i0:i0 + step] = beats.sum(1, dtype=torch.int32)
    return rank


def topk_rank(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank of int32 keys: (n,) int32 -> (n,) int32.

    Replaces ``_topk_rank_kernel`` of ``topk_smallest``
    (``src/repro/kernels/pairwise_distance.py``). Bound: its ``n^2``
    comparisons (``csrc/topk_smallest.cu``)."""
    if keys.ndim != 1:
        raise ValueError(f"topk_rank: expected 1-D keys, got "
                         f"{tuple(keys.shape)}")
    n = keys.shape[0]
    _check("topk_rank", keys, torch.int32, (n,))
    if n > 2 ** 31 - 1 - _RANK_TILE:
        raise ValueError(f"topk_rank: {n} keys exceed the int32 index range")
    if not _on_cuda("topk_rank", keys):
        return topk_rank_plain(keys)
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return rank
    fn = build.function("topk_rank_launch")
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = fn(keys.data_ptr(), rank.data_ptr(), n, stream)
    build.check("topk_rank_launch", code)
    LAUNCHES["topk_rank"] += 1
    return rank


def topk_select_plain(rank: torch.Tensor, keep: int) -> torch.Tensor:
    """``out[rank[i]] = i`` for ``rank[i] < keep`` (int64 indices). Misses
    go to a spare slot past ``keep`` rather than through a boolean mask, so
    the device never reports a count back to the host."""
    idx = torch.arange(rank.shape[0], device=rank.device)
    slots = torch.where(rank < keep, rank.long(), keep)
    out = torch.empty(keep + 1, dtype=torch.int64, device=rank.device)
    return out.scatter_(0, slots, idx)[:keep]


def topk_select(rank: torch.Tensor, keep: int) -> torch.Tensor:
    """Scatter a rank permutation into the first ``keep`` slots of the
    order it describes: (n,) int32 -> (keep,) int64 indices.

    Replaces ``_topk_select_kernel`` of ``topk_smallest``
    (``src/repro/kernels/pairwise_distance.py``). Bound: its ``12 n``
    bytes (``csrc/topk_smallest.cu``)."""
    if rank.ndim != 1:
        raise ValueError(f"topk_select: expected 1-D rank, got "
                         f"{tuple(rank.shape)}")
    n = rank.shape[0]
    _check("topk_select", rank, torch.int32, (n,))
    if not 0 <= keep <= n:
        raise ValueError(f"topk_select: keep must be in [0, {n}], got {keep}")
    if not _on_cuda("topk_select", rank):
        return topk_select_plain(rank, keep)
    out = torch.empty(keep, dtype=torch.int64, device=rank.device)
    if n == 0 or keep == 0:
        return out
    fn = build.function("topk_select_launch")
    with torch.cuda.device(rank.device):
        stream = torch.cuda.current_stream(rank.device).cuda_stream
        code = fn(rank.data_ptr(), out.data_ptr(), n, keep, stream)
    build.check("topk_select_launch", code)
    LAUNCHES["topk_select"] += 1
    return out
