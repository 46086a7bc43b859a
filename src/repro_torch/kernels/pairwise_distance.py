"""Hand-written Hopper kernels for the medoid engine's hot loop.

The counterpart of ``repro/kernels/pairwise_distance.py``. Each kernel has a
wrapper and a plain PyTorch version of the same function in this module.
Wrapper, the TPU kernel it replaces in that file, and its CUDA source in
``csrc/``:

* ``dot_centrality``: ``dot_centrality`` / ``_dot_centrality_kernel``,
  ``dot_centrality.cu``;
* ``l1_centrality``: ``l1_centrality`` / ``_l1_centrality_kernel``,
  ``l1_centrality.cu`` (both centrality kernels take one of the paths of
  ``pairwise_tile.cuh`` with a centrality epilogue, chosen by
  :func:`centrality_plan`);
* ``topk_smallest``: ``topk_smallest`` / ``_topk_rank_kernel`` and
  ``_topk_select_kernel`` in one launch, ``topk_smallest.cu``, by one of
  two paths that :func:`topk_plan` picks: a tiled sort (tiles from
  :func:`topk_rank_plan`) that writes the select where it has the rank, or,
  for a small keep against a long C, a radix select by one block or a
  thread-block cluster (:func:`select_plan`);
  ``topk_smallest_f32`` is the same launch on float32 estimates (the sign
  flip of :func:`totalorder_keys` made in registers), and ``topk_rank`` the
  sort path with the ranks as its output;
* ``dot_pairwise``: ``dot_pairwise`` / ``_dot_kernel``, ``dot_pairwise.cu``;
* ``l1_pairwise``: ``l1_pairwise`` / ``_l1_pairwise_kernel``,
  ``l1_pairwise.cu`` (both pairwise kernels take one of the paths of
  ``pairwise_tile.cuh``, chosen by :func:`pairwise_plan`; the Gram kernels
  in fp32 have a third, the gemm path, for large squares, and a d split of
  the other two across the grid for very wide rows).

A wrapper checks device, dtype, shape and contiguity, then:

* on a CUDA tensor it launches its kernel on the current stream (building
  the libraries at first use, see :mod:`repro_torch.kernels.build`) and adds
  one to ``LAUNCHES[name]`` (a kernel with paths also to
  ``PATH_LAUNCHES[(name, path)]``); a failed build or launch raises;
* on a CPU tensor it returns its plain version — the CPU has no kernel;
* on any other device it raises.

What bounds each kernel on an H100 and how its design answers that is
written at the top of its CUDA source. The plain versions repeat each
kernel's arithmetic (Gram products in full fp32) and are the oracles the
kernels are held against on the card.

``dot_centrality`` and ``dot_pairwise`` take the TPU kernels'
``compute_dtype``: ``"bfloat16"`` rounds both operands to bf16 (nearest
even, as ``astype`` rounds) before each product and keeps the sums, the
norms and the finish in fp32. The quantized path (``quant_bf16_fused``)
runs ``dot_centrality`` in that mode; its launches count under
``"dot_centrality_bf16"`` (``"dot_pairwise_bf16"``), apart from the fp32
mode's.
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
# The launches of the kernels with paths (pairwise_plan, centrality_plan) by
# (name in LAUNCHES, path), counted beside LAUNCHES.
PATH_LAUNCHES: Counter = Counter()

_MAX_BLOCKS = 2 ** 31 - 1      # a one-dimensional grid
_PLAIN_BLOCK = 1 << 24         # elements of l1_pairwise_plain's broadcast
DOT_METRICS = {"sql2": 0, "l2": 1, "cosine": 2}
COMPUTE_DTYPES = {"float32": 0, "bfloat16": 1}


def reset_launches() -> None:
    LAUNCHES.clear()
    PATH_LAUNCHES.clear()


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


def _check_dtype(name: str, compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{name}: compute_dtype must be one of "
                         f"{tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}")


def _launch_name(name: str, compute_dtype: str) -> str:
    return name if compute_dtype == "float32" else f"{name}_bf16"


def _rounded(a: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``a`` as the kernels multiply it: bf16-rounded values in fp32 for
    ``"bfloat16"``, ``a`` itself for ``"float32"``."""
    return a.bfloat16().float() if compute_dtype == "bfloat16" else a


# ------------------------------- dot_centrality -----------------------------

def dot_centrality_plain(x: torch.Tensor, y: torch.Tensor,
                         xn2: Optional[torch.Tensor],
                         yn2: Optional[torch.Tensor],
                         w: Optional[torch.Tensor], *,
                         metric: str,
                         compute_dtype: str = "float32") -> torch.Tensor:
    """``S[c] = sum_r w[r] * f(x_c . y_r)`` with the full fp32 Gram, of
    the bf16-rounded rows for ``compute_dtype="bfloat16"`` (whose products
    are exact in fp32)."""
    g = _gram(_rounded(x, compute_dtype), _rounded(y, compute_dtype))
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
                   metric: str,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """Row sums of a Gram-metric distance over weighted references.

    x: (C, d), y: (R, d) float32; xn2 (C,), yn2 (R,) squared row norms for
    l2/sql2 (None for cosine, whose rows the caller normalised); w: (R,)
    float32 reference weights or None (all 1). ``compute_dtype`` is
    ``"float32"`` or ``"bfloat16"`` (x and y rounded to bf16 before each
    product; the norms are the caller's, of the unrounded rows). Returns
    (C,) float32 sums.

    Replaces ``dot_centrality`` (``src/repro/kernels/pairwise_distance.py``).
    Bound: the long operand's bytes on the skinny rounds (stream path),
    latency on the middle and masked refinement rounds (tile path), the
    flops on the live corpora's exact squares (gemm path), the operands'
    bytes on the embedding rows' rounds (the d split); see
    ``csrc/dot_centrality.cu``.
    """
    if metric not in DOT_METRICS:
        raise ValueError(f"dot_centrality does not support metric {metric!r}")
    _check_dtype("dot_centrality", compute_dtype)
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
        return dot_centrality_plain(x, y, xn2, yn2, w, metric=metric,
                                    compute_dtype=compute_dtype)
    if c == 0 or r == 0:   # an empty sum
        return torch.zeros(c, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = centrality_plan(c, r, d, sms,
                           crossover=dot_crossover(compute_dtype),
                           fp32_gram=dot_gemm(compute_dtype))
    return launch_dot_centrality(x, y, xn2, yn2, w, plan, metric,
                                 compute_dtype)


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
    Bound: the long operand's bytes on the skinny rounds (stream path),
    latency on the middle rounds (tile path); see ``csrc/l1_centrality.cu``.
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
    if c == 0 or r == 0:   # an empty sum
        return torch.zeros(c, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return launch_l1_centrality(x, y, w, centrality_plan(c, r, d, sms))


# ------------------------------- topk_smallest ------------------------------

def totalorder_keys(theta: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 IEEE-totalorder keys (sign-flip bitcast): integer
    comparison then orders floats like ``lax.top_k`` and the JAX topk
    kernels, -0.0 < +0.0 included, which float comparison would merge."""
    b = theta.float().contiguous().view(torch.int32)
    return torch.where(b >= 0, b, torch.bitwise_not(b) ^ -(2 ** 31))


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


# topk_rank's tiled sort (csrc/topk_smallest.cu): keys in tiles of at most
# RANK_TILE, each sorted by one thread-block cluster of up to
# _RANK_MAX_CLUSTER blocks that share the keys outside the tile. A tile's
# bitonic sort costs about twice the one of half its size, its foreign
# searches shrink with it. On an H100 tiles of 512 beat 1024 and 2048 at
# every C of 2048-20000 but 10000, and 8-block clusters beat 3 and 6 at
# C = 20000 and 10000 (chip_smoke.py times them, PERF.md).
RANK_TILE = 512
_RANK_MIN_TILE = 64
_RANK_MAX_TILE = 8192          # the largest tile topk_smallest.cu builds
_RANK_MAX_CLUSTER = 8


def topk_rank_plan(n: int, sms: int, *,
                   tile: int = RANK_TILE) -> tuple[int, int]:
    """``(tile, cluster)`` of one ``topk_rank`` launch over ``n >= 1`` keys
    on a card with ``sms`` multiprocessors: one block and the least power
    of two >= n (at least 64) where n fits a tile, else tiles of ``tile``
    keys, each sorted by a cluster of up to 8 blocks, enough to put about
    ``2048 // tile`` blocks (of ``tile / 2`` threads, at most 1024) on
    every SM. The grid is ``ceil(n / tile) * cluster``."""
    if tile & (tile - 1) or not _RANK_MIN_TILE <= tile <= _RANK_MAX_TILE:
        raise ValueError(f"topk_rank_plan: tile {tile} is not a power of "
                         f"two in [{_RANK_MIN_TILE}, {_RANK_MAX_TILE}]")
    if n <= tile:
        return max(_RANK_MIN_TILE, 1 << (n - 1).bit_length()), 1
    tiles = -(-n // tile)
    per_sm = max(1, 2048 // tile)
    return tile, max(1, min(_RANK_MAX_CLUSTER, per_sm * sms // tiles))


# topk_smallest's two paths (csrc/topk_smallest.cu). The sort ranks every
# key whatever keep is; the select (a radix select by a cluster of up to
# SELECT_MAX_CLUSTER blocks of SELECT_THREADS threads over the keys held in
# registers) finds the first keep keys and orders only them: it counts
# each of up to keep + 255 keys against the others, a cost that grows as
# keep^2 where the sort's grows with C. topk_plan takes the select where C
# is at least SELECT_MIN_C and keep^2 at most SELECT_KEEP_SQ_PER_C keys a
# C (keep <= 4 sqrt(C)), so the halving's keep = C and the distributed
# engines' keep = ceil(C / 2) always sort. One block takes up to
# SELECT_BLOCK_ITEMS keys a thread, a cluster the rest. chip_smoke.py
# times both paths on either side of these limits, and one block beside
# the cluster (PERF.md).
SORT = "sort"
SELECT = "select"
_TOPK_PATH_CODE = {SORT: 0, SELECT: 1}
SELECT_THREADS = 1024          # SEL_THREADS
SELECT_ITEMS = (1, 2, 3, 4, 6, 8, 12, 16)   # keys a thread holds, as built
SELECT_MAX_CLUSTER = 8         # SEL_MAX_CLUSTER
SELECT_KEEP_LIMIT = 1024       # SEL_MAX_KEEP, the kernel's largest keep
SELECT_MIN_C = 1024
SELECT_KEEP_SQ_PER_C = 16
SELECT_BLOCK_ITEMS = 4


def select_plan(n: int, *,
                cluster: int = SELECT_MAX_CLUSTER) -> tuple[str, int, int]:
    """``(SELECT, items, blocks)``: the select path over ``n >= 1`` keys, a
    cluster of ``blocks`` blocks whose threads hold ``items`` keys each in
    registers: one block where ``SELECT_BLOCK_ITEMS`` keys a thread hold
    them all, else the fewest items that need at most ``cluster`` blocks;
    past ``16 * SELECT_THREADS * cluster`` keys ``(SELECT, 0, cluster)``,
    where each block reads its share from device memory every pass."""
    if not 1 <= cluster <= SELECT_MAX_CLUSTER:
        raise ValueError(f"select_plan: cluster {cluster} is not in [1, "
                         f"{SELECT_MAX_CLUSTER}]")
    for items in SELECT_ITEMS:
        blocks = -(-n // (items * SELECT_THREADS))
        if blocks == 1 and items <= SELECT_BLOCK_ITEMS:
            return SELECT, items, 1
    for items in SELECT_ITEMS:
        blocks = -(-n // (items * SELECT_THREADS))
        if blocks <= cluster:
            return SELECT, items, blocks
    return SELECT, 0, cluster


def topk_plan(n: int, keep: int, sms: int) -> tuple[str, int, int]:
    """``(path, tile, cluster)`` of the ``topk_smallest`` launch that takes
    the first ``keep`` of ``n >= 1`` keys on a card with ``sms``
    multiprocessors: :func:`select_plan` where ``n >= SELECT_MIN_C``, ``1
    <= keep <= SELECT_KEEP_LIMIT`` and ``keep^2 <= SELECT_KEEP_SQ_PER_C *
    n``, else the sort of :func:`topk_rank_plan`."""
    if (n >= SELECT_MIN_C and 0 < keep <= SELECT_KEEP_LIMIT
            and keep * keep <= SELECT_KEEP_SQ_PER_C * n):
        return select_plan(n)
    return (SORT,) + topk_rank_plan(n, sms)


def launch_topk(keys: torch.Tensor, keep: int, plan: tuple[str, int, int],
                *, with_rank: bool = False
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ``topk_smallest.cu`` launch on CUDA keys (n >= 1) with ``plan``, a
    ``topk_plan`` result: the wrappers pass the default one,
    ``chip_smoke.py`` and the card tests force others. ``keys`` are int32
    totalorder keys or float32 estimates (the fp32 mode). Returns the first
    ``keep`` indices of the stable order, (keep,) int64, and with
    ``with_rank`` (the sort path only) the (n,) int32 ranks too (else None).
    Counts in ``LAUNCHES`` under ``"topk_smallest"``, and in
    ``PATH_LAUNCHES`` under ``("topk_smallest", path)``, or under
    ``"topk_rank"`` where ``keep`` is 0 and the ranks are the only
    output."""
    n = keys.shape[0]
    path, tile, cluster = plan
    if path not in _TOPK_PATH_CODE:
        raise ValueError(f"topk_smallest: unknown path {path!r}")
    if path == SORT and -(-n // tile) * cluster > _MAX_BLOCKS:
        raise ValueError(f"topk_smallest: {n} keys need more than "
                         f"{_MAX_BLOCKS} blocks")
    if not 0 <= keep <= n:
        raise ValueError(f"topk_smallest: keep must be in [0, {n}], got "
                         f"{keep}")
    if not (keep or with_rank):
        raise ValueError("topk_smallest: keep 0 and no rank output")
    if path == SELECT and (with_rank or keep > SELECT_KEEP_LIMIT):
        raise ValueError(f"topk_smallest: the select path takes 1 <= keep "
                         f"<= {SELECT_KEEP_LIMIT} and gives no ranks")
    if keys.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"topk_smallest: int32 keys or float32 estimates, "
                        f"got {keys.dtype}")
    out = torch.empty(keep, dtype=torch.int64, device=keys.device)
    rank = torch.empty(n, dtype=torch.int32, device=keys.device) \
        if with_rank else None
    fn = build.function("topk_smallest_launch")
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = fn(keys.data_ptr(), _ptr(rank), _ptr(out) if keep else None,
                  n, keep, _TOPK_PATH_CODE[path], tile, cluster,
                  int(keys.dtype == torch.float32), stream)
    build.check("topk_smallest_launch", code)
    if keep:
        LAUNCHES["topk_smallest"] += 1
        PATH_LAUNCHES[("topk_smallest", path)] += 1
    else:
        LAUNCHES["topk_rank"] += 1
    return out, rank


def _check_keys(name: str, keys: torch.Tensor,
                dtype: torch.dtype = torch.int32) -> int:
    if keys.ndim != 1:
        raise ValueError(f"{name}: expected 1-D keys, got "
                         f"{tuple(keys.shape)}")
    n = keys.shape[0]
    _check(name, keys, dtype, (n,))
    if n > 2 ** 31 - 1:
        raise ValueError(f"{name}: {n} keys exceed the int32 index range")
    return n


def topk_rank(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank of int32 keys: (n,) int32 -> (n,) int32, the
    rank-only mode of the ``topk_smallest`` launch (tests and timing; the
    main path never needs the ranks).

    Replaces ``_topk_rank_kernel`` of ``topk_smallest``
    (``src/repro/kernels/pairwise_distance.py``). Bound: launch latency;
    its ``8 n`` bytes take under a microsecond (``csrc/topk_smallest.cu``).
    """
    n = _check_keys("topk_rank", keys)
    if not _on_cuda("topk_rank", keys):
        return topk_rank_plain(keys)
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    return launch_topk(keys, 0, (SORT,) + topk_rank_plan(n, sms),
                       with_rank=True)[1]


def topk_select_plain(rank: torch.Tensor, keep: int) -> torch.Tensor:
    """``out[rank[i]] = i`` for ``rank[i] < keep`` (int64 indices), the
    select phase alone. Misses go to a spare slot past ``keep`` rather than
    through a boolean mask, so the device never reports a count back to the
    host."""
    idx = torch.arange(rank.shape[0], device=rank.device)
    slots = torch.where(rank < keep, rank.long(), keep)
    out = torch.empty(keep + 1, dtype=torch.int64, device=rank.device)
    return out.scatter_(0, slots, idx)[:keep]


def topk_smallest_plain(keys: torch.Tensor, keep: int) -> torch.Tensor:
    """The first ``keep`` indices of the stable ascending order of int32
    keys: the rank, then the select."""
    return topk_select_plain(topk_rank_plain(keys), keep)


def topk_smallest(keys: torch.Tensor, keep: int) -> torch.Tensor:
    """The first ``keep`` indices of the stable ascending order of int32
    keys, ``argsort(keys, stable=True)[:keep]``: (n,) int32 -> (keep,)
    int64, one launch on the path of :func:`topk_plan`.

    Replaces ``topk_smallest``'s ``_topk_rank_kernel`` and
    ``_topk_select_kernel`` together
    (``src/repro/kernels/pairwise_distance.py``). Bound: launch latency; its
    ``4 n + 8 keep`` bytes take under a microsecond
    (``csrc/topk_smallest.cu``)."""
    return _topk_smallest("topk_smallest", keys, keep, torch.int32)


def topk_smallest_f32(theta: torch.Tensor, keep: int) -> torch.Tensor:
    """:func:`topk_smallest` of ``totalorder_keys(theta)`` for float32
    estimates ``theta (n,)``, by the same launch in its fp32 mode, which
    makes the keys in registers (the plain version makes them first)."""
    return _topk_smallest("topk_smallest_f32", theta, keep, torch.float32)


def _topk_smallest(name: str, keys: torch.Tensor, keep: int,
                   dtype: torch.dtype) -> torch.Tensor:
    n = _check_keys(name, keys, dtype)
    if not 0 <= keep <= n:
        raise ValueError(f"{name}: keep must be in [0, {n}], got {keep}")
    if not _on_cuda(name, keys):
        if dtype == torch.float32:
            keys = totalorder_keys(keys)
        return topk_smallest_plain(keys, keep)
    if keep == 0:
        return torch.empty(0, dtype=torch.int64, device=keys.device)
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    return launch_topk(keys, keep, topk_plan(n, keep, sms))[0]


# ---------------------------- dot_pairwise / l1_pairwise ---------------------

def dot_pairwise_plain(x: torch.Tensor, y: torch.Tensor, *,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """``G = x @ y.T`` in full fp32, of the bf16-rounded rows for
    ``compute_dtype="bfloat16"``."""
    return _gram(_rounded(x, compute_dtype), _rounded(y, compute_dtype))


def l1_pairwise_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``D[c, r] = sum_k |x[c,k] - y[r,k]|``, a block of rows at a time."""
    c, d = x.shape
    r = y.shape[0]
    step = max(1, _PLAIN_BLOCK // max(1, r * d))
    out = torch.empty((c, r), dtype=torch.float32, device=x.device)
    for c0 in range(0, c, step):
        out[c0:c0 + step] = (x[c0:c0 + step, None, :]
                             - y[None, :, :]).abs().sum(-1)
    return out


# The pairwise kernels' paths (csrc/pairwise_tile.cuh). PAIRWISE_S is the
# crossover: the stream path takes every shape whose short side has at most
# PAIRWISE_S rows, the tile path the rest. On an H100 the stream path is
# faster up to 20 short rows and the tile path from 24 (chip_smoke.py times
# both at 8-24, PERF.md). The Gram kernels in fp32 (dot_pairwise,
# dot_centrality) have a third path, gemm (dot_gemm). Past the stream
# crossover both the tile and the gemm path are bound by their FFMAs, so
# each takes a time proportional to d and to the outputs it computes: the
# tile path C x R rounded up to its 32-row tiles, the gemm path a whole
# 128 x 128 tile on every SM for each wave of its persistent grid, ~2.3x
# faster an output. So the gemm path is faster where the tile path's outputs
# fill more than GEMM_FILL of the gemm launch's: on an H100 the tile path
# wins at fills of 0.30-0.37 ((896, 896), (192, 4096), (160, 4096)) and the
# gemm path at 0.48 and more ((1024, 1024), (256, 4096), (128, 8192),
# (1536, 1536)), at d = 784 and 2048 (chip_smoke.py times both around it,
# PERF.md). No round of a halving reaches it: their 20k-50k pairs fill a
# few tiles.
PAIRWISE_S = 20
STREAM, TILE, GEMM = "stream", "tile", "gemm"
STREAM_SPLIT, TILE_SPLIT = "stream_split", "tile_split"
SPLIT_PATHS = (STREAM_SPLIT, TILE_SPLIT)
_PATH_CODE = {STREAM: 0, TILE: 1, GEMM: 2, STREAM_SPLIT: 3, TILE_SPLIT: 4}
_STREAM_WARPS = 8              # S_WARPS
_STREAM_ROWS = 2               # long rows a warp takes a pass, at least
_STREAM_BLOCKS_PER_SM = 2      # S_SMEM allows two blocks a SM
_STREAM_SMEM = 112 * 1024      # S_SMEM: short-row bytes a block
_STREAM_SLAB_ALIGN = 128       # S_SLAB_ALIGN
_STREAM_MAX_SHORT = 32         # S_MAX_SHORT
_PAIR_TILE = 32                # T_TILE
_PAIR_BK = 32                  # T_BK
_MAX_CLUSTER = 8               # T_MAX_CLUSTER
_GEMM_TILE = 128               # G_TILE
_GEMM_BLOCKS_PER_SM = 1        # G_SMEM and the registers allow one
GEMM_FILL = 0.42

# The fp32 Gram kernels' d split (fp32_gram, from dot_gemm): where the
# stream or tile plan puts fewer blocks on the card than it holds in one
# wave (two a SM on the stream path, one on the tile path), `ranks`
# independent blocks along d (the grid's y) each sum a run of whole
# SPLIT_GROUP-column groups into a (ranks, C, R) scratch that a second
# launch sums in rank order. Ranks fill the card's wave, and every rank but
# the last keeps at least SPLIT_MIN_D[path] columns: the fastest floors of
# those tools/split_floor.py times on an H100 (stream 256-4096, tile
# 256-2048) at the embedding rows' rounds (d = 32000 and 92544). Rows
# narrower than SPLIT_MIN_WIDTH, the narrowest width it timed where no
# round ran slower split, are not split: at d = 2048, 4096 and 8192 the
# second launch made 2-3 of the 12 splittable rounds of find_medoid and
# k-medoids slower than unsplit, though the 12 together ran 20-41% faster
# (PERF.md).
SPLIT_GROUP = 256              # SPLIT_GROUP
SPLIT_MIN_D = {STREAM_SPLIT: 512, TILE_SPLIT: 256}
SPLIT_MIN_WIDTH = 32000
_SPLIT_MAX_RANKS = 65535       # SPLIT_MAX_RANKS, gridDim.y


def dot_gemm(compute_dtype: str) -> bool:
    """Whether the Gram kernels have the gemm path and the d split in
    ``compute_dtype``: in fp32, not in the bf16 mode."""
    _check_dtype("dot_pairwise", compute_dtype)
    return compute_dtype == "float32"


def gemm_fill(c: int, r: int, sms: int) -> float:
    """The tile path's outputs at (c, r), C and R rounded up to its 32-row
    tiles, over the gemm path's: a 128 x 128 tile on each of its blocks for
    every wave of :func:`gemm_plan`'s grid."""
    tiles = -(-c // _GEMM_TILE) * -(-r // _GEMM_TILE)
    slots = _GEMM_BLOCKS_PER_SM * sms
    waves = -(-tiles // slots)
    padded = -(-c // _PAIR_TILE) * -(-r // _PAIR_TILE) * _PAIR_TILE ** 2
    return padded / (waves * slots * _GEMM_TILE ** 2)


def gemm_plan(c: int, r: int, sms: int) -> tuple[str, int, int]:
    """``(path, grid, splits)`` of a gemm launch for ``c, r >= 1`` on a card
    with ``sms`` multiprocessors: a persistent grid of one block an SM, at
    most one a 128 x 128 output tile, no d split. :func:`pairwise_plan`
    picks it; ``chip_smoke.py`` and the tests force it."""
    tiles = -(-c // _GEMM_TILE) * -(-r // _GEMM_TILE)
    return GEMM, min(tiles, _GEMM_BLOCKS_PER_SM * sms), 1


def split_run(d: int, ranks: int) -> int:
    """The d columns each of ``ranks`` ranks of the d split sums, as
    ``split_run`` in ``csrc/pairwise_tile.cuh``: ceil(d / ranks) in whole
    SPLIT_GROUP-column groups (the last rank sums the rest of d)."""
    groups = -(-d // SPLIT_GROUP)
    return -(-groups // ranks) * SPLIT_GROUP


def split_ranks(d: int, want: int, path: str) -> int:
    """The d split's ranks on ``path`` for ``want`` wanted: none below
    ``SPLIT_MIN_WIDTH`` columns, at most one for every ``SPLIT_MIN_D[path]``
    columns, and no rank without columns (1: no split)."""
    if d < SPLIT_MIN_WIDTH:
        return 1
    ranks = min(want, d // SPLIT_MIN_D[path], _SPLIT_MAX_RANKS)
    if ranks < 2:
        return 1
    return -(-d // split_run(d, ranks))


def split_scratch(c: int, r: int, plan: tuple[str, int, int]) -> int:
    """Floats of the (ranks, C, R) partial Grams a launch with ``plan``
    writes: ``splits * c * r`` on a d-split path, else 0."""
    path, _, splits = plan
    return splits * c * r if path in SPLIT_PATHS else 0


def pairwise_plan(c: int, r: int, d: int, sms: int, *,
                  crossover: int = PAIRWISE_S,
                  fp32_gram: bool = False) -> tuple[str, int, int]:
    """``(path, grid, splits)`` of one pairwise launch on a card with ``sms``
    multiprocessors, for ``c, r >= 1``.

    * ``"stream"`` when ``min(c, r) <= crossover``: ``grid`` blocks of
      warps that stream the long operand's rows, ``splits`` d slabs of the
      short rows in shared memory (one unless they exceed the block's
      budget);
    * ``"gemm"`` otherwise, for the Gram kernels in fp32 (``fp32_gram``,
      from :func:`dot_gemm`), when :func:`gemm_fill` is at least
      ``GEMM_FILL``: :func:`gemm_plan`;
    * ``"tile"`` otherwise: ``grid = tiles * splits`` blocks, 32 x 32
      output tiles, each summed over d by a cluster of ``splits`` blocks
      (at most 8), enough to put about one block on every SM, each block
      with at least one 32-column slab of d.
    * ``"stream_split"`` / ``"tile_split"`` in place of ``"stream"`` /
      ``"tile"`` for the Gram kernels in fp32 (``fp32_gram``) where
      :func:`split_ranks` gives more blocks than the
      unsplit plan within the card's wave (``sms`` tile blocks, two stream
      blocks an SM): ``splits`` ranks along d of the unsplit stream grid
      (``grid`` = its blocks * splits) or of the tiles (``grid = tiles *
      splits``, no cluster).
    """
    if not 0 <= crossover <= _STREAM_MAX_SHORT:
        raise ValueError(f"pairwise_plan: crossover {crossover} outside "
                         f"[0, {_STREAM_MAX_SHORT}]")
    if min(c, r) <= crossover:
        m, n = min(c, r), max(c, r)
        grid = max(1, min(-(-n // (_STREAM_WARPS * _STREAM_ROWS)),
                          _STREAM_BLOCKS_PER_SM * sms))
        ranks = split_ranks(d, _STREAM_BLOCKS_PER_SM * sms // grid,
                            STREAM_SPLIT) if fp32_gram else 1
        if ranks > 1:
            return STREAM_SPLIT, grid * ranks, ranks
        if m * d * 4 <= _STREAM_SMEM:
            return STREAM, grid, 1
        units = _STREAM_SMEM // (m * 4 * _STREAM_SLAB_ALIGN)
        return STREAM, grid, -(-d // (units * _STREAM_SLAB_ALIGN))
    if fp32_gram and gemm_fill(c, r, sms) >= GEMM_FILL:
        return gemm_plan(c, r, sms)
    tiles = -(-c // _PAIR_TILE) * -(-r // _PAIR_TILE)
    slabs = max(1, -(-d // _PAIR_BK))
    splits = max(1, min(_MAX_CLUSTER, -(-sms // tiles), slabs))
    splits = -(-slabs // -(-slabs // splits))  # no rank without a slab
    ranks = split_ranks(d, sms // tiles, TILE_SPLIT) if fp32_gram else 1
    if ranks > splits:
        return TILE_SPLIT, tiles * ranks, ranks
    return TILE, tiles * splits, splits


def _stream_slab(d: int, splits: int) -> int:
    """The stream path's d slab from ``splits``, as ``stream_slab`` in
    ``csrc/pairwise_tile.cuh`` derives it: ceil(d / splits) rounded up to
    whole 128-column lane passes, at least one."""
    slab = -(-d // splits)
    return max(_STREAM_SLAB_ALIGN,
               -(-slab // _STREAM_SLAB_ALIGN) * _STREAM_SLAB_ALIGN)


# The centrality kernels' crossovers between the same two paths (with a
# centrality epilogue): the stream path takes every shape whose short side
# has at most CENTRALITY_S rows (l1_centrality), DOT_CENTRALITY_S rows
# (dot_centrality) or DOT_CENTRALITY_BF16_S rows (dot_centrality's bf16
# mode). On an H100 l1's stream path wins every timed case up to 20 short
# rows and none at 24; dot's, whose FFMA is one instruction a column to
# l1's two (FADD a - b, then FADD acc + |t|, the absolute value an operand
# modifier, in cuobjdump -sass of the tile path), wins most cases at 24
# and few at 28. In the bf16 mode the tile
# path multiplies on the tensor cores and the stream path keeps FFMA, so
# the stream path wins every case up to 8 short rows, 4 of 6 at 12 and 1 of
# 6 at 16 (chip_smoke.py times both paths of each kernel and mode around
# its crossover, PERF.md).
CENTRALITY_S = 20
DOT_CENTRALITY_S = 24
DOT_CENTRALITY_BF16_S = 12


def dot_crossover(compute_dtype: str) -> int:
    """``dot_centrality``'s crossover in ``compute_dtype``."""
    _check_dtype("dot_centrality", compute_dtype)
    return DOT_CENTRALITY_S if compute_dtype == "float32" \
        else DOT_CENTRALITY_BF16_S


def centrality_plan(c: int, r: int, d: int, sms: int, *,
                    crossover: int = CENTRALITY_S,
                    fp32_gram: bool = False) -> tuple[str, int, int]:
    """``(path, grid, splits)`` of one ``dot_centrality`` or
    ``l1_centrality`` launch for ``c, r >= 1``: the launch geometry of
    :func:`pairwise_plan` with the kernel's centrality crossover
    (:func:`dot_crossover` for ``dot_centrality``), its gemm path and its d
    split (:func:`dot_gemm`; neither for ``l1_centrality``). The stream
    path's epilogue writes S directly when R is short and a ``(grid, C)``
    partial when C is short; the tile and gemm paths' an
    ``(r-tiles, C)`` partial of their 32- or 128-row r-tiles; the d split's
    first pass the (splits, C, R) partial Grams (see
    :func:`centrality_scratch`)."""
    return pairwise_plan(c, r, d, sms, crossover=crossover,
                         fp32_gram=fp32_gram)


def centrality_scratch(c: int, r: int, d: int,
                       plan: tuple[str, int, int]) -> tuple[int, int]:
    """``(scratch floats, partial rows)`` of one centrality launch with
    ``plan``: C * R running d sums where the stream path takes several d
    slabs, the d split's :func:`split_scratch` (else 0), and the rows a
    second pass sums (1: none, the first pass or the d split's second pass
    writes S), as ``centrality_rows`` in ``csrc/pairwise_tile.cuh``."""
    path, grid, splits = plan
    if path in SPLIT_PATHS:
        return split_scratch(c, r, plan), 1
    if path == STREAM:
        scratch = c * r if _stream_slab(d, splits) < d else 0
        return scratch, (grid if c <= r else 1)
    return 0, -(-r // (_GEMM_TILE if path == GEMM else _PAIR_TILE))


def _centrality_buffers(name: str, x: torch.Tensor, r: int,
                        plan: tuple[str, int, int]):
    """(scratch, partial, out) of one centrality launch of kernel ``name``
    on a CUDA x (C, d) against R = ``r`` references with ``plan``: the
    running d sums and the second pass's rows that ``centrality_scratch``
    asks for (None where it asks for none), and the (C,) sums."""
    c, d = x.shape
    if plan[1] > _MAX_BLOCKS:
        raise ValueError(f"{name}: ({c}, {r}) needs {plan[1]} blocks, more "
                         f"than {_MAX_BLOCKS}")
    n_scratch, rows = centrality_scratch(c, r, d, plan)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device) \
        if n_scratch else None
    partial = torch.empty((rows, c), dtype=torch.float32, device=x.device) \
        if rows > 1 else None
    return scratch, partial, torch.empty(c, dtype=torch.float32,
                                         device=x.device)


def launch_l1_centrality(x: torch.Tensor, y: torch.Tensor,
                         w: Optional[torch.Tensor],
                         plan: tuple[str, int, int]) -> torch.Tensor:
    """One ``l1_centrality`` launch on CUDA tensors x (C, d), y (R, d),
    w (R,) or None with ``plan``, a ``centrality_plan`` result for
    (C, R, d), C and R >= 1: the wrapper passes the default one,
    ``chip_smoke.py`` forces either path to time both on each side of the
    crossover. Counts in ``LAUNCHES`` and ``PATH_LAUNCHES``."""
    c, d = x.shape
    r = y.shape[0]
    kind, grid, splits = plan
    if kind in SPLIT_PATHS:
        raise ValueError("l1_centrality has no d split")
    scratch, partial, out = _centrality_buffers("l1_centrality", x, r, plan)
    fn = build.function("l1_centrality_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), _ptr(w), _ptr(scratch),
                  _ptr(partial), out.data_ptr(), c, r, d, _PATH_CODE[kind],
                  grid, splits, stream)
    build.check("l1_centrality_launch", code)
    LAUNCHES["l1_centrality"] += 1
    PATH_LAUNCHES[("l1_centrality", kind)] += 1
    return out


def launch_dot_centrality(x: torch.Tensor, y: torch.Tensor,
                          xn2: Optional[torch.Tensor],
                          yn2: Optional[torch.Tensor],
                          w: Optional[torch.Tensor],
                          plan: tuple[str, int, int],
                          metric: str,
                          compute_dtype: str = "float32") -> torch.Tensor:
    """One ``dot_centrality`` launch of ``metric`` in ``compute_dtype`` on
    CUDA tensors x (C, d), y (R, d), xn2 (C,) and yn2 (R,) or None
    (cosine), w (R,) or None with ``plan``, a ``centrality_plan`` result for
    (C, R, d), C and R >= 1: the wrapper passes the one at
    ``dot_crossover(compute_dtype)`` with ``dot_gemm(compute_dtype)``'s
    gemm path and d split,
    ``chip_smoke.py`` forces each path to time them on each side of the
    crossovers. Counts in ``LAUNCHES`` and ``PATH_LAUNCHES`` under
    ``"dot_centrality"`` or ``"dot_centrality_bf16"``."""
    _check_dtype("dot_centrality", compute_dtype)
    c, d = x.shape
    r = y.shape[0]
    kind, grid, splits = plan
    if kind in SPLIT_PATHS and not dot_gemm(compute_dtype):
        raise ValueError(f"dot_centrality in {compute_dtype} has no d split")
    scratch, partial, out = _centrality_buffers("dot_centrality", x, r, plan)
    fn = build.function("dot_centrality_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), _ptr(xn2), _ptr(yn2), _ptr(w),
                  _ptr(scratch), _ptr(partial), out.data_ptr(), c, r, d,
                  DOT_METRICS[metric], COMPUTE_DTYPES[compute_dtype],
                  _PATH_CODE[kind], grid, splits, stream)
    build.check("dot_centrality_launch", code)
    name = _launch_name("dot_centrality", compute_dtype)
    LAUNCHES[name] += 1
    PATH_LAUNCHES[(name, kind)] += 1
    return out


def launch_pairwise(name: str, x: torch.Tensor, y: torch.Tensor,
                    plan: tuple[str, int, int],
                    compute_dtype: str = "float32") -> torch.Tensor:
    """One launch of the pairwise kernel ``name`` on CUDA tensors x (C, d),
    y (R, d) with ``plan``, a ``pairwise_plan`` result for (C, R, d): the
    wrappers pass the default one (``dot_pairwise`` with
    ``dot_gemm(compute_dtype)``), ``chip_smoke.py`` forces each path to
    time them on each side of the crossovers. ``compute_dtype`` is
    ``dot_pairwise``'s alone. Counts in ``LAUNCHES`` and ``PATH_LAUNCHES``
    (the bf16 mode under ``"dot_pairwise_bf16"``)."""
    _check_dtype(name, compute_dtype)
    if name != "dot_pairwise" and compute_dtype != "float32":
        raise ValueError(f"{name} takes no compute_dtype")
    c, d = x.shape
    r = y.shape[0]
    kind, grid, splits = plan
    if grid > _MAX_BLOCKS:
        raise ValueError(f"{name}: ({c}, {r}) needs {grid} blocks, more "
                         f"than {_MAX_BLOCKS}")
    if kind in SPLIT_PATHS and not (name == "dot_pairwise"
                                    and dot_gemm(compute_dtype)):
        raise ValueError(f"{name} in {compute_dtype} has no d split")
    out = torch.empty((c, r), dtype=torch.float32, device=x.device)
    scratch = torch.empty(split_scratch(c, r, plan), dtype=torch.float32,
                          device=x.device) if kind in SPLIT_PATHS else None
    fn = build.function(f"{name}_launch")
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr())
    if name == "dot_pairwise":
        args += (_ptr(scratch), c, r, d, COMPUTE_DTYPES[compute_dtype])
    else:
        args += (c, r, d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(*args, _PATH_CODE[kind], grid, splits, stream)
    build.check(f"{name}_launch", code)
    name = _launch_name(name, compute_dtype)
    LAUNCHES[name] += 1
    PATH_LAUNCHES[(name, kind)] += 1
    return out


def _pairwise(name: str, x: torch.Tensor, y: torch.Tensor, plain,
              compute_dtype: str = "float32",
              fp32_gram: bool = False) -> torch.Tensor:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    c, d = x.shape
    r = y.shape[0]
    for t, shape in ((x, (c, d)), (y, (r, d))):
        _check(name, t, torch.float32, shape)
    if not _on_cuda(name, x, y):
        return plain(x, y)
    if c == 0 or r == 0:
        return torch.empty((c, r), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return launch_pairwise(name, x, y,
                           pairwise_plan(c, r, d, sms, fp32_gram=fp32_gram),
                           compute_dtype)


def dot_pairwise(x: torch.Tensor, y: torch.Tensor, *,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """Pairwise inner products: x (C, d), y (R, d) float32 -> (C, R)
    float32, fp32 accumulation; ``compute_dtype="bfloat16"`` rounds x and y
    to bf16 before each product.

    Replaces ``dot_pairwise`` (``src/repro/kernels/pairwise_distance.py``).
    Bound: the long operand's bytes on the skinny k-medoids shapes (stream
    path), launch latency on the middle halving rounds (tile path), the
    flops on the live corpora's bootstrap squares (gemm path), the
    operands' bytes on the embedding rows' shapes (the d split); see
    ``csrc/dot_pairwise.cu``."""
    return _pairwise("dot_pairwise", x, y,
                     lambda a, b: dot_pairwise_plain(
                         a, b, compute_dtype=compute_dtype), compute_dtype,
                     dot_gemm(compute_dtype))


def l1_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise l1 distances: x (C, d), y (R, d) float32 -> (C, R) float32.

    Replaces ``l1_pairwise`` (``src/repro/kernels/pairwise_distance.py``).
    Bound: the long operand's bytes on the skinny k-medoids shapes (stream
    path), launch latency on the middle halving rounds (tile path); see
    ``csrc/l1_pairwise.cu``."""
    return _pairwise("l1_pairwise", x, y, l1_pairwise_plain)
