"""Launch plans of the redesigned centrality kernels (``dot_centrality``,
``l1_centrality``) and ``topk_rank``, pure functions the CPU can hold, and
the arithmetic of the stream path's d slabs and of the tiled sort.

* ``centrality_plan``: which path each round of the main path takes, and
  that every grid, cluster, slab and scratch it asks for fits the H100's
  launch limits and the checks ``csrc/pairwise_tile.cuh`` makes before it
  launches; an emulation, in torch and in this file only, of the order in
  which the stream path sums d over several slabs and applies the finish,
  held against ``dot_centrality_plain``.
* ``topk_rank_plan`` and an emulation, in torch and in this file only, of
  what ``csrc/topk_smallest.cu`` computes: composite keys, a sort per tile,
  ``lower_bound`` counts of the foreign keys and an inclusive scan, held
  against ``topk_rank_plain`` (and so against ``argsort(stable=True)``).

The kernels themselves run only on a card (``tests/test_torch_gpu.py``).
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.engine.schedule import round_schedule
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as pk

pytestmark = pytest.mark.torch_port

SMS = 132                       # H100 SXM
MAX_GRID = 2 ** 31 - 1          # gridDim.x
MAX_CLUSTER = 8                 # portable cluster size
SMEM_BLOCK = 227 * 1024         # shared memory a block can use
TILE, BK = 32, 32               # T_TILE, T_BK
SLAB_ALIGN, STREAM_SMEM = 128, 112 * 1024   # S_SLAB_ALIGN, S_SMEM
STREAM_THREADS = 256            # S_THREADS
N = 20000
WIDTHS = (0, 1, 4, 257, 784, 1024, 4096, 28000)


def _rounds(n, budget_per_arm):
    return [(rd.survivors, rd.num_refs)
            for rd in round_schedule(n, budget_per_arm * n)]


# find_medoid's rounds (30 per arm), k-medoids BUILD step 0 (16), the
# refinement buckets 1024-8192 (20), and the corners
SHAPES = sorted(set(_rounds(N, 30) + _rounds(N, 16)
                    + [s for nb in (1024, 2048, 4096, 8192)
                       for s in _rounds(nb, 20)]
                    + [(1, 1), (1, N), (N, 1)]))


def _check_limits(c, r, d, plan):
    path, grid, splits = plan
    assert 1 <= grid <= MAX_GRID and splits >= 1
    n_scratch, rows = pk.centrality_scratch(c, r, d, plan)
    if path == pk.STREAM:
        m, n = min(c, r), max(c, r)
        assert grid <= 2 * SMS and (grid - 1) * 16 < n   # no idle block
        slab = pk._stream_slab(d, splits)
        assert m * min(slab, d) * 4 <= STREAM_SMEM <= SMEM_BLOCK
        # the block's sum over its warps fits the slab's shared memory
        assert max(m * min(slab, d) * 4, STREAM_THREADS * 4) <= STREAM_SMEM
        assert splits == 1 if d == 0 else -(-d // slab) <= splits
        assert n_scratch == (c * r if slab < d else 0)
        assert rows == (grid if c <= r else 1)
        return
    tiles = -(-c // TILE) * -(-r // TILE)
    slabs = max(1, -(-d // BK))
    assert 1 <= splits <= MAX_CLUSTER and grid == tiles * splits
    run = -(-slabs // splits)
    assert (splits - 1) * run < slabs         # every rank has d columns
    assert n_scratch == 0 and rows == -(-r // TILE)


@pytest.mark.parametrize("c, r", SHAPES)
def test_plan_picks_the_path_and_fits_the_launch_limits(c, r):
    """The stream path exactly where min(C, R) <= CENTRALITY_S, and a
    grid, cluster, slab and scratch that the card and the C launcher
    accept at every width from 1 to 28000 (and 0), forced paths and
    dot_centrality's crossover too."""
    for d in WIDTHS:
        plan = pk.centrality_plan(c, r, d, SMS)
        assert plan[0] == (pk.STREAM if min(c, r) <= pk.CENTRALITY_S
                           else pk.TILE), (c, r, d)
        _check_limits(c, r, d, plan)
        for forced in (0, pk.DOT_CENTRALITY_BF16_S, pk.DOT_CENTRALITY_S,
                       32):
            fplan = pk.centrality_plan(c, r, d, SMS, crossover=forced)
            assert fplan[0] == (pk.STREAM if min(c, r) <= forced
                                else pk.TILE)
            _check_limits(c, r, d, fplan)


def test_main_path_rounds_take_both_paths_in_both_orientations():
    """A find_medoid run at n = 20000 takes the stream path with R short
    (early rounds) and with C short (late rounds), and the tile path in
    between; the crossover shapes lie inside the schedule."""
    kinds = set()
    for c, r in _rounds(N, 30):
        path, _, _ = pk.centrality_plan(c, r, 4096, SMS)
        kinds.add((path, None if path == pk.TILE else c <= r))
    assert kinds == {(pk.STREAM, False), (pk.STREAM, True), (pk.TILE, None)}


@pytest.mark.parametrize("budget_per_arm", (16, 30))
def test_middle_rounds_fill_the_card(budget_per_arm):
    """Each tile-path round of a halving at n = 20000 puts at least 100
    blocks on the 132 SMs (the old 64 x 64 tile gave a few dozen)."""
    for c, r in _rounds(N, budget_per_arm):
        path, grid, _ = pk.centrality_plan(c, r, 1024, SMS)
        if path == pk.TILE:
            assert grid >= 100, (c, r, grid)


def test_plan_corners_and_bad_crossovers():
    assert pk.centrality_plan(1, 1, 1, SMS) == (pk.STREAM, 1, 1)
    assert pk.centrality_plan(1, 1, 1, SMS, crossover=0) == (pk.TILE, 1, 1)
    assert pk.centrality_scratch(1, 1, 1, (pk.TILE, 1, 1)) == (0, 1)
    for bad in (-1, 33):
        with pytest.raises(ValueError, match="crossover"):
            pk.centrality_plan(4, 4, 4, SMS, crossover=bad)


@pytest.mark.parametrize("c, r, d", ((5000, 8, 4096), (16, 2500, 4096),
                                     (20, 2000, 4096), (2, 20000, 28000),
                                     (2500, 16, 2048), (20, 2000, 2048)))
def test_wide_short_rows_keep_running_sums(c, r, d):
    """Several d slabs: a C x R scratch of running sums, slabs within the
    shared-memory budget. The last two are netflix_cosine_fused's R-short
    and C-short rounds: 16 and 20 rows of d = 2048 exceed the block's
    112 KB (16 x 2048 x 4 = 128 KB), so they take two slabs."""
    plan = pk.centrality_plan(c, r, d, SMS)
    assert plan[0] == pk.STREAM and plan[2] > 1
    assert pk.centrality_scratch(c, r, d, plan)[0] == c * r
    assert min(c, r) * pk._stream_slab(d, plan[2]) * 4 <= STREAM_SMEM


# dot_centrality's find_medoid cells: l2 at d = 784 (planted, mnist) and
# cosine at d = 2048 (netflix), at the rounds of n = 20000 and 6424
DOT_CELLS = [(metric, d, n) for metric, d in (("l2", 784), ("cosine", 2048))
             for n in (N, 6424)]


@pytest.mark.parametrize("metric, d, n", DOT_CELLS)
def test_dot_centrality_cell_rounds(metric, d, n):
    """Each round of the cell (30 pulls per arm) takes the path
    dot_centrality's crossover gives, within the launch limits; the run
    takes the stream path in both orientations and the tile path; a stream
    round takes several d slabs, and so the C x R scratch, exactly where
    its short rows exceed the block's 112 KB (never at d = 784)."""
    kinds = set()
    for c, r in _rounds(n, 30):
        plan = pk.centrality_plan(c, r, d, SMS, crossover=pk.DOT_CENTRALITY_S)
        assert plan[0] == (pk.STREAM if min(c, r) <= pk.DOT_CENTRALITY_S
                           else pk.TILE), (c, r)
        _check_limits(c, r, d, plan)
        kinds.add((plan[0], None if plan[0] == pk.TILE else c <= r))
        if plan[0] == pk.STREAM:
            several = min(c, r) * d * 4 > STREAM_SMEM
            assert (plan[2] > 1) == several, (c, r)
            assert (pk.centrality_scratch(c, r, d, plan)[0] > 0) == several
            assert not (several and d == 784)
    assert kinds == {(pk.STREAM, False), (pk.STREAM, True), (pk.TILE, None)}


def test_dot_crossover_by_mode():
    """The fp32 mode crosses to the tile path above DOT_CENTRALITY_S short
    rows, the bf16 mode (tensor-core tiles) above DOT_CENTRALITY_BF16_S."""
    assert pk.dot_crossover("float32") == pk.DOT_CENTRALITY_S == 24
    assert pk.dot_crossover("bfloat16") == pk.DOT_CENTRALITY_BF16_S == 12
    with pytest.raises(ValueError, match="compute_dtype"):
        pk.dot_crossover("float16")


def _widened_rounds(n, budget_per_arm):
    """The quantized path's widened rounds: each band's buffer width by
    each t_r, and the output round."""
    from repro_torch.engine.halving import WIDEN_SLACK
    from repro_torch.engine.schedule import Schedule

    sched = Schedule.from_budget(n, budget_per_arm * n)
    stk = sched.stacked(n, slack=WIDEN_SLACK)
    shapes = [(band.width, t) for band in stk.bands for t in band.num_refs]
    return sorted(set(shapes + [(min(n, WIDEN_SLACK * stk.sizes[stk.r_stop]),
                                 sched[stk.r_stop].num_refs)]))


@pytest.mark.parametrize("d", (784, 2048))
def test_bf16_widened_rounds_plan(d):
    """The 15 widened rounds of the bf16 cells (l2 at d = 784, cosine at
    d = 2048): the stream path for the six with at most 12 short rows, in
    both orientations and each in one slab (no C x R scratch), the tile
    path for the other nine, all within the launch limits."""
    shapes = _widened_rounds(N, 30)
    assert len(shapes) == 15
    kinds = Counter()
    for c, r in shapes:
        plan = pk.centrality_plan(c, r, d, SMS,
                                  crossover=pk.dot_crossover("bfloat16"))
        _check_limits(c, r, d, plan)
        if plan[0] == pk.STREAM:
            assert min(c, r) <= pk.DOT_CENTRALITY_BF16_S
            assert plan[2] == 1
            assert pk.centrality_scratch(c, r, d, plan)[0] == 0
            kinds["C-short" if c <= r else "R-short"] += 1
        else:
            kinds[pk.TILE] += 1
    assert kinds == {"R-short": 3, "C-short": 3, pk.TILE: 9}


def _finish(metric, g, xn2, yn2):
    """``DotOp<M>::finish`` of ``csrc/dot_centrality.cu``."""
    if metric == "cosine":
        return 1.0 - g
    sq = torch.clamp_min(xn2[:, None] + yn2[None, :] - 2.0 * g, 0.0)
    return torch.sqrt(sq) if metric == "l2" else sq


def _emulate_stream(x, y, w, metric, slab, per_slab_finish=False):
    """The stream path's order over several d slabs: each slab's Gram in
    groups of at most 256 columns, added to the running sums that the
    C x R scratch keeps between slabs, the finish applied at the last slab
    only, then weighted row sums. ``per_slab_finish`` applies the finish to
    each slab's own sums (with the slab's own norms) instead: the error the
    scratch exists to prevent."""
    c, d = x.shape
    full = (x * x).sum(1), (y * y).sum(1)
    running = torch.zeros(c, y.shape[0])
    out = torch.zeros(c)
    for k0 in range(0, d, slab):
        part = torch.zeros_like(running)
        for j0 in range(k0, min(d, k0 + slab), 256):
            j1 = min(d, k0 + slab, j0 + 256)
            part += x[:, j0:j1] @ y[:, j0:j1].T
        running += part
        if per_slab_finish:
            xs, ys = x[:, k0:k0 + slab], y[:, k0:k0 + slab]
            out += (_finish(metric, part, (xs * xs).sum(1), (ys * ys).sum(1))
                    * w[None, :]).sum(1)
    if per_slab_finish:
        return out
    return (_finish(metric, running, *full) * w[None, :]).sum(1)


@pytest.mark.parametrize("c, r", ((20, 300), (300, 16)))
@pytest.mark.parametrize("metric", ("l2", "sql2", "cosine"))
def test_stream_slabs_finish_once(metric, c, r):
    """At d = 2048 with 20 (C-short) or 16 (R-short) short rows the plan
    takes two slabs; summing d across them before the finish gives
    ``dot_centrality_plain`` within rtol 1e-5. For l2, a finish per slab
    (a sum of per-slab distances) is far off."""
    d = 2048
    plan = pk.centrality_plan(c, r, d, SMS)
    slab = pk._stream_slab(d, plan[2])
    assert plan[0] == pk.STREAM and -(-d // slab) == 2
    rng = np.random.default_rng(c + r)
    x = torch.from_numpy(rng.random((c, d), dtype=np.float32))
    y = torch.from_numpy(rng.random((r, d), dtype=np.float32))
    w = torch.from_numpy((rng.random(r) > 0.3).astype(np.float32))
    if metric == "cosine":
        x, y = ops._unit_rows(x), ops._unit_rows(y)
        xn2 = yn2 = None
    else:
        xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
    want = pk.dot_centrality_plain(x, y, xn2, yn2, w, metric=metric)
    got = _emulate_stream(x, y, w, metric, slab)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    if metric == "l2":
        wrong = _emulate_stream(x, y, w, metric, slab, per_slab_finish=True)
        assert bool(((wrong - want).abs() > 0.1 * want.abs()).all())


# ----------------------------------------------- dot_centrality's gemm path
GEMM_TILE = 128                 # G_TILE
_UNSPLIT = {pk.STREAM_SPLIT: pk.STREAM, pk.TILE_SPLIT: pk.TILE}


def _dot_plan(c, r, d, compute_dtype="float32"):
    """dot_centrality's plan, as its wrapper makes it."""
    return pk.centrality_plan(c, r, d, SMS,
                              crossover=pk.dot_crossover(compute_dtype),
                              fp32_gram=pk.dot_gemm(compute_dtype))


@pytest.mark.parametrize("c, r, d", ((32768, 32768, 784),
                                     (32768, 32768, 2048),
                                     (2048, 2048, 92544),
                                     (49152, 49152, 16)))
def test_gram_squares_take_the_gemm_path(c, r, d):
    """The live corpus's masked exact re-run (32768^2 at d = 784) and a
    cosine square at d = 2048 plan "gemm" for dot_centrality in fp32, with
    an (r-tiles, C) partial of 128-row r-tiles and no scratch, a persistent
    grid within the launch limits; l1_centrality and the bf16 mode keep the
    tile path at the same shapes."""
    plan = _dot_plan(c, r, d)
    assert plan == (pk.GEMM, SMS, 1)
    assert pk.centrality_scratch(c, r, d, plan) == (0, -(-r // GEMM_TILE))
    rows = pk.centrality_scratch(c, r, d, plan)[1]
    assert rows * c < 2 ** 31 <= MAX_GRID + 1 and plan[1] <= MAX_GRID
    for plan in (pk.centrality_plan(c, r, d, SMS), _dot_plan(c, r, d,
                                                             "bfloat16")):
        assert plan[0] == pk.TILE
        _check_limits(c, r, d, plan)


def _every_main_path_shape():
    """(c, r, d) of every round the existing tests enumerate: find_medoid,
    the k-medoids BUILD and the refinement buckets at each width, the dot
    cells, the bf16 cells' widened rounds and the vocabulary-wide embedding
    rounds."""
    out = {(c, r, d) for c, r in SHAPES for d in WIDTHS}
    out |= {(c, r, d) for metric, d, n in DOT_CELLS for c, r in _rounds(n, 30)}
    out |= {(c, r, d) for d in (784, 2048) for c, r in _widened_rounds(N, 30)}
    out |= {(c, r, d) for d in VOCAB_WIDTHS for c, r in EMBED_SHAPES}
    return sorted(out)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_round_shapes_keep_their_path(dtype):
    """No round the tests enumerate reaches the gemm path (their 20k-50k
    pairs fill a few 128 x 128 tiles): dot_centrality's plan equals the
    plan without a gemm path at each of them, or that plan's d split."""
    shapes = _every_main_path_shape()
    assert len(shapes) > 500
    for c, r, d in shapes:
        plan = _dot_plan(c, r, d, dtype)
        base = pk.centrality_plan(c, r, d, SMS,
                                  crossover=pk.dot_crossover(dtype))
        assert plan == base or (plan[0] in pk.SPLIT_PATHS
                                and _UNSPLIT[plan[0]] == base[0]), (c, r, d)


def _emulate_gemm(x, y, xn2, yn2, w, metric):
    """The gemm path's order of sums, in torch: the Gram in groups of 256
    columns added to the totals in d order, the finish, the weights; per
    128-row r-tile, each thread's 8 columns (tc + 16 j) in j order, a
    shuffle tree over the 8 lanes of each half (1, 2, then 4 apart), then
    half 0 + half 1; then ``reduce_rows_kernel`` over the r-tiles: lane l
    sums r-tiles l, l + 32, ..., then a tree 16, 8, 4, 2, 1 apart."""
    c, d = x.shape
    r = y.shape[0]
    g = torch.zeros(c, r)
    for j0 in range(0, d, 256):
        g = g + x[:, j0:j0 + 256] @ y[:, j0:j0 + 256].T
    v = _finish(metric, g, xn2, yn2) * w[None, :]
    nt = -(-r // GEMM_TILE)
    cols = torch.zeros(c, nt * GEMM_TILE)
    cols[:, :r] = v
    cols = cols.view(c, nt, 8, 16)            # column r0 + tc + 16 j
    s = torch.zeros(c, nt, 16)
    for j in range(8):
        s = s + cols[:, :, j, :]
    half = s.view(c, nt, 2, 8)
    for off in (1, 2, 4):
        half = half + half[..., torch.arange(8) ^ off]
    part = half[..., 0, 0] + half[..., 1, 0]  # (C, r-tiles)
    lanes = torch.zeros(c, 32)
    for k in range(nt):
        lanes[:, k % 32] = lanes[:, k % 32] + part[:, k]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ off]
    return lanes[:, 0]


@pytest.mark.parametrize("c, r, d", ((50, 300, 600), (37, 4500, 784)))
@pytest.mark.parametrize("metric", ("l2", "sql2", "cosine"))
def test_gemm_order_matches_plain(metric, c, r, d):
    """The gemm path's summation order (several 256-column groups, ragged
    128-row r-tiles, 3 and 36 of them) gives ``dot_centrality_plain``
    within the card tests' tolerance: rtol 1e-5 with a floor of 1e-5 of
    the largest sum (no self-pairs, so l2 needs no allowance)."""
    rng = np.random.default_rng(c * r + d)
    x = torch.from_numpy(rng.random((c, d), dtype=np.float32))
    y = torch.from_numpy(rng.random((r, d), dtype=np.float32))
    w = torch.from_numpy((rng.random(r) > 0.3).astype(np.float32))
    if metric == "cosine":
        x, y = ops._unit_rows(x), ops._unit_rows(y)
        xn2 = yn2 = None
    else:
        xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
    want = pk.dot_centrality_plain(x, y, xn2, yn2, w, metric=metric)
    got = _emulate_gemm(x, y, xn2, yn2, w, metric)
    tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= tol).all())


def test_cpu_tensors_take_the_plain_version():
    x = torch.rand(7, 5)
    y = torch.rand(9, 5)
    w = (torch.rand(9) > 0.5).float()
    before = pk.LAUNCHES["l1_centrality"]
    paths = pk.PATH_LAUNCHES.copy()
    got = pk.l1_centrality(x, y, w)
    want = (x[:, None] - y[None]).abs().sum(-1) @ w
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert pk.LAUNCHES["l1_centrality"] == before
    assert pk.PATH_LAUNCHES == paths


# ------------------------------------------------------------ topk_rank

@pytest.mark.parametrize("n", (1, 2, 63, 64, 65, 1000, 2047, 2048, 2049,
                               4097, 6424, 8192, 8193, 20000, 10 ** 6))
def test_rank_plan_fits_the_launch_limits(n):
    """One block where n fits a tile, else ceil(n / tile) tiles, each
    sorted by a cluster of 1-8 blocks."""
    for tile in (512, 1024, 2048, 4096, 8192):
        t, cl = pk.topk_rank_plan(n, SMS, tile=tile)
        assert t & (t - 1) == 0 and 64 <= t <= 8192
        assert 1 <= cl <= MAX_CLUSTER
        tiles = -(-n // t)
        if n <= tile:
            assert (tiles, cl) == (1, 1) and t >= n and (t == 64 or t < 2 * n)
        else:   # about 2048 // tile blocks a SM, or one a tile
            assert t == tile
            assert tiles * cl <= max(max(1, 2048 // t) * SMS, tiles)
        # dynamic shared memory: tile keys (8 bytes) and counts (4 bytes)
        assert t * 12 <= SMEM_BLOCK
        assert tiles * cl <= MAX_GRID


def test_rank_plan_rejects_bad_tiles():
    for bad in (32, 3000, 16384):
        with pytest.raises(ValueError, match="tile"):
            pk.topk_rank_plan(10, SMS, tile=bad)


def _emulate_rank(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """The arithmetic of ``topk_rank_kernel``: composite keys, a sort per
    tile, the branchless ``lower_bound`` of each foreign key in the sorted
    tile, counts per position and their inclusive scan."""
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64)
    # the kernel's uint64 (key + 2^31) << 32 | i moved into int64's signed
    # range (key << 32 | i): the same order, distinct keys
    u = (keys.long() << 32) | idx
    pad = torch.iinfo(torch.int64).max                  # above every u
    rank = torch.empty(n, dtype=torch.int32)
    for t0 in range(0, n, tile):
        m = min(tile, n - t0)
        s = torch.full((tile,), pad, dtype=torch.int64)
        s[:m] = torch.sort(u[t0:t0 + m]).values
        foreign = torch.cat([u[:t0], u[t0 + m:]])
        p = torch.zeros(foreign.shape[0], dtype=torch.int64)
        step = tile // 2
        while step >= 1:
            p += torch.where(s[p + step - 1] < foreign, step, 0)
            step //= 2
        p += (s[p] < foreign).long()
        hist = torch.bincount(p[p < m], minlength=tile)[:tile]
        cnt = torch.cumsum(hist, 0)
        pos = torch.arange(m)
        rank[(s[:m] & 0xFFFFFFFF)] = (pos + cnt[:m]).int()
    return rank


def _key_cases(n, seed):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal(n).astype(np.float32)
    theta[::7] = 0.0
    theta[::11] = -0.0
    theta[::13] = np.inf
    theta[::17] = -np.inf
    theta[::19] = np.nan
    theta[::23] = -np.nan
    theta[::5] = theta[0]
    extremes = rng.integers(-3, 3, n).astype(np.int32)
    extremes[::3] = 2 ** 31 - 1
    extremes[1::3] = -2 ** 31
    return {
        "ties": ops.totalorder_keys(torch.from_numpy(theta)),
        "equal": torch.full((n,), 7, dtype=torch.int32),
        "extremes": torch.from_numpy(extremes),
        "distinct": ops.totalorder_keys(
            torch.from_numpy(rng.random(n).astype(np.float32))),
    }


@pytest.mark.parametrize("n", (1, 2, 3, 63, 64, 65, 127, 128, 129, 255,
                               256, 257, 511, 513))
def test_tiled_sort_emulation_matches_plain(n):
    """At C around a tile (64 here, the kernel's smallest; its arithmetic
    does not depend on the size): ties, +-0.0, +-NaN, +-inf, all-equal
    keys and the int32 extremes give the plain rank, whose select is the
    stable argsort."""
    for kind, keys in _key_cases(n, n).items():
        want = pk.topk_rank_plain(keys)
        for tile in (64, 128):
            got = _emulate_rank(keys, tile)
            assert torch.equal(got, want), (kind, tile)
        np.testing.assert_array_equal(
            pk.topk_select_plain(want, n).numpy(),
            torch.argsort(keys, stable=True).numpy())


@pytest.mark.parametrize("n", (pk.RANK_TILE - 1, pk.RANK_TILE,
                               pk.RANK_TILE + 1, 2 * pk.RANK_TILE + 1))
def test_tiled_sort_emulation_at_the_kernel_tile(n):
    """The same at C around the kernel's tile, with its plan's tile."""
    t, _ = pk.topk_rank_plan(n, SMS)
    for kind, keys in _key_cases(n, 7 * n).items():
        assert torch.equal(_emulate_rank(keys, t),
                           pk.topk_rank_plain(keys)), kind


# ------------------------------------------- vocabulary-wide embedding rows
# The LM scaffold's embeddings are rows as wide as a vocabulary (the mean of
# the logits over positions): internlm2 92544, qwen2.5 152064, command-r
# 256000, gemma3 262144. Their rounds: find_medoid at 20 pulls per arm
# (examples/embedding_medoid_torch.py) and the k-medoids BUILD's 16, at the
# n of the example (512) and of chip_smoke.py's phase 8 (2048).
VOCAB_WIDTHS = (92544, 152064, 256000, 262144)
EMBED_SHAPES = sorted({s for n in (512, 2048) for b in (20, 16)
                       for s in _rounds(n, b)})


@pytest.mark.parametrize("d", VOCAB_WIDTHS)
def test_vocab_width_rounds_fit_the_launch_limits(d):
    """Each round at d = V takes dot_centrality's path within the launch
    limits; a stream round keeps its short rows in d slabs of the block's
    112 KB and so the C x R running sums (a few dozen slabs, never a single
    one at these widths), and C * d stays an int64 index."""
    kinds = set()
    for c, r in EMBED_SHAPES:
        plan = pk.centrality_plan(c, r, d, SMS, crossover=pk.DOT_CENTRALITY_S)
        _check_limits(c, r, d, plan)
        assert plan[0] == (pk.STREAM if min(c, r) <= pk.DOT_CENTRALITY_S
                           else pk.TILE)
        if plan[0] == pk.STREAM:
            slab = pk._stream_slab(d, plan[2])
            slabs = -(-d // slab)
            assert slabs > 1 and slabs <= plan[2]
            assert pk.centrality_scratch(c, r, d, plan)[0] == c * r
            assert min(c, r) * slab * 4 <= STREAM_SMEM
        kinds.add(plan[0])
    assert kinds == {pk.STREAM, pk.TILE}


def test_twenty_short_rows_of_internlm2_take_66_slabs():
    """20 short rows at d = 92544: 11 lane passes of 128 columns fit the
    112 KB (20 x 1408 x 4 = 110 KB), so 66 slabs, and a C x R scratch."""
    plan = pk.centrality_plan(2048, 20, 92544, SMS,
                              crossover=pk.DOT_CENTRALITY_S)
    assert plan[0] == pk.STREAM and pk._stream_slab(92544, plan[2]) == 1408
    assert -(-92544 // 1408) == 66
    assert pk.centrality_scratch(2048, 20, 92544, plan) == (2048 * 20, 1)


@pytest.mark.parametrize("d", VOCAB_WIDTHS)
def test_vocab_width_pairwise_shapes_fit(d):
    """dot_pairwise at k-medoids' shapes of n = 2048, k = 8 at d = V: the
    BUILD / SWAP rounds, the (n, k) cache and the (1, n) rows."""
    shapes = sorted(set(_rounds(2048, 16) + [(2048, 8), (1, 2048)]))
    for c, r in shapes:
        path, grid, splits = pk.pairwise_plan(c, r, d, SMS)
        assert 1 <= grid <= MAX_GRID and splits >= 1
        if path == pk.STREAM:
            slab = pk._stream_slab(d, splits)
            assert min(c, r) * min(slab, d) * 4 <= STREAM_SMEM
            assert -(-d // slab) <= splits
        else:
            assert 1 <= splits <= MAX_CLUSTER


# ------------------------------------------- dot_centrality's d split
@pytest.mark.parametrize("d", (92544, 32000))
def test_embedding_rounds_take_the_split(d):
    """Every dot_centrality launch of the embedding medoid at n = 2048
    (find_medoid's rounds at 20 pulls per arm, the k-medoids BUILD step and
    refinement buckets, the shard server's buckets at 24) plans the d split
    in fp32, with a (ranks, C, R) scratch of partial Grams and no partial
    rows (the second pass writes S); the bf16 mode and l1_centrality keep
    their unsplit plans."""
    shapes = sorted({s for n, b in ((2048, 20), (2048, 16), (256, 24),
                                    (512, 24)) for s in _rounds(n, b)}
                    | {s for nb in (64, 128, 256, 512, 1024)
                       for s in _rounds(nb, 20)})
    for c, r in shapes:
        plan = _dot_plan(c, r, d)
        assert plan[0] == (pk.STREAM_SPLIT if min(c, r) <= pk.DOT_CENTRALITY_S
                           else pk.TILE_SPLIT), (c, r, plan)
        ranks = plan[2]
        assert pk.centrality_scratch(c, r, d, plan) == (ranks * c * r, 1)
        x = torch.empty(c, 1)
        scratch, partial, out = pk._centrality_buffers("dot_centrality", x,
                                                       r, plan)
        assert scratch.numel() == ranks * c * r and partial is None
        assert out.shape == (c,)
        assert plan[1] <= (2 if plan[0] == pk.STREAM_SPLIT else 1) * SMS
        for other in (_dot_plan(c, r, d, "bfloat16"),
                      pk.centrality_plan(c, r, d, SMS)):
            assert other[0] in (pk.STREAM, pk.TILE)
            _check_limits(c, r, d, other)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_main_path_rounds_keep_their_plan_below_4096(dtype):
    """No round the tests enumerate below SPLIT_MIN_WIDTH = 32000 columns
    takes the split."""
    assert pk.SPLIT_MIN_WIDTH == 32000
    for c, r, d in _every_main_path_shape():
        if d < 32000:
            assert _dot_plan(c, r, d, dtype)[0] not in pk.SPLIT_PATHS, \
                (c, r, d)


def test_split_centrality_rejects_other_modes():
    x, y = torch.rand(4, 8), torch.rand(5, 8)
    plan = (pk.TILE_SPLIT, 2, 2)
    with pytest.raises(ValueError, match="no d split"):
        pk.launch_l1_centrality(x, y, None, plan)
    with pytest.raises(ValueError, match="no d split"):
        pk.launch_dot_centrality(x, y, None, None, None, plan, "cosine",
                                 "bfloat16")
