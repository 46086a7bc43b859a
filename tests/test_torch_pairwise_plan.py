"""The pairwise kernels' launch plan (``pairwise_plan``), a pure function
the CPU can hold: which path each shape takes, and that every grid, cluster
and shared-memory slab it asks for fits the H100's launch limits and the
checks ``csrc/pairwise_tile.cuh`` makes before it launches. The kernels
themselves run only on a card (``tests/test_torch_gpu.py``)."""
import pytest

from repro_torch.engine.schedule import round_schedule
from repro_torch.kernels import pairwise_distance as pk

pytestmark = pytest.mark.torch_port

SMS = 132                       # H100 SXM
MAX_GRID = 2 ** 31 - 1          # gridDim.x
MAX_CLUSTER = 8                 # portable cluster size
SMEM_BLOCK = 227 * 1024         # shared memory a block can use
TILE, BK = 32, 32               # T_TILE, T_BK
SLAB_ALIGN, STREAM_SMEM = 128, 112 * 1024   # S_SLAB_ALIGN, S_SMEM
N = 20000


def _round_shapes(budget_per_arm):
    return [(rd.survivors, rd.num_refs)
            for rd in round_schedule(N, budget_per_arm * N)]


# every round of a k-medoids halving (16 pulls per arm) and of a find_medoid
# call (30), the (1, n) rows, the (n, k <= 10) caches, and the corners
SHAPES = sorted(set(_round_shapes(16) + _round_shapes(30)
                    + [(1, N), (N, 1), (1, 1)]
                    + [(N, k) for k in range(1, 11)]
                    + [(k, N) for k in range(1, 11)]))
WIDTHS = (0, 1, 4, 257, 784, 1024, 4096, 28000)


def _stream_slab(m, d, splits):
    """The slab width the C launcher derives from ``splits``."""
    slab = -(-d // splits)
    slab = max(SLAB_ALIGN, -(-slab // SLAB_ALIGN) * SLAB_ALIGN)
    return min(slab, d)


def test_round_shapes_cover_both_sides_of_the_crossover():
    shorts = [min(c, r) for c, r in _round_shapes(16)]
    assert min(shorts) <= pk.PAIRWISE_S < max(shorts)


def _check_limits(c, r, d, path, grid, splits):
    assert 1 <= grid <= MAX_GRID and splits >= 1
    if path == pk.STREAM:
        m, n = min(c, r), max(c, r)
        assert grid <= 2 * SMS and (grid - 1) * 16 < n  # no idle block
        slab = _stream_slab(m, d, splits)
        assert m * slab * 4 <= STREAM_SMEM <= SMEM_BLOCK
        assert splits == 1 if d == 0 else -(-d // slab) <= splits
        return
    tiles = -(-c // TILE) * -(-r // TILE)
    slabs = max(1, -(-d // BK))
    assert 1 <= splits <= MAX_CLUSTER and grid == tiles * splits
    run = -(-slabs // splits)                 # slabs a rank sums
    assert (splits - 1) * run < slabs         # every rank has d columns


@pytest.mark.parametrize("c, r", SHAPES)
def test_plan_picks_the_path_and_fits_the_launch_limits(c, r):
    """The stream path exactly where min(C, R) <= PAIRWISE_S, and a grid,
    cluster and slab that the card and the C launcher accept, at every
    width from 1 to 28000 (and 0)."""
    for d in WIDTHS:
        path, grid, splits = pk.pairwise_plan(c, r, d, SMS)
        assert path == (pk.STREAM if min(c, r) <= pk.PAIRWISE_S
                        else pk.TILE), (c, r, d)
        _check_limits(c, r, d, path, grid, splits)
        forced = pk.pairwise_plan(c, r, d, SMS, crossover=0)
        assert forced[0] == pk.TILE
        _check_limits(c, r, d, *forced)


@pytest.mark.parametrize("budget_per_arm", (16, 30))
def test_middle_rounds_fill_the_card(budget_per_arm):
    """Each tile-path round of a halving at n = 20000 puts at least 100
    blocks on the 132 SMs (the old one-block-a-tile grid gave 9-40)."""
    for c, r in _round_shapes(budget_per_arm):
        path, grid, _ = pk.pairwise_plan(c, r, 784, SMS)
        if path == pk.TILE:
            assert grid >= 100, (c, r, grid)


def test_forced_paths_and_bad_crossovers():
    assert pk.pairwise_plan(157, 135, 784, SMS, crossover=0)[0] == pk.TILE
    assert pk.pairwise_plan(32, 5000, 784, SMS, crossover=32)[0] == \
        pk.STREAM
    assert pk.pairwise_plan(1, 1, 1, SMS, crossover=0) == (pk.TILE, 1, 1)
    for bad in (-1, 33):
        with pytest.raises(ValueError, match="crossover"):
            pk.pairwise_plan(4, 4, 4, SMS, crossover=bad)


def test_wide_short_rows_take_several_slabs():
    path, grid, splits = pk.pairwise_plan(16, 5000, 28000, SMS)
    assert path == pk.STREAM and splits > 1
    assert 16 * _stream_slab(16, 28000, splits) * 4 <= STREAM_SMEM


# ------------------------------------------------------------- gemm path
GEMM_TILE = 128                 # G_TILE
LIVE = (32768, 32768, 784)      # a live corpus's bootstrap square
GRAM_GEMM = pk.dot_gemm("float32")


def _gemm_limits(c, r, plan):
    path, grid, splits = plan
    tiles = -(-c // GEMM_TILE) * -(-r // GEMM_TILE)
    assert path == pk.GEMM and splits == 1
    assert 1 <= grid <= min(tiles, SMS) <= MAX_GRID   # persistent, no idle block


def test_dot_gemm_by_mode():
    """The fp32 Gram has a gemm path, the bf16 mode none; the fill that
    decides it is the tile path's 32-row-padded outputs over the gemm
    launch's 128 x 128 tile on each SM for each wave."""
    assert GRAM_GEMM is True
    assert pk.dot_gemm("bfloat16") is False
    with pytest.raises(ValueError, match="compute_dtype"):
        pk.dot_gemm("float16")
    assert pk.gemm_fill(1024, 1024, SMS) == 1024 ** 2 / (SMS * 128 ** 2)
    assert pk.gemm_fill(1000, 1000, SMS) == pk.gemm_fill(1024, 1024, SMS)
    # (256, 16384): 256 tiles, two waves of 132 slots
    assert pk.gemm_fill(256, 16384, SMS) == 256 * 16384 / (2 * SMS * 128 ** 2)


@pytest.mark.parametrize("c, r, d", (LIVE, (32768, 32768, 2048),
                                     (20000, 32768, 784), (2048, 2048, 92544),
                                     (49152, 49152, 16)))
def test_gram_squares_take_the_gemm_path(c, r, d):
    """The live corpus square (and a cosine square at d = 2048, a corpus
    before its first doubling, the embedding rows' 2048 x 92544 block and
    the 2^31-element block) plans "gemm" for dot_pairwise in fp32: one block
    an SM walking 128 x 128 tiles over all of d; l1_pairwise and the bf16
    mode keep the tile path. The block's offsets need 64 bits where C * R
    passes 2^31."""
    plan = pk.pairwise_plan(c, r, d, SMS, fp32_gram=GRAM_GEMM)
    _gemm_limits(c, r, plan)
    assert plan == (pk.GEMM, SMS, 1)
    for gemm in (False, pk.dot_gemm("bfloat16")):   # l1, bf16 mode
        plan = pk.pairwise_plan(c, r, d, SMS, fp32_gram=gemm)
        assert plan[0] == pk.TILE
        _check_limits(c, r, d, *plan)
    assert (c * r > 2 ** 31) == ((c, r) == (49152, 49152))


@pytest.mark.parametrize("c, r, want", (
        (512, 512, pk.TILE), (896, 896, pk.TILE), (1024, 1024, pk.GEMM),
        (1536, 1536, pk.GEMM), (2048, 2048, pk.GEMM), (4096, 512, pk.GEMM),
        (512, 4096, pk.GEMM), (160, 4096, pk.TILE), (192, 4096, pk.TILE),
        (256, 4096, pk.GEMM), (256, 3968, pk.GEMM), (64, 8192, pk.TILE),
        (128, 8192, pk.GEMM), (48, 16384, pk.GEMM), (24, 65536, pk.TILE),
        (255, 100000, pk.GEMM), (128, 128, pk.TILE)))
def test_gemm_crossover(c, r, want):
    """The gemm path where the tile path's padded outputs fill at least
    GEMM_FILL of the gemm launch's (0.36-0.37 at (896, 896) and (192,
    4096): tile; 0.48 at (1024, 1024), (256, 4096), (128, 8192) and (48,
    16384), whose 48 rows the tile path pads to 64: gemm); ``gemm_plan``,
    which forces the path, fits the launch limits at each."""
    plan = pk.pairwise_plan(c, r, 784, SMS, fp32_gram=GRAM_GEMM)
    assert plan[0] == want
    if want == pk.TILE:
        _check_limits(c, r, 784, *plan)
    _gemm_limits(c, r, pk.gemm_plan(c, r, SMS))


@pytest.mark.parametrize("c, r", SHAPES)
def test_round_shapes_keep_their_path(c, r):
    """No k-medoids or find_medoid round, cache or row takes the gemm
    path: dot_pairwise's plan at every width equals the plan without one,
    or that plan's d split."""
    unsplit = {pk.STREAM_SPLIT: pk.STREAM, pk.TILE_SPLIT: pk.TILE}
    for d in WIDTHS:
        plan = pk.pairwise_plan(c, r, d, SMS, fp32_gram=GRAM_GEMM)
        base = pk.pairwise_plan(c, r, d, SMS)
        assert plan == base or (plan[0] in pk.SPLIT_PATHS
                                and unsplit[plan[0]] == base[0]), (c, r, d)


# --------------------------------------------------------------- d split
EMBED_WIDTHS = (92544, 32000)              # internlm2-1.8b's V, zamba2's
MAX_RANKS = 2 ** 16 - 1                    # gridDim.y


def _embed_shapes():
    """The Gram launches of the embedding medoid at n = 2048 (chip_smoke.py's
    phases 8d and 10e): find_medoid's rounds (20 pulls per arm), k-medoids'
    BUILD and SWAP rounds (16), its (n, 8) cache and (1, n) row, and the
    shard server's buckets of 256 and 512 rows (24)."""
    return sorted(set(_rounds(2048, 20) + _rounds(2048, 16)
                      + _rounds(256, 24) + _rounds(512, 24)
                      + [(2048, 8), (1, 2048)]))


def _rounds(n, budget_per_arm):
    return [(rd.survivors, rd.num_refs)
            for rd in round_schedule(n, budget_per_arm * n)]


def _split_slab(m, run):
    """``split_slab`` of ``csrc/pairwise_tile.cuh``: the run in one buffer
    where it fits, else two buffers of half the budget."""
    if m * run * 4 <= STREAM_SMEM:
        return run
    return STREAM_SMEM // 2 // (m * 4 * SLAB_ALIGN) * SLAB_ALIGN


def _split_limits(c, r, d, plan):
    """A d-split plan's ranks: whole 256-column groups, none empty, each
    but the last at least its path's floor; its grid within one wave and
    the launch limits; the stream split's short-row buffers within the
    block's budget."""
    path, grid, ranks = plan
    assert path in pk.SPLIT_PATHS and 2 <= ranks <= MAX_RANKS
    run = pk.split_run(d, ranks)
    assert run % pk.SPLIT_GROUP == 0 and run >= pk.SPLIT_MIN_D[path]
    assert (ranks - 1) * run < d                  # every rank has columns
    assert pk.split_scratch(c, r, plan) == ranks * c * r
    if path == pk.STREAM_SPLIT:
        m, n = min(c, r), max(c, r)
        blocks = grid // ranks
        assert grid == blocks * ranks and grid <= 2 * SMS
        assert blocks == pk.pairwise_plan(c, r, d, SMS)[1]    # unsplit grid
        slab = _split_slab(m, run)
        assert slab % SLAB_ALIGN == 0 or slab == run
        assert (1 if slab == run else 2) * m * slab * 4 <= STREAM_SMEM
    else:
        tiles = -(-c // TILE) * -(-r // TILE)
        assert grid == tiles * ranks <= SMS
        assert ranks > pk.pairwise_plan(c, r, d, SMS)[2]      # its cluster


@pytest.mark.parametrize("d", EMBED_WIDTHS)
def test_embedding_rounds_take_the_split(d):
    """At the vocabulary-wide rows every Gram launch of phases 8d and 10e
    plans the d split for dot_pairwise in fp32 (the stream path's where its
    short side is at most PAIRWISE_S), within the limits; l1_pairwise and
    the bf16 mode keep their unsplit plans."""
    for c, r in _embed_shapes():
        plan = pk.pairwise_plan(c, r, d, SMS, fp32_gram=GRAM_GEMM)
        want = pk.STREAM_SPLIT if min(c, r) <= pk.PAIRWISE_S \
            else pk.TILE_SPLIT
        assert plan[0] == want, (c, r, plan)
        _split_limits(c, r, d, plan)
        bf16 = pk.dot_gemm("bfloat16")
        for unsplit in (pk.pairwise_plan(c, r, d, SMS),
                        pk.pairwise_plan(c, r, d, SMS, fp32_gram=bf16)):
            assert unsplit[0] in (pk.STREAM, pk.TILE)
            _check_limits(c, r, d, *unsplit)


@pytest.mark.parametrize("c, r", SHAPES)
def test_main_path_rounds_keep_their_plan(c, r):
    """Below SPLIT_MIN_WIDTH = 32000 columns no round, cache or row of
    find_medoid, k-medoids or serving takes the split (their Gram cells are
    at d = 784 and 2048)."""
    assert pk.SPLIT_MIN_WIDTH == 32000
    for d in WIDTHS + (2048, 4095, 31999):
        if d < 32000:
            plan = pk.pairwise_plan(c, r, d, SMS, fp32_gram=GRAM_GEMM)
            assert plan[0] not in pk.SPLIT_PATHS, (c, r, d)


@pytest.mark.parametrize("d", (2048, 4096, 8191, 32000, 92543, 92544,
                               262144))
@pytest.mark.parametrize("want", (1, 2, 3, 41, 132, 264, 70000))
@pytest.mark.parametrize("path", pk.SPLIT_PATHS)
def test_split_ranks_take_whole_groups(d, want, path):
    """``split_ranks`` gives at most ``want`` ranks and one per floor of
    columns; each rank's run is whole 256-column groups, and the last rank
    still has columns (as the C launcher checks)."""
    ranks = pk.split_ranks(d, want, path)
    assert 1 <= ranks <= max(1, min(want, d // pk.SPLIT_MIN_D[path]))
    assert ranks == 1 or d >= pk.SPLIT_MIN_WIDTH
    assert ranks <= MAX_RANKS
    if ranks > 1:
        run = pk.split_run(d, ranks)
        assert run % pk.SPLIT_GROUP == 0 and run >= pk.SPLIT_MIN_D[path]
        assert (ranks - 1) * run < d <= ranks * run


def test_split_plans_are_for_the_fp32_gram_only():
    """A forced split is a plan tuple like any other: the launchers reject
    it for l1_pairwise and for the bf16 mode before touching a device."""
    import torch

    x, y = torch.rand(4, 8), torch.rand(5, 8)
    plan = (pk.STREAM_SPLIT, 2, 2)
    with pytest.raises(ValueError, match="no d split"):
        pk.launch_pairwise("l1_pairwise", x, y, plan)
    with pytest.raises(ValueError, match="no d split"):
        pk.launch_pairwise("dot_pairwise", x, y, plan, "bfloat16")
