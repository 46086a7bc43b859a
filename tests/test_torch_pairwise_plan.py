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
