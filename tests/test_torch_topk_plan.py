"""``topk_smallest``'s launch plan (``topk_plan``) and its fp32 mode,
which the CPU can hold without a card:

* which path the plan gives Med-dit's selections (keep 64 of C = n), the
  halving's keep = C at every C of the main path, and its limits;
* the fp32 mode's plain counterpart (``totalorder_keys``, then
  ``topk_smallest_plain``) against JAX's ``lax.top_k(-theta, keep)[1]``,
  and the kernel's sign flip in registers against ``totalorder_keys``.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro_torch.engine.schedule import round_schedule
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as pk

pytestmark = pytest.mark.torch_port

SMS = 132                       # H100 SXM
MEDDIT = ((6424, 64), (20000, 64))
KEEPS = (1, 63, 64, 65, pk.SELECT_KEEP_LIMIT)


def _main_path_cs():
    """Every C the halving orders at keep = C on the main path: the rounds
    of find_medoid (30 pulls per arm) and k-medoids (16, 20) at the paper's
    n, and of the server's buckets (24) from 1024 to 32768."""
    cs = set()
    for n in (6424, 20000, 1024, 2048, 4096, 8192, 16384, 32768):
        for budget in (16, 20, 24, 30):
            cs |= {rd.survivors for rd in round_schedule(n, budget * n)}
    return sorted(cs)


def test_plan_takes_the_select_at_meddit_shapes():
    """One cluster of at most 8 blocks, the keys in registers: 1 a thread
    over 7 blocks at C = 6424, 3 over 7 at C = 20000."""
    for c, keep in MEDDIT:
        path, items, blocks = pk.topk_plan(c, keep, SMS)
        assert path == pk.SELECT and items > 0
        assert blocks <= pk.SELECT_MAX_CLUSTER
        assert c <= items * blocks * pk.SELECT_THREADS
    assert pk.topk_plan(6424, 64, SMS) == (pk.SELECT, 1, 7)
    assert pk.topk_plan(20000, 64, SMS) == (pk.SELECT, 3, 7)


@pytest.mark.parametrize("c", _main_path_cs())
def test_plan_sorts_the_halving(c):
    """keep = C keeps the sort path at every C of the main path, with the
    tile and cluster of ``topk_rank_plan``, as before the select path."""
    assert pk.topk_plan(c, c, SMS) == (pk.SORT,) + pk.topk_rank_plan(c, SMS)


def test_plan_limits():
    lo, sq = pk.SELECT_MIN_C, pk.SELECT_KEEP_SQ_PER_C
    assert sq < lo        # so keep = C and keep = ceil(C / 2) never select
    for keep in (1, 64, 128, 256, 512, pk.SELECT_KEEP_LIMIT):
        c = max(lo, -(-keep * keep // sq))
        assert pk.topk_plan(c, keep, SMS)[0] == pk.SELECT
        assert pk.topk_plan(c - 1, keep, SMS)[0] == pk.SORT
    assert pk.topk_plan(2 ** 20, pk.SELECT_KEEP_LIMIT + 1, SMS)[0] == pk.SORT
    assert pk.topk_plan(lo, 0, SMS)[0] == pk.SORT     # the rank-only mode
    assert pk.topk_plan(2 ** 20, 64, SMS) == (pk.SELECT, 0, 8)
    assert pk.topk_plan(2 ** 20, 2 ** 19, SMS)[0] == pk.SORT   # v2's halving
    for c in range(1, 4 * lo):
        assert pk.topk_plan(c, -(-c // 2), SMS)[0] == pk.SORT
    t = pk.SELECT_THREADS
    for n in (1, t, 2 * t, pk.SELECT_BLOCK_ITEMS * t):
        assert pk.select_plan(n)[2] == 1
    for cluster in range(1, pk.SELECT_MAX_CLUSTER + 1):
        for n in (pk.SELECT_BLOCK_ITEMS * t + 1, 6424, 20000,
                  16 * t * cluster, 16 * t * cluster + 1):
            path, items, blocks = pk.select_plan(n, cluster=cluster)
            if n > 16 * t * cluster:
                assert (items, blocks) == (0, cluster)
                continue
            assert items in pk.SELECT_ITEMS and 1 <= blocks <= cluster
            assert (blocks - 1) * items * t < n <= blocks * items * t
            fewer = [i for i in pk.SELECT_ITEMS if i < items]
            assert all(n > i * t * cluster for i in fewer)
    with pytest.raises(ValueError, match="cluster"):
        pk.select_plan(10, cluster=9)


def test_launch_checks_the_select_path():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown path"):
        pk.launch_topk(keys, 1, ("bogus", 1, 1))
    with pytest.raises(ValueError, match="select path"):
        pk.launch_topk(keys, 1, pk.select_plan(8), with_rank=True)
    with pytest.raises(TypeError):
        pk.topk_smallest_f32(keys, 1)
    with pytest.raises(TypeError):
        pk.topk_smallest(keys.float(), 1)


# ---------------------------------------------------------- the fp32 mode

def _ukey(theta_bits: np.ndarray) -> np.ndarray:
    """The kernel's ``ukey<true>``: a float's bits in the keys' unsigned
    order (b | 2^31 where b >= 0, else ~b)."""
    b = theta_bits.astype(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _edge_thetas(n: int, seed: int) -> np.ndarray:
    theta = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    theta[::7] = 0.0
    theta[::11] = -0.0
    theta[::13] = np.inf
    theta[::17] = -np.inf
    theta[::19] = np.nan
    theta[::23] = -np.nan
    theta[::5] = theta[0]
    return theta


@pytest.mark.parametrize("n", (1, 2, 64, 513, 6424))
def test_fp32_mode_plain_matches_lax_top_k(n):
    """``topk_smallest_f32`` on the CPU (``totalorder_keys``, then
    ``topk_smallest_plain``) is JAX's ``lax.top_k(-theta, keep)[1]`` on ties,
    +-0.0, +-inf and NaNs of both signs, and the kernel's sign flip in
    registers is ``totalorder_keys`` plus 2^31."""
    theta = _edge_thetas(n, n)
    tt = torch.from_numpy(theta)
    for keep in sorted({min(k, n) for k in KEEPS}):
        want = np.asarray(lax.top_k(-jnp.asarray(theta), keep)[1])
        got = pk.topk_smallest_f32(tt, keep)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            ops.kernel_topk_smallest(tt, keep=keep).numpy(), want)
    keys = pk.totalorder_keys(tt).numpy()
    np.testing.assert_array_equal(
        _ukey(theta.view(np.uint32)),
        keys.view(np.uint32) ^ np.uint32(0x80000000))
