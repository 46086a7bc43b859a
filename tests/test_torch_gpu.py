"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: the ``cuda`` fixture skips each test where no card exists
(decided inside the fixture, so every worker collects the same tests). On a
card: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_gpu.py`` (this file needs no JAX, which ``conftest.py``
imports). ``chip_smoke.py`` holds the kernels at the main path's full
shapes; these are the small cases.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.engine import rng
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as pk

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# l1_centrality's crossover (from the plan's constant) on both paths in both
# orientations, the skinny and middle rounds, and d % 4 != 0
SC = pk.CENTRALITY_S


@pytest.mark.parametrize("metric", ("l1", "l2", "sql2", "cosine"))
@pytest.mark.parametrize("shape", ((1, 1, 1), (77, 131, 300), (130, 65, 257),
                                   (2000, 3, 784), (3, 3000, 784),
                                   (5000, 2, 4096), (2, 5000, 4096),
                                   (SC, 3000, 1024), (3000, SC + 1, 1024),
                                   (SC + 1, 3000, 1024), (3000, SC, 1024),
                                   (157, 135, 784), (2000, 3, 783),
                                   (3, 2000, 1023), (40, 37, 257),
                                   (1029, 1031, 783)))
def test_centrality_kernels_match_plain(cuda, metric, shape):
    """With and without a random 0/1 reference mask, and on x as a
    contiguous view 4 bytes past a 16-byte boundary (``buf[1:].view(c,
    d)``, read 4 bytes at a time); two launches on the same input must be
    bit-equal. (1029, 1031, 783) takes dot_centrality's gemm path: ragged
    128-row tiles, d % 4 != 0."""
    c, r, d = shape
    g = torch.Generator(device=cuda).manual_seed(c * r + d)
    x = torch.rand(c, d, device=cuda, generator=g)
    y = torch.rand(r, d, device=cuda, generator=g)
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    xm = torch.rand(c * d + 1, device=cuda, generator=g)[1:].view(c, d)
    assert xm.data_ptr() % 16 != 0
    kern = "l1_centrality" if metric == "l1" else "dot_centrality"
    for xx in (x, xm):
        for mask in (None, w):
            before = pk.LAUNCHES.copy()
            got = ops.kernel_centrality_sums(xx, y, metric=metric,
                                             ref_mask=mask)
            again = ops.kernel_centrality_sums(xx, y, metric=metric,
                                               ref_mask=mask)
            want = ops.kernel_centrality_sums(xx.cpu(), y.cpu(),
                                              metric=metric,
                                              ref_mask=None if mask is None
                                              else mask.cpu())
            torch.cuda.synchronize()
            assert pk.LAUNCHES[kern] == before[kern] + 2
            assert torch.equal(got, again)
            # rtol 1e-5, floor 1e-5 of the largest sum, l2 self-pair
            # allowance
            tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
            if metric == "l2":
                tol = tol + 1e-3 * float(
                    torch.cat([xx, y]).norm(dim=1).max()) * r
            assert bool(((got.cpu() - want).abs() <= tol).all())


def _centrality_launch(metric, x, y, plan):
    """One forced-path launch of the centrality kernel for ``metric`` and
    its plain version on the same inputs (unit rows for cosine, squared
    norms for l2 and sql2)."""
    if metric == "l1":
        return (pk.launch_l1_centrality(x, y, None, plan),
                pk.l1_centrality_plain(x, y, None))
    if metric == "cosine":
        x, y, xn2, yn2 = ops._unit_rows(x), ops._unit_rows(y), None, None
    else:
        xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
    return (pk.launch_dot_centrality(x, y, xn2, yn2, None, plan, metric),
            pk.dot_centrality_plain(x, y, xn2, yn2, None, metric=metric))


@pytest.mark.parametrize("metric", ("l1", "l2", "sql2", "cosine"))
def test_centrality_both_paths_and_empty_sums(cuda, metric):
    """Each forced path (stream, tile and, for the Gram metrics, gemm)
    agrees with the plain version on each side of the kernel's crossover,
    at d = 2048 with 16 and 20 short rows (two d slabs on the stream path,
    running sums in the C x R scratch) and at d = 4096 (16 groups of 256
    columns on the gemm path); no self-pairs, so l2 needs no allowance; two
    launches are bit-equal, and C = 0, R = 0 and d = 0 give what the plain
    version gives."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(5)
    s = SC if metric == "l1" else pk.DOT_CENTRALITY_S
    for c, r, d in ((s, 3000, 1024), (3000, s + 1, 1024), (12, 12, 64),
                    (20, 2000, 2048), (2500, 16, 2048), (130, 300, 4096)):
        x = torch.rand(c, d, device=cuda, generator=g)
        y = torch.rand(r, d, device=cuda, generator=g)
        plans = [pk.centrality_plan(c, r, d, sms, crossover=forced)
                 for forced in (32, 0)]
        if metric != "l1":   # the Gram's gemm path, forced
            plans.append(pk.gemm_plan(c, r, sms))
        for plan in plans:
            got, want = _centrality_launch(metric, x, y, plan)
            again, _ = _centrality_launch(metric, x, y, plan)
            assert torch.equal(got, again), plan
            tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
            assert bool(((got - want).abs() <= tol).all()), plan
    for c, r, d in ((0, 5, 3), (5, 0, 3), (5, 7, 0)):
        x = torch.rand(c, d, device=cuda)
        y = torch.rand(r, d, device=cuda)
        got = ops.kernel_centrality_sums(x, y, metric=metric)
        want = ops.kernel_centrality_sums(x.cpu(), y.cpu(), metric=metric)
        assert got.shape == (c,)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _rank_keys(c, kind, g, device):
    """int32 rank keys: floats with ties, -0.0/+0.0, +-inf and NaNs of
    both signs; all-equal keys; or the int32 extremes with ties."""
    if kind == "floats":
        theta = torch.randn(c, device=device, generator=g)
        theta[::3] = 0.0
        theta[::5] = -0.0
        theta[::7] = float("inf")
        theta[::11] = -float("inf")
        theta[::13] = float("nan")
        theta[::17] = -float("nan")
        return ops.totalorder_keys(theta), theta
    if kind == "equal":
        return torch.full((c,), 7, dtype=torch.int32, device=device), None
    keys = torch.randint(-3, 3, (c,), device=device, generator=g,
                         dtype=torch.int32)
    keys[::3] = 2 ** 31 - 1
    keys[1::3] = -2 ** 31
    return keys, None


T = pk.RANK_TILE


@pytest.mark.parametrize("c", (1, 2, 129, 5000, T - 1, T, T + 1, 2 * T + 1,
                               20000))
def test_topk_kernels_bit_equal(cuda, c):
    g = torch.Generator(device=cuda).manual_seed(c)
    theta = torch.randn(c, device=cuda, generator=g)
    theta[::3] = 0.0
    theta[::5] = -0.0
    theta[::7] = float("inf")
    keys = ops.totalorder_keys(theta)
    rank = pk.topk_rank(keys)
    np.testing.assert_array_equal(rank.cpu().numpy(),
                                  pk.topk_rank_plain(keys.cpu()).numpy())
    for keep in sorted({1, c}):
        np.testing.assert_array_equal(
            ops.kernel_topk_smallest(theta, keep=keep).cpu().numpy(),
            torch.argsort(keys.cpu(), stable=True)[:keep].numpy())
    # NaNs of both signs and +-inf, all-equal keys, the int32 extremes
    for kind in ("floats", "equal", "extremes"):
        keys, theta = _rank_keys(c, kind, g, cuda)
        before = pk.LAUNCHES["topk_rank"]
        rank = pk.topk_rank(keys)
        torch.cuda.synchronize()
        assert pk.LAUNCHES["topk_rank"] == before + 1
        np.testing.assert_array_equal(rank.cpu().numpy(),
                                      pk.topk_rank_plain(keys.cpu()).numpy())
        np.testing.assert_array_equal(
            pk.topk_smallest(keys, c).cpu().numpy(),
            torch.argsort(keys.cpu(), stable=True).numpy())
        if theta is not None:
            np.testing.assert_array_equal(
                ops.kernel_topk_smallest(theta, keep=c).cpu().numpy(),
                torch.argsort(keys.cpu(), stable=True).numpy())


RANK_TILES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("c", (1, 2, 129, 5000, T - 1, T, T + 1, 2 * T + 1,
                               20000))
def test_topk_smallest_one_launch(cuda, c):
    """The fused launch at every tile of ``topk_rank_plan`` (with its
    cluster, and with 8-block clusters where the keys span several tiles)
    and keep in {1, C // 2, C}: bit-equal to ``argsort(stable=True)[:keep]``
    on floats with ties, -0.0/+0.0, +-inf and NaNs of both signs, on
    all-equal keys and on the int32 extremes; one launch each, counted under
    ``topk_smallest``; with a rank buffer the ranks equal the plain
    version's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(c + 3)
    plans = {pk.topk_rank_plan(c, sms, tile=t) for t in RANK_TILES}
    plans |= {(t, 8) for t, cl in plans if c > t and cl < 8}
    plans = {(pk.SORT,) + plan for plan in plans}
    for kind in ("floats", "equal", "extremes"):
        keys, _ = _rank_keys(c, kind, g, cuda)
        order = torch.argsort(keys.cpu(), stable=True)
        rank_want = pk.topk_rank_plain(keys.cpu())
        for keep in sorted({1, max(1, c // 2), c}):
            np.testing.assert_array_equal(
                pk.topk_smallest_plain(keys.cpu(), keep).numpy(),
                order[:keep].numpy())
            for plan in sorted(plans):
                before = pk.LAUNCHES.copy()
                out, rank = pk.launch_topk(keys, keep, plan)
                torch.cuda.synchronize()
                assert rank is None
                assert pk.LAUNCHES["topk_smallest"] == \
                    before["topk_smallest"] + 1
                assert pk.LAUNCHES["topk_rank"] == before["topk_rank"]
                np.testing.assert_array_equal(out.cpu().numpy(),
                                              order[:keep].numpy(),
                                              err_msg=f"{kind} {plan} {keep}")
                out, rank = pk.launch_topk(keys, keep, plan, with_rank=True)
                np.testing.assert_array_equal(out.cpu().numpy(),
                                              order[:keep].numpy())
                np.testing.assert_array_equal(rank.cpu().numpy(),
                                              rank_want.numpy())
        before = pk.LAUNCHES["topk_smallest"]
        np.testing.assert_array_equal(
            pk.topk_smallest(keys, c).cpu().numpy(), order.numpy())
        assert pk.LAUNCHES["topk_smallest"] == before + 1
    assert pk.topk_smallest(keys, 0).shape == (0,)     # no launch
    with pytest.raises(ValueError):
        pk.launch_topk(keys, 0, (pk.SORT,) + pk.topk_rank_plan(c, sms))


SELECT_CS = (1, 2, 64, 513, 6424, 20000, 2 ** 20)


@pytest.mark.parametrize("c", SELECT_CS)
def test_topk_select_path_bit_equal(cuda, c):
    """The select path, forced at every C (the plan's cluster and a single
    block, which past 16384 keys reads them from device memory each pass),
    against ``argsort(stable=True)[:keep]`` and the sort path for keep in
    {1, 63, 64, 65, 256, SELECT_KEEP_LIMIT} (those <= C):
    floats with ties, -0.0/+0.0,
    +-inf and NaNs of both signs, all-equal keys and the int32 extremes;
    the fp32 mode (float estimates in, the keys made in registers) equal to
    the int32 launch on ``totalorder_keys`` on both paths; two launches
    bit-equal; one launch each, counted by path."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(c + 11)
    plans = [pk.select_plan(c), pk.select_plan(c, cluster=1),
             (pk.SORT,) + pk.topk_rank_plan(c, sms)]
    keeps = sorted({min(k, c) for k in (1, 63, 64, 65, 256,
                                        pk.SELECT_KEEP_LIMIT)})
    for kind in ("floats", "equal", "extremes"):
        keys, theta = _rank_keys(c, kind, g, cuda)
        order = torch.argsort(keys, stable=True).cpu()
        for keep in keeps:
            for plan in plans:
                before = pk.PATH_LAUNCHES.copy()
                out, rank = pk.launch_topk(keys, keep, plan)
                again, _ = pk.launch_topk(keys, keep, plan)
                torch.cuda.synchronize()
                assert rank is None
                assert pk.PATH_LAUNCHES[("topk_smallest", plan[0])] == \
                    before[("topk_smallest", plan[0])] + 2
                np.testing.assert_array_equal(
                    out.cpu().numpy(), order[:keep].numpy(),
                    err_msg=f"{kind} {plan} keep={keep}")
                assert torch.equal(out, again)
                if theta is not None:
                    f32, _ = pk.launch_topk(theta, keep, plan)
                    assert torch.equal(f32, out), (kind, plan, keep)


def test_topk_wrappers_count_by_path(cuda):
    """``topk_smallest`` and ``kernel_topk_smallest`` (the fp32 mode) launch
    once each on the plan's path: the select at Med-dit's keep 64 of C = n,
    the sort at the halving's keep = C."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(5)
    for c, keep in ((6424, 64), (20000, 64), (20000, 20000), (313, 313)):
        theta = torch.randn(c, device=cuda, generator=g)
        keys = ops.totalorder_keys(theta)
        path = pk.topk_plan(c, keep, sms)[0]
        assert path == (pk.SELECT if keep == 64 else pk.SORT)
        want = torch.argsort(keys, stable=True)[:keep]
        pk.reset_launches()
        got = pk.topk_smallest(keys, keep)
        got32 = ops.kernel_topk_smallest(theta, keep=keep)
        torch.cuda.synchronize()
        assert pk.LAUNCHES == {"topk_smallest": 2}
        assert pk.PATH_LAUNCHES == {("topk_smallest", path): 2}
        assert torch.equal(got, want) and torch.equal(got32, want)


def test_find_medoid_on_card_matches_cpu(cuda):
    x = np.random.default_rng(0).standard_normal((600, 40)).astype(np.float32)
    for backend in ("pallas_fused", "pallas_fused_topk"):
        pk.reset_launches()
        got = tapi.find_medoid(x, rng.key(4, cuda), backend=backend,
                               metric="l1", device=cuda)
        assert pk.LAUNCHES["l1_centrality"] == len(got.rounds)
        want = tapi.find_medoid(x, rng.key(4), backend=backend, metric="l1",
                                device="cpu")
        assert got.medoid == want.medoid


# both sides of the stream/tile crossover (from the plan's constant), the
# middle rounds of a k-medoids halving at n = 20000, and d % 4 != 0
S = pk.PAIRWISE_S
DS = pk.DOT_CENTRALITY_S
DB = pk.DOT_CENTRALITY_BF16_S


@pytest.mark.parametrize("shape", ((1, 1, 1), (77, 131, 300), (1, 3000, 784),
                                   (3000, 1, 784), (2000, 10, 257),
                                   (S, 20000, 784), (S + 1, 5000, 784),
                                   (157, 135, 784), (1250, 17, 784),
                                   (17, 1250, 784), (3000, 3, 257),
                                   (1029, 1031, 783), (1100, 1030, 4096)))
@pytest.mark.parametrize("offset", (0, 1))
def test_pairwise_kernels_match_plain(cuda, shape, offset):
    """offset 1: x is a contiguous view 4 bytes past a 16-byte boundary,
    ``buf[1:].view(c, d)``, which the kernels must read 4 bytes at a time.
    Two launches on the same input must be bit-equal. The last two shapes
    take dot_pairwise's gemm path (ragged tiles, d % 4 != 0, 16 groups of
    256 columns)."""
    c, r, d = shape
    g = torch.Generator(device=cuda).manual_seed(c + r + d)
    x = torch.randn(c * d + offset, device=cuda, generator=g)[offset:]
    x = x.view(c, d)
    y = torch.randn(r, d, device=cuda, generator=g)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    for name, kern, plain in (
            ("dot_pairwise", pk.dot_pairwise, pk.dot_pairwise_plain),
            ("l1_pairwise", pk.l1_pairwise, pk.l1_pairwise_plain)):
        before = pk.LAUNCHES[name]
        got = kern(x, y)
        again = kern(x, y)
        want = plain(x, y)
        torch.cuda.synchronize()
        assert pk.LAUNCHES[name] == before + 2
        assert torch.equal(got, again), name
        # rtol 1e-5 with a floor of 1e-5 of the largest magnitude
        tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all()), name


@pytest.mark.parametrize("shape", ((300, 257, 784), (1, 1, 1), (129, 130, 4096),
                                   (1000, 1000, 783), (5, 200, 0)))
@pytest.mark.parametrize("offset", (0, 1))
def test_gemm_path_matches_plain(cuda, shape, offset):
    """dot_pairwise's and dot_centrality's gemm path, forced at any shape:
    ragged tiles, d % 4 != 0, a view 4 bytes past a 16-byte boundary, 16
    groups of 256 columns and d = 0 (zeros); l2, sql2 and cosine with and
    without weights; two launches bit-equal; within the tolerances of
    chip_smoke.py's ``_tolerance`` (rtol 1e-5 with a floor of 1e-5 of the
    largest value, and the l2 self-pair allowance: y's first rows are x's)."""
    c, r, d = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pk.gemm_plan(c, r, sms)
    g = torch.Generator(device=cuda).manual_seed(c + r + d)
    x = torch.randn(c * d + offset, device=cuda, generator=g)[offset:]
    x = x.view(c, d)
    y = torch.randn(r, d, device=cuda, generator=g)
    y[:3] = x[:3]
    before = pk.LAUNCHES.copy()
    paths = pk.PATH_LAUNCHES.copy()
    got = pk.launch_pairwise("dot_pairwise", x, y, plan)
    assert torch.equal(got, pk.launch_pairwise("dot_pairwise", x, y, plan))
    want = pk.dot_pairwise_plain(x, y)
    assert bool(((got - want).abs()
                 <= 1e-5 * want.abs() + 1e-5 * want.abs().max()).all())
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    for metric in ("l2", "sql2", "cosine"):
        if metric == "cosine":
            xk, yk, xn2, yn2 = ops._unit_rows(x), ops._unit_rows(y), None, \
                None
        else:
            xk, yk, xn2, yn2 = x, y, ops._norms_sq(x), ops._norms_sq(y)
        for mask in (None, w):
            got = pk.launch_dot_centrality(xk, yk, xn2, yn2, mask, plan,
                                           metric)
            again = pk.launch_dot_centrality(xk, yk, xn2, yn2, mask, plan,
                                             metric)
            want = pk.dot_centrality_plain(xk, yk, xn2, yn2, mask,
                                           metric=metric)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (metric, mask is None)
            tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
            if metric == "l2":
                refs = r if mask is None else float(mask.sum())
                tol = tol + 1e-3 * float(
                    torch.cat([x, y]).norm(dim=1).max()) * refs
            assert bool(((got - want).abs() <= tol).all()), \
                (metric, mask is None)
    assert pk.LAUNCHES["dot_pairwise"] == before["dot_pairwise"] + 2
    assert pk.LAUNCHES["dot_centrality"] == before["dot_centrality"] + 12
    assert pk.PATH_LAUNCHES - paths == Counter({
        ("dot_pairwise", pk.GEMM): 2, ("dot_centrality", pk.GEMM): 12})


# the fp32 Gram kernels' d split: rounds of the embedding medoid at the
# vocabulary widths of internlm2-1.8b and zamba2-2.7b (stream and tile
# splits, both orientations, C- and R-short second passes), d % 4 != 0
SPLIT_SHAPES = ((2048, 1, 92544), (1, 2048, 92544), (2048, 8, 92544),
                (256, 14, 92544), (16, 232, 92544), (32, 116, 92544),
                (128, 29, 92544), (64, 21, 92544), (8, 96, 92544),
                (2, 1861, 32000), (128, 29, 32000), (16, 48, 32000),
                (256, 14, 92543), (32, 116, 92543))


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("offset", (0, 1))
def test_split_path_matches_plain(cuda, shape, offset):
    """dot_pairwise and dot_centrality (l2, sql2, cosine; with and without
    a mask) through their wrappers take the d split at these shapes, agree
    with the plain versions (rtol 1e-5, a floor of 1e-5 of the largest
    value, the l2 allowance), two launches bit-equal; the forced unsplit
    plan agrees within the same tolerance; ``PATH_LAUNCHES`` counts the
    launches by path. offset 1: x starts 4 bytes past a 16-byte boundary."""
    c, r, d = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(c + r + d)
    x = torch.rand(c * d + offset, device=cuda, generator=g)[offset:]
    x = x.view(c, d)
    y = torch.rand(r, d, device=cuda, generator=g)
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    w[0] = 1.0
    plan = pk.pairwise_plan(c, r, d, sms, fp32_gram=True)
    unsplit = pk.pairwise_plan(c, r, d, sms)
    assert plan[0] in pk.SPLIT_PATHS and unsplit[0] not in pk.SPLIT_PATHS
    paths = pk.PATH_LAUNCHES.copy()
    got, again = pk.dot_pairwise(x, y), pk.dot_pairwise(x, y)
    want = pk.dot_pairwise_plain(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
    for out in (got, pk.launch_pairwise("dot_pairwise", x, y, unsplit)):
        assert bool(((out - want).abs() <= tol).all())
    cplan = pk.centrality_plan(c, r, d, sms, crossover=DS, fp32_gram=True)
    cun = pk.centrality_plan(c, r, d, sms, crossover=DS)
    assert cplan[0] in pk.SPLIT_PATHS
    for metric in ("l2", "sql2", "cosine"):
        if metric == "cosine":
            xk, yk, xn2, yn2 = ops._unit_rows(x), ops._unit_rows(y), None, \
                None
        else:
            xk, yk, xn2, yn2 = x, y, ops._norms_sq(x), ops._norms_sq(y)
        for mask in (None, w):
            got = ops.kernel_centrality_sums(x, y, metric=metric,
                                             ref_mask=mask)
            again = ops.kernel_centrality_sums(x, y, metric=metric,
                                               ref_mask=mask)
            forced = pk.launch_dot_centrality(xk, yk, xn2, yn2, mask, cun,
                                              metric)
            want = pk.dot_centrality_plain(xk, yk, xn2, yn2, mask,
                                           metric=metric)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (metric, mask is None)
            tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
            if metric == "l2":
                refs = r if mask is None else float(mask.sum())
                tol = tol + 1e-3 * float(
                    torch.cat([x, y]).norm(dim=1).max()) * refs
            for out in (got, forced):
                assert bool(((out - want).abs() <= tol).all()), \
                    (metric, mask is None)
    assert pk.PATH_LAUNCHES - paths == Counter({
        ("dot_pairwise", plan[0]): 2, ("dot_pairwise", unsplit[0]): 1,
        ("dot_centrality", cplan[0]): 12, ("dot_centrality", cun[0]): 6})


def test_kmedoids_on_card_matches_cpu(cuda):
    from repro_torch.data.medoid_datasets import planted_clusters

    x, _ = planted_clusters(0, 600, 24, 4)
    for backend, metric in (("pallas_fused", "l2"),
                            ("pallas_fused_topk", "l1"),
                            ("pallas_pairwise", "cosine")):
        pk.reset_launches()
        got = tapi.kmedoids(x, 4, rng.key(6, cuda), backend=backend,
                            metric=metric, device=cuda)
        pair = "l1_pairwise" if metric == "l1" else "dot_pairwise"
        assert pk.LAUNCHES[pair] > 0
        want = tapi.kmedoids(x, 4, rng.key(6), backend=backend,
                             metric=metric, device="cpu")
        assert (got.medoids, got.swaps, got.pulls) == \
            (want.medoids, want.swaps, want.pulls)
        np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("metric", ("l2", "sql2", "cosine"))
@pytest.mark.parametrize("shape", ((1, 1, 1), (77, 131, 300), (2000, 3, 784),
                                   (3, 3000, 784), (20, 2000, 2048),
                                   (2500, 16, 2048), (2000, 3, 783),
                                   (DS, 3000, 784), (3000, DS + 1, 784),
                                   (DB, 3000, 784), (3000, DB + 1, 784),
                                   (157, 135, 784)))
def test_bf16_centrality_matches_plain(cuda, metric, shape):
    """``dot_centrality``'s bf16 mode on both forced paths, with and without
    a random 0/1 reference mask: within rtol 1e-5 (floor 1e-5 of the
    largest sum; the products of bf16 values are exact in fp32, so only the
    summation order differs), two launches bit-equal, counted under
    ``dot_centrality_bf16``."""
    c, r, d = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(c * r + d + 1)
    x0 = torch.rand(c, d, device=cuda, generator=g)
    y0 = torch.rand(r, d, device=cuda, generator=g)
    if metric == "cosine":
        x, y, xn2, yn2 = ops._unit_rows(x0), ops._unit_rows(y0), None, None
    else:
        x, y, xn2, yn2 = x0, y0, ops._norms_sq(x0), ops._norms_sq(y0)
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    for mask in (None, w):
        want = pk.dot_centrality_plain(x, y, xn2, yn2, mask, metric=metric,
                                       compute_dtype="bfloat16")
        tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        for forced in (32, 0):
            plan = pk.centrality_plan(c, r, d, sms, crossover=forced)
            before = pk.LAUNCHES.copy()
            got, again = (pk.launch_dot_centrality(
                x, y, xn2, yn2, mask, plan, metric, "bfloat16")
                for _ in range(2))
            torch.cuda.synchronize()
            assert pk.LAUNCHES["dot_centrality_bf16"] == \
                before["dot_centrality_bf16"] + 2
            assert pk.LAUNCHES["dot_centrality"] == before["dot_centrality"]
            assert torch.equal(got, again), plan
            assert bool(((got - want).abs() <= tol).all()), plan
        # the wrapper's own plan, through kernel_centrality_sums' glue
        got = ops.kernel_centrality_sums(x0, y0, metric=metric,
                                         ref_mask=mask,
                                         compute_dtype="bfloat16")
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("shape", ((1, 1, 1), (77, 131, 300), (1, 3000, 784),
                                   (3000, 1, 784), (2000, 10, 257),
                                   (S, 20000, 784), (S + 1, 5000, 784),
                                   (157, 135, 784)))
def test_bf16_dot_pairwise_matches_plain(cuda, shape):
    """``dot_pairwise``'s bf16 mode on both forced paths: within rtol 1e-5
    of the plain version (floor 1e-5 of the largest magnitude), two
    launches bit-equal, counted under ``dot_pairwise_bf16``."""
    c, r, d = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(c + r + d + 2)
    x = torch.randn(c, d, device=cuda, generator=g)
    y = torch.randn(r, d, device=cuda, generator=g)
    want = pk.dot_pairwise_plain(x, y, compute_dtype="bfloat16")
    tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
    for forced in (32, 0):
        plan = pk.pairwise_plan(c, r, d, sms, crossover=forced)
        before = pk.LAUNCHES["dot_pairwise_bf16"]
        got, again = (pk.launch_pairwise("dot_pairwise", x, y, plan,
                                         "bfloat16") for _ in range(2))
        torch.cuda.synchronize()
        assert pk.LAUNCHES["dot_pairwise_bf16"] == before + 2
        assert torch.equal(got, again), plan
        assert bool(((got - want).abs() <= tol).all()), plan
    got = pk.dot_pairwise(x, y, compute_dtype="bfloat16")
    assert bool(((got - want).abs() <= tol).all())


def test_find_medoid_quantized_on_card_matches_cpu(cuda):
    """The quantized path on the card: the bf16 fused cells launch the bf16
    ``dot_centrality`` once per executed round (none in the probe or the
    check) and answer as the CPU does."""
    x = np.random.default_rng(1).standard_normal((3000, 64)) \
        .astype(np.float32)
    for precision, backend, metric, kern in (
            ("bf16", "pallas_fused", "l2", "dot_centrality_bf16"),
            ("bf16", "pallas_fused_topk", "cosine", "dot_centrality_bf16"),
            ("bf16", "pallas_fused", "l1", "l1_centrality"),
            ("int8", "pallas_fused", "sql2", None)):
        pk.reset_launches()
        got = tapi.find_medoid(x, rng.key(7, cuda), backend=backend,
                               metric=metric, precision=precision,
                               device=cuda)
        want = tapi.find_medoid(x, rng.key(7), backend=backend,
                                metric=metric, precision=precision,
                                device="cpu")
        assert got.verified is True
        want_launches = {kern: len(got.rounds)} if kern else {}
        assert dict(pk.LAUNCHES) == want_launches, metric
        assert (got.medoid, got.pulls) == (want.medoid, want.pulls)


def _widened_shapes():
    """The (C, R) shapes of the quantized path's widened rounds at n = 20000
    and 30 pulls per arm: each band's buffer width by each t_r, and the
    output round (PERF.md, section 4)."""
    from repro_torch.engine.halving import WIDEN_SLACK
    from repro_torch.engine.schedule import Schedule

    n = 20000
    sched = Schedule.from_budget(n, 30 * n)
    stk = sched.stacked(n, slack=WIDEN_SLACK)
    shapes = [(band.width, t) for band in stk.bands for t in band.num_refs]
    out = (min(n, WIDEN_SLACK * stk.sizes[stk.r_stop]),
           sched[stk.r_stop].num_refs)
    return sorted(set(shapes + [out]))


def _bf16_inputs(metric, c, r, d, g, device):
    """Random rows (unit rows for cosine) and the squared norms of the
    unrounded rows (None for cosine), and a random 0/1 reference mask."""
    x = torch.rand(c, d, device=device, generator=g)
    y = torch.rand(r, d, device=device, generator=g)
    w = (torch.rand(r, device=device, generator=g) > 0.3).float()
    if metric == "cosine":
        return ops._unit_rows(x), ops._unit_rows(y), None, None, w
    return x, y, ops._norms_sq(x), ops._norms_sq(y), w


BF16_CELLS = (("l2", 784), ("cosine", 2048))


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("metric, d", BF16_CELLS)
def test_bf16_stream_path_bit_equal_to_fp32_on_rounded_rows(cuda, metric, d,
                                                            masked):
    """At each widened round shape the stream path can take (at most 32
    short rows), the bf16 mode rounds each value once where it is staged and
    then does the fp32 mode's operations in its order: bit-equal to the
    fp32 mode on rows rounded to bf16 beforehand, under the same plan, with
    the norms of the unrounded rows; two launches bit-equal."""
    shapes = _widened_shapes()
    assert len(shapes) == 15
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(d + masked)
    taken = 0
    for c, r in shapes:
        if min(c, r) > 32:
            continue
        x, y, xn2, yn2, w = _bf16_inputs(metric, c, r, d, g, cuda)
        w = w if masked else None
        xr, yr = x.bfloat16().float(), y.bfloat16().float()
        plan = pk.centrality_plan(c, r, d, sms, crossover=32)
        assert plan[0] == pk.STREAM
        got, again = (pk.launch_dot_centrality(x, y, xn2, yn2, w, plan,
                                               metric, "bfloat16")
                      for _ in range(2))
        want = pk.launch_dot_centrality(xr, yr, xn2, yn2, w, plan, metric)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (c, r)
        assert torch.equal(got, want), (c, r, float((got - want).abs().max()))
        taken += 1
    assert taken == 8


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("metric, d", BF16_CELLS)
def test_bf16_tile_path_within_tolerance(cuda, metric, d, masked):
    """The tile path (tensor-core products of the rows rounded once a slab)
    at every widened round shape, and at d % 4 != 0 on three of them:
    within rtol 1e-5 of the plain version with a floor of 1e-5 of the
    largest sum, two launches bit-equal."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(d + masked + 7)
    shapes = [(c, r, d) for c, r in _widened_shapes()]
    shapes += [(5000, 32, d - 1), (626, 254, d - 3), (80, 2000, d - 2)]
    for c, r, dd in shapes:
        x, y, xn2, yn2, w = _bf16_inputs(metric, c, r, dd, g, cuda)
        w = w if masked else None
        plan = pk.centrality_plan(c, r, dd, sms, crossover=0)
        assert plan[0] == pk.TILE
        got, again = (pk.launch_dot_centrality(x, y, xn2, yn2, w, plan,
                                               metric, "bfloat16")
                      for _ in range(2))
        want = pk.dot_centrality_plain(x, y, xn2, yn2, w, metric=metric,
                                       compute_dtype="bfloat16")
        torch.cuda.synchronize()
        assert torch.equal(got, again), (c, r, dd)
        tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        err = (got - want).abs()
        assert bool((err <= tol).all()), (c, r, dd, float(err.max()))


# ------------------------- the live corpus's shapes --------------------------
# A corpus of cap slots bootstraps with one (cap, cap) pairwise block and
# prices each mutation with one (1, cap) row (repro_torch.engine.programs).

def _block_close(got, want, what, rows=4096):
    """rtol 1e-5 with a floor of 1e-5 of the largest magnitude, a block of
    rows at a time (the big blocks' temporaries stay small)."""
    top = float(want.abs().max())
    for r0 in range(0, want.shape[0], rows):
        w = want[r0:r0 + rows]
        tol = 1e-5 * w.abs() + 1e-5 * top
        assert bool(((got[r0:r0 + rows] - w).abs() <= tol).all()), \
            f"{what}: rows {r0}.."


@pytest.mark.parametrize("cap", (3000, 4096, 32768))
@pytest.mark.parametrize("rows", ("square", "row"))
def test_corpus_pairwise_shapes_match_plain(cuda, cap, rows):
    """dot_pairwise (with its l2 and cosine epilogues) at d = 784 and
    l1_pairwise at d = 64 on the bootstrap square and on a mutation row;
    two launches bit-equal. dot_pairwise takes the gemm path on the squares
    (3000: ragged 128-row tiles), the stream path on the rows."""
    g = torch.Generator(device=cuda).manual_seed(cap)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name, d in (("dot_pairwise", 784), ("l1_pairwise", 64)):
        y = torch.rand(cap, d, device=cuda, generator=g)
        x = y if rows == "square" else y[cap // 3:cap // 3 + 1]
        if name == "dot_pairwise":
            path = pk.pairwise_plan(x.shape[0], cap, d, sms,
                                    fp32_gram=pk.dot_gemm("float32"))[0]
            assert path == (pk.GEMM if rows == "square" else pk.STREAM)
        kern = pk.dot_pairwise if name == "dot_pairwise" else pk.l1_pairwise
        plain = (pk.dot_pairwise_plain if name == "dot_pairwise"
                 else pk.l1_pairwise_plain)
        before = pk.LAUNCHES[name]
        got = kern(x, y)
        assert torch.equal(got, kern(x, y))
        assert pk.LAUNCHES[name] == before + 2
        want = plain(x, y)
        _block_close(got, want, f"{name} ({x.shape[0]}, {cap}, {d})")
        del got
        if name != "dot_pairwise" or x.shape[0] * cap > 2 ** 28:
            continue          # the epilogues are torch code: smaller blocks
        # the epilogues, from the Gram's tolerance e: a square within 2e
        # (and the norms' own rounding) of the plain one, its root within
        # the roots of that interval, cosine within e over the norms'
        # product
        e = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        x2, y2 = ops._norms_sq(x), ops._norms_sq(y)
        sq = torch.clamp_min(x2[:, None] + y2[None, :] - 2 * want, 0)
        e_sq = 2 * e + 1e-5 * (x2[:, None] + y2[None, :])
        l2 = torch.sqrt(sq)
        e_l2 = torch.maximum(torch.sqrt(sq + e_sq) - l2,
                             l2 - torch.sqrt(torch.clamp_min(sq - e_sq, 0)))
        for metric, ref, tol in (("l2", l2, e_l2), ("cosine", None, None)):
            out = ops.pairwise_kernel(metric)(x, y)
            if metric == "cosine":
                den = torch.sqrt(x2)[:, None] * torch.sqrt(y2)[None, :]
                ref, tol = 1 - want / den, e / den + 1e-6
            assert bool(((out - ref).abs() <= tol).all()), metric
            del out


def test_pairwise_block_past_two_to_the_31(cuda):
    """A (49152, 49152) l1 block has 2.4e9 > 2^31 elements: 64-bit output
    offsets. Its first and last rows against the plain version of those
    rows; two launches bit-equal."""
    n, d = 49152, 16
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.rand(n, d, device=cuda, generator=g)
    got = pk.l1_pairwise(x, x)
    assert got.numel() > 2 ** 31
    for r0 in (0, n - 256, n // 2):
        want = pk.l1_pairwise_plain(x[r0:r0 + 256], x)
        _block_close(got[r0:r0 + 256], want, f"rows {r0}")
    tail = got[-3:].clone()
    del got
    again = pk.l1_pairwise(x, x)
    assert torch.equal(again[-3:], tail)


def test_maintained_medoid_on_card_matches_cpu(cuda):
    """The same mutation stream on the card (pallas_fused: the pairwise
    kernels for the bootstrap and the rows, dot_centrality for re-runs)
    and on the CPU (their plain versions): equal updates at every version,
    and centralities within rtol 1e-5 plus the l2 self-pair allowance."""
    from repro_torch.serve import CorpusStore, MaintainedMedoid

    rs = np.random.default_rng(8)
    pts = rs.standard_normal((300, 8)).astype(np.float32)
    mms = [MaintainedMedoid(CorpusStore.from_points(
        pts, backend="pallas_fused", device=dev), budget_per_arm=64, seed=3)
        for dev in (cuda, "cpu")]
    for step in range(60):
        if step % 20 == 10:
            slot = mms[1].query()[0]
            assert mms[0].query()[0] == slot
            ups = [m.delete(slot) for m in mms]
        elif rs.random() < 0.7:
            x = rs.standard_normal(8).astype(np.float32)
            ups = [m.insert(x) for m in mms]
        else:
            slot = int(rs.choice(mms[1].store.live_slots()))
            ups = [m.delete(slot) for m in mms]
        assert ups[0] == ups[1], step
        live = mms[1].store.live_slots()
        got = mms[0].store.cent.cpu().numpy()[live]
        want = mms[1].store.cent.numpy()[live]
        tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max() \
            + 1e-3 * np.linalg.norm(pts, axis=1).max()
        assert (np.abs(got - want) <= tol).all(), step
    assert mms[0].stats() == mms[1].stats()


@pytest.mark.parametrize("k", (1, 2, 7, 1000))
def test_threefry_draws_bit_equal_to_plain(cuda, k):
    """One launch of ``threefry.cu`` against the plain loop of split and
    randint (on the CPU: integer arithmetic, the same bits), B = 64, for
    spans below and above 2**16 and several keys (one key at k = 1000)."""
    from repro_torch.kernels.threefry import (threefry_draws,
                                              threefry_draws_plain)

    for seed in ((0, 7, 2 ** 32 - 1) if k < 1000 else (5,)):
        key = rng.fold_in(rng.key(seed), 3)
        for n in (2, 6424, 20000, 70000):
            before = pk.LAUNCHES["threefry"]
            subs, nxt, refs = threefry_draws(key.to(cuda), k, 64, n)
            torch.cuda.synchronize()
            assert pk.LAUNCHES["threefry"] == before + 1
            psubs, pnxt, prefs = threefry_draws_plain(key, k, 64, n)
            assert refs.dtype == torch.int32 and refs.shape == (k, 64)
            assert torch.equal(refs.cpu(), prefs), (seed, n)
            assert torch.equal(subs.cpu(), psubs)
            assert torch.equal(nxt.data.cpu(), pnxt.data)


@pytest.mark.parametrize("metric", ("l1", "l2", "cosine"))
def test_meddit_graph_matches_eager_and_cpu(cuda, metric):
    """A capped Med-dit run (a few chunks) on the captured graph with the
    kernel's draws, the same run eagerly on the plain draws, and on the
    CPU: bit-equal medoid, pulls and means (integer rows, so every paired
    distance is exact in any summation order). The graph run launches
    threefry once a chunk and topk_smallest once a step."""
    from repro_torch.core.meddit import meddit_medoid

    x = torch.from_numpy(np.random.default_rng(4).integers(
        -3, 4, (3000, 24)).astype(np.float32))
    kw = dict(metric=metric, max_pulls=3000 + 64 * 300, chunk=64)
    before = pk.LAUNCHES.copy()
    before_paths = pk.PATH_LAUNCHES.copy()
    g = meddit_medoid(x.to(cuda), rng.key(2, cuda), graph=True, **kw)
    torch.cuda.synchronize()
    steps = (int(g.pulls) - 3000) // 64
    chunks = -(-steps // 64)
    assert 0 < steps <= 300
    assert pk.LAUNCHES["threefry"] == before["threefry"] + chunks
    assert pk.LAUNCHES["topk_smallest"] == before["topk_smallest"] \
        + 64 * chunks
    # every selection (keep 64 of C = 3000) took the select path
    assert pk.topk_plan(3000, 64, 132)[0] == pk.SELECT
    assert pk.PATH_LAUNCHES[("topk_smallest", pk.SELECT)] == \
        before_paths[("topk_smallest", pk.SELECT)] + 64 * chunks
    e = meddit_medoid(x.to(cuda), rng.key(2, cuda), graph=False, **kw)
    c = meddit_medoid(x, rng.key(2), **kw)
    for other in (e, c):
        assert int(g.medoid) == int(other.medoid)
        assert int(g.pulls) == int(other.pulls)
        assert torch.equal(g.means.cpu(), other.means.cpu())
    # the graph is reused: a second call gives the same answer
    again = meddit_medoid(x.to(cuda), rng.key(2, cuda), graph=True, **kw)
    assert torch.equal(again.means, g.means)


def test_distributed_world_size_one_on_nccl(cuda, tmp_path):
    """v1 and v2 on an in-process NCCL group of one rank (a file store):
    the planted medoid, as the single-device engine finds it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.distributed import shard_rows
    from repro_torch.data.medoid_datasets import planted_medoid

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        x = torch.from_numpy(planted_medoid(0, 2048, 64)).to(cuda)
        for impl in ("v1", "v2"):
            for data in (x, shard_rows(x, mesh)):
                res = tapi.find_medoid(data, rng.key(1, cuda), mesh=mesh,
                                       distributed_impl=impl,
                                       backend="pallas_fused")
                assert res.medoid == 0
                assert res.algo == f"corr_sh_distributed_{impl}"
    finally:
        dist.destroy_process_group()
