"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: the ``cuda`` fixture skips each test where no card exists
(decided inside the fixture, so every worker collects the same tests). On a
card: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_gpu.py`` (this file needs no JAX, which ``conftest.py``
imports). ``chip_smoke.py`` holds the kernels at the main path's full
shapes; these are the small cases.
"""
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


@pytest.mark.parametrize("metric", ("l1", "l2", "sql2", "cosine"))
@pytest.mark.parametrize("shape", ((1, 1, 1), (77, 131, 300), (130, 65, 257),
                                   (2000, 3, 784), (3, 3000, 784)))
def test_centrality_kernels_match_plain(cuda, metric, shape):
    c, r, d = shape
    g = torch.Generator(device=cuda).manual_seed(c * r + d)
    x = torch.rand(c, d, device=cuda, generator=g)
    y = torch.rand(r, d, device=cuda, generator=g)
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    for mask in (None, w):
        before = pk.LAUNCHES.copy()
        got = ops.kernel_centrality_sums(x, y, metric=metric, ref_mask=mask)
        want = ops.kernel_centrality_sums(x.cpu(), y.cpu(), metric=metric,
                                          ref_mask=None if mask is None
                                          else mask.cpu())
        torch.cuda.synchronize()
        kern = "l1_centrality" if metric == "l1" else "dot_centrality"
        assert pk.LAUNCHES[kern] == before[kern] + 1
        # rtol 1e-5, floor 1e-5 of the largest sum, l2 self-pair allowance
        tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        if metric == "l2":
            tol = tol + 1e-3 * float(torch.cat([x, y]).norm(dim=1).max()) * r
        assert bool(((got.cpu() - want).abs() <= tol).all())


@pytest.mark.parametrize("c", (1, 2, 129, 5000))
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
