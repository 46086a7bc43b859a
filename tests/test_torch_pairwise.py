"""The pairwise kernels' glue and the ``pallas_pairwise`` backend against the
JAX package on the same numpy inputs (tolerances: ``_torch_compare``).

The JAX side runs ``repro.kernels.ops`` in Pallas interpret mode, as its own
tests do on the CPU; the port's wrappers take their plain versions because
the tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import RTOL, assert_close, case, torch_key
from repro.core import backend as jbackend
from repro.core import correlated_sequential_halving as jcorr_sh
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.core import backend as tbackend
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_distance as pk

pytestmark = pytest.mark.torch_port

METRICS = ("l1", "l2", "sql2", "cosine")
# ragged shapes: no tile multiple, d across the 256-wide Pallas d tile,
# the skinny (1, R) and (C, 1) rows of the k-medoids path
SHAPES = ((1, 1, 1), (37, 131, 300), (130, 5, 257), (1, 77, 40),
          (77, 1, 40))


def _pair(c, r, d, seed, positive):
    x = case(c, d, seed, positive)
    y = case(r, d, seed + 1, positive)
    y[: min(3, r, c)] = x[: min(3, r, c)]      # a few self-pairs
    return x, y


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_kernel_matches_jax(metric, shape):
    c, r, d = shape
    x, y = _pair(c, r, d, seed=c + r + d, positive=metric == "cosine")
    got = tops.pairwise_kernel(metric)(torch.from_numpy(x),
                                       torch.from_numpy(y))
    want = np.asarray(jops.pairwise_kernel(metric)(jnp.asarray(x),
                                                   jnp.asarray(y)))
    assert got.dtype == torch.float32 and got.shape == (c, r)
    assert_close(got, want, metric, np.concatenate([x, y]))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_versions_match_jax_kernels(shape):
    c, r, d = shape
    x, y = _pair(c, r, d, seed=5, positive=False)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    rows = np.concatenate([x, y])
    assert_close(pk.dot_pairwise_plain(tx, ty),
                 np.asarray(jops.kernel_dot(jnp.asarray(x), jnp.asarray(y))),
                 "dot", rows)
    assert_close(pk.l1_pairwise_plain(tx, ty),
                 np.asarray(jops.kernel_l1(jnp.asarray(x), jnp.asarray(y))),
                 "l1", rows)
    # the wrappers take the plain versions on CPU tensors, bit for bit
    assert torch.equal(pk.dot_pairwise(tx, ty), pk.dot_pairwise_plain(tx, ty))
    assert torch.equal(pk.l1_pairwise(tx, ty), pk.l1_pairwise_plain(tx, ty))


def test_l1_plain_row_blocks_cover_every_row(monkeypatch):
    monkeypatch.setattr(pk, "_PLAIN_BLOCK", 7 * 11 * 3)   # 7 rows a block
    x, y = torch.from_numpy(case(30, 3, 1)), torch.from_numpy(case(11, 3, 2))
    want = (x[:, None] - y[None]).abs().sum(-1)
    torch.testing.assert_close(pk.l1_pairwise_plain(x, y), want, rtol=0,
                               atol=0)


def test_pairwise_wrappers_check_their_inputs():
    x = torch.zeros(4, 3)
    for fn in (pk.dot_pairwise, pk.l1_pairwise):
        with pytest.raises(TypeError):
            fn(x.double(), x.double())
        with pytest.raises(ValueError):
            fn(x, torch.zeros(4, 5))                  # d differs
        with pytest.raises(ValueError):
            fn(torch.zeros(3, 4).T, x)                # not contiguous
        with pytest.raises(ValueError):
            fn(x.to("meta"), x.to("meta"))            # no kernel there
    assert pk.LAUNCHES["dot_pairwise"] == pk.LAUNCHES["l1_pairwise"] == 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", (False, True))
def test_pallas_pairwise_centrality_matches_jax(metric, masked):
    x, y = _pair(45, 70, 130, seed=11, positive=metric == "cosine")
    m = (np.random.default_rng(2).random(70) > 0.4).astype(np.float32)
    mask = m if masked else None
    got = tbackend.get_backend("pallas_pairwise").centrality_sums(metric)(
        torch.from_numpy(x), torch.from_numpy(y),
        ref_mask=None if mask is None else torch.from_numpy(mask))
    want = jbackend.get_backend("pallas_pairwise").centrality_sums(metric)(
        jnp.asarray(x), jnp.asarray(y),
        ref_mask=None if mask is None else jnp.asarray(mask))
    assert_close(got, np.asarray(want), metric, np.concatenate([x, y]), 70)


@pytest.mark.parametrize("metric", METRICS)
def test_find_medoid_pallas_pairwise_matches_jax(metric):
    n = 257                                   # Pallas interprets on CPU
    d = 300 if metric in ("sql2", "cosine") else 8
    x = case(n, d, seed=3 * n + d, positive=metric == "cosine")
    jk = jax.random.key(77)
    want = japi.find_medoid(x, jk, backend="pallas_pairwise", metric=metric,
                            budget_per_arm=16)
    got = tapi.find_medoid(x, torch_key(jk), backend="pallas_pairwise",
                           metric=metric, budget_per_arm=16, device="cpu")
    assert (got.pulls, got.rounds, got.backend) == \
        (want.pulls, want.rounds, want.backend)
    if got.medoid != want.medoid:
        theta = np.sort(np.asarray(jcorr_sh(jnp.asarray(x), 16 * n, jk,
                                            metric=metric,
                                            backend="pallas_pairwise"
                                            ).theta_hat))
        assert theta[1] - theta[0] <= 2 * RTOL * abs(theta[0]), \
            (got.medoid, want.medoid)


def test_every_pallas_backend_has_the_kernel_pairwise():
    for name in ("pallas_pairwise", "pallas_fused", "pallas_fused_topk"):
        for metric in METRICS:
            assert tbackend.get_backend(name).pairwise(metric) is \
                tops.pairwise_kernel(metric)
    with pytest.raises(ValueError, match="unknown metric"):
        tops.pairwise_kernel("hamming")
