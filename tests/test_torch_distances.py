"""The port's distances, exact oracle and kernel plain versions against the
JAX package on the same numpy inputs (tolerances: ``_torch_compare``).

The JAX side of the kernel tests runs ``repro.kernels.ops`` as its own tests
do on the CPU, in Pallas interpret mode; the port's wrappers take their plain
versions because the tensors lie on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_compare import assert_close, case
from repro.core import distances as jdist
from repro.core import exact as jexact
from repro.engine.halving import default_order as jdefault_order
from repro.kernels import ops as jops
from repro_torch.core import distances as tdist
from repro_torch.core import exact as texact
from repro_torch.engine.halving import default_order as tdefault_order
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_distance as pk
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.torch_port

METRICS = ("l1", "l2", "sql2", "cosine")


def _pair(c, r, d, seed=0, positive=False):
    x = case(c, d, seed, positive)
    y = case(r, d, seed + 1, positive)
    y[: min(3, r, c)] = x[: min(3, r, c)]      # a few self-pairs
    return x, y


def _mask(r, seed=3):
    m = (np.random.default_rng(seed).random(r) > 0.35).astype(np.float32)
    m[0] = 1.0
    return m


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_and_masked_rowsum(metric):
    x, y = _pair(37, 53, 300)
    got = tdist.pairwise(metric)(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(jdist.pairwise(metric)(jnp.asarray(x), jnp.asarray(y)))
    assert_close(got, want, metric, np.concatenate([x, y]))
    m = _mask(53)
    got_s = tdist.masked_rowsum(got, torch.from_numpy(m))
    want_s = np.asarray(jdist.masked_rowsum(jnp.asarray(want), jnp.asarray(m)))
    assert_close(got_s, want_s, metric, np.concatenate([x, y]), 53)
    assert_close(tref.ref_pairwise(metric, torch.from_numpy(x),
                                   torch.from_numpy(y)), want, metric,
                 np.concatenate([x, y]))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", (False, True))
def test_centrality_sums(metric, masked):
    x, y = _pair(41, 75, 300, positive=metric == "cosine")
    m = _mask(75) if masked else None
    got = tdist.centrality_sums(torch.from_numpy(x), torch.from_numpy(y),
                                metric, ref_mask=None if m is None
                                else torch.from_numpy(m))
    want = np.asarray(jdist.centrality_sums(
        jnp.asarray(x), jnp.asarray(y), metric,
        ref_mask=None if m is None else jnp.asarray(m)))
    assert_close(got, want, metric, np.concatenate([x, y]), 75)


@pytest.mark.parametrize("metric", METRICS)
def test_full_distance_matrix_and_exact(metric):
    x = case(300, 8 if metric in ("l2", "sql2") else 300, seed=5,
             positive=metric == "cosine")
    xt = torch.from_numpy(x)
    assert_close(tdist.full_distance_matrix(xt, metric),
                 np.asarray(jdist.full_distance_matrix(jnp.asarray(x),
                                                       metric)), metric, x)
    want_theta = np.asarray(jexact.exact_theta(jnp.asarray(x), metric))
    assert_close(texact.exact_theta(xt, metric), want_theta, metric, x)
    assert int(texact.exact_medoid(xt, metric)) == \
        int(jexact.exact_medoid(jnp.asarray(x), metric))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("d", (8, 300))
def test_kernel_centrality_sums_vs_pallas(metric, masked, d):
    """Plain versions of dot_centrality / l1_centrality (via the ops glue)
    against the Pallas kernels of the JAX package, masks included."""
    c, r = (130, 67) if d == 8 else (29, 150)
    x, y = _pair(c, r, d, seed=d, positive=metric == "cosine")
    m = _mask(r) if masked else None
    before = dict(pk.LAUNCHES)
    got = tops.kernel_centrality_sums(
        torch.from_numpy(x), torch.from_numpy(y), metric=metric,
        ref_mask=None if m is None else torch.from_numpy(m))
    want = np.asarray(jops.kernel_centrality_sums(
        jnp.asarray(x), jnp.asarray(y), metric=metric,
        ref_mask=None if m is None else jnp.asarray(m)))
    assert_close(got, want, metric, np.concatenate([x, y]), r)
    assert dict(pk.LAUNCHES) == before      # the CPU never launches a kernel


def test_kernel_l1_centrality_mean_vs_pallas():
    x, y = _pair(33, 70, 300)
    for m in (None, _mask(70)):
        got = tops.kernel_l1_centrality(
            torch.from_numpy(x), torch.from_numpy(y),
            ref_mask=None if m is None else torch.from_numpy(m))
        want = np.asarray(jops.kernel_l1_centrality(
            jnp.asarray(x), jnp.asarray(y),
            ref_mask=None if m is None else jnp.asarray(m)))
        assert_close(got, want, "l1", np.concatenate([x, y]))


def _special_thetas():
    rs = np.random.default_rng(7)
    base = rs.standard_normal(150).astype(np.float32)
    ties = np.round(base, 1)                           # many exact ties
    zeros = ties.copy()
    zeros[::3] = 0.0
    zeros[1::5] = -0.0                                 # -0.0 vs +0.0
    inf = zeros.copy()
    inf[::7] = np.inf
    inf[2::11] = -np.inf
    return {"random": base, "ties": ties, "zeros": zeros, "inf": inf,
            "all_equal": np.full(40, 2.5, np.float32),
            "one": np.asarray([-0.0], np.float32)}


@pytest.mark.parametrize("kind", sorted(_special_thetas()))
def test_topk_smallest_bit_equal(kind):
    theta = _special_thetas()[kind]
    c = theta.shape[0]
    tt = torch.from_numpy(theta)
    for keep in sorted({1, min(5, c), c}):
        want = np.asarray(jops.kernel_topk_smallest(jnp.asarray(theta),
                                                    keep=keep))
        got = tops.kernel_topk_smallest(tt, keep=keep)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # the default halving order (jnp.argsort) of both packages agrees too
    np.testing.assert_array_equal(
        tdefault_order(tt).numpy(),
        np.asarray(jdefault_order(jnp.asarray(theta))))


def test_default_order_and_topk_split_signed_zeros_like_jax():
    """jnp.argsort ties -0.0 with +0.0 and puts every NaN last; the topk
    kernels order the IEEE total order. The port reproduces both orders,
    and so their disagreement, exactly."""
    theta = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0,
                      -0.0, 0.0, -np.nan, np.nan, -1.0], np.float32)
    tt = torch.from_numpy(theta)
    want_sort = np.asarray(jdefault_order(jnp.asarray(theta)))
    want_topk = np.asarray(jops.kernel_topk_smallest(jnp.asarray(theta),
                                                     keep=theta.size))
    assert not np.array_equal(want_sort, want_topk)
    np.testing.assert_array_equal(tdefault_order(tt).numpy(), want_sort)
    np.testing.assert_array_equal(
        tops.kernel_topk_smallest(tt, keep=theta.size).numpy(), want_topk)


def test_topk_rank_select_plain():
    keys = torch.tensor([5, -3, 5, 0, -3, 7], dtype=torch.int32)
    rank = pk.topk_rank(keys)
    assert rank.tolist() == [3, 0, 4, 2, 1, 5]
    assert pk.topk_select(rank, 6).tolist() == [1, 4, 3, 0, 2, 5]
    assert pk.topk_select(rank, 2).tolist() == [1, 4]
    with pytest.raises(ValueError):
        tops.kernel_topk_smallest(torch.zeros(3), keep=0)


def test_wrappers_check_inputs():
    x = torch.zeros(4, 8)
    y = torch.zeros(5, 8)
    with pytest.raises(TypeError):
        pk.l1_centrality(x.double(), y.double())
    with pytest.raises(ValueError):
        pk.l1_centrality(x, torch.zeros(5, 7))
    with pytest.raises(ValueError):
        pk.l1_centrality(x.T, y[:, :4])              # not contiguous
    with pytest.raises(ValueError):
        pk.dot_centrality(x, y, None, None, metric="l2")
    with pytest.raises(ValueError):
        pk.dot_centrality(x, y, None, None, metric="l1")
    with pytest.raises(ValueError):
        pk.topk_select(torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):      # no kernel and no plain path here
        pk.l1_centrality(x.to("meta"), y.to("meta"))
