"""The port's baselines against the JAX package on the CPU: ``rng.randint``
against ``jax.random.randint``, ``default_select`` against
``lax.top_k(-x)``, the chunked Med-dit loop against JAX's ``while_loop``,
RAND, and the facade's ``algo="meddit"`` / ``"rand"``.

Med-dit runs on integer-valued rows: every paired distance is then exact in
fp32 in any summation order, so both packages pull the same arms at every
step and their ``means`` agree to rtol 1e-6. On real-valued rows the fp32
sums round in each package's order, and one swapped near-tie of two lower
bounds sends the runs down different paths (ROADMAP, Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import case, torch_key
from repro.core.meddit import meddit_medoid as jax_meddit
from repro.core.rand import rand_medoid as jax_rand
from repro_torch import api as tapi
from repro_torch.core import meddit_medoid, rand_medoid
from repro_torch.engine import rng
from repro_torch.engine.halving import default_select
from repro_torch.kernels.threefry import threefry_draws, threefry_draws_plain

pytestmark = pytest.mark.torch_port

METRICS = ("l1", "l2", "sql2", "cosine")


def int_rows(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("span", [1, 2, 17, 6424, 65537, 70000])
def test_randint_bit_equal_to_jax(span):
    # above 2**16 the multiplier (2**16 % span)**2 wraps to 0 in uint32
    for seed in (0, 7, 2 ** 31 + 5):
        for shape in ((span if span < 5000 else 257,), (33, 1), (64,)):
            want = np.asarray(jax.random.randint(jax.random.key(seed), shape,
                                                  0, span))
            got = rng.randint(rng.key(seed), shape, 0, span)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.randint(jax.random.key(3), (40,), -span,
                                         span))
    np.testing.assert_array_equal(
        rng.randint(rng.key(3), (40,), -span, span).numpy(), want)


def test_randint_empty_span_and_full_range():
    for lo, hi in ((5, 5), (9, 2), (-2 ** 31, 2 ** 31 - 1)):
        want = np.asarray(jax.random.randint(jax.random.key(1), (16,), lo, hi))
        np.testing.assert_array_equal(
            rng.randint(rng.key(1), (16,), lo, hi).numpy(), want)


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 1.0, 2.0, 1.0, 0.5, 3.0, 0.5],          # ties, duplicates
    [0.0, -0.0, 1.0, -1.0, -0.0, 0.0, 2.0, -2.0],     # signed zeros
    [0.0, -0.0, 1.0, np.nan, -np.nan, -1.0, 0.0, -0.0, np.inf, -np.inf,
     1.0, np.nan],                                    # NaNs of both signs
])
def test_default_select_orders_like_lax_top_k(values):
    """``lax.top_k(-x)`` orders the IEEE total order: -NaN first, then
    -inf, -0.0 before +0.0, +NaN last, ties to the smaller index."""
    x = np.asarray(values, np.float32)
    for keep in range(len(x) + 1):
        want = np.asarray(jax.lax.top_k(-jnp.asarray(x), keep)[1])
        got = default_select(torch.from_numpy(x), keep)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_threefry_plain_is_the_key_chain():
    """The chunk draws on the CPU are the loop of split and randint, and
    chunks chain: two chunks of 3 are one chunk of 6."""
    key = rng.key(9)
    subs, nxt, refs = threefry_draws(key, 6, 5, 6424)
    assert refs.dtype == torch.int32 and refs.shape == (6, 5)
    k = key
    for i in range(6):
        k, sub = rng.split(k)
        assert torch.equal(subs[i], sub.data)
        want = np.asarray(jax.random.randint(
            jax.random.wrap_key_data(jnp.asarray(sub.data.numpy(),
                                                 jnp.uint32)), (5,), 0, 6424))
        np.testing.assert_array_equal(refs[i].numpy(), want)
    assert torch.equal(nxt.data, k.data)
    s1, k1, r1 = threefry_draws_plain(key, 3, 5, 6424)
    s2, k2, r2 = threefry_draws_plain(k1, 3, 5, 6424)
    assert torch.equal(torch.cat([r1, r2]), refs)
    assert torch.equal(torch.cat([s1, s2]), subs) and torch.equal(k2.data,
                                                                  nxt.data)


# (n, d, batch, max_pulls): runs that stop before their cap and runs that
# hit it (sql2 stops early on these rows, the others mostly cap)
MEDDIT_SIZES = [(17, 3, 4, 400), (64, 5, 16, 1600), (200, 8, 64, 6400)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", MEDDIT_SIZES, ids=lambda s: f"n{s[0]}")
@pytest.mark.parametrize("metric", METRICS)
def test_meddit_matches_jax(metric, size, seed):
    n, d, batch, cap = size
    x = int_rows(n, d, seed)
    jkey = jax.random.key(seed)
    want = jax_meddit(x, jkey, metric=metric, batch=batch, max_pulls=cap)
    runs = [meddit_medoid(torch.from_numpy(x), torch_key(jkey), metric=metric,
                          batch=batch, max_pulls=cap, chunk=k)
            for k in (1, 7, 64)]
    for got in runs:
        assert int(got.medoid) == int(want.medoid)
        assert int(got.pulls) == int(want.pulls)
        np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                                   rtol=1e-6, atol=0)
        # the chunk length changes nothing: masked steps are no-ops
        assert torch.equal(got.means, runs[0].means)


def test_meddit_stops_before_the_cap_and_at_it():
    """One run that stops on its confidence bounds and one that runs into
    ``max_pulls`` (both past it by less than a batch, as in JAX)."""
    for metric, seed, n, d, batch, cap, stops in (
            ("l1", 1, 200, 8, 64, 12800, True),
            ("l2", 0, 200, 8, 64, 12800, False)):
        x = int_rows(n, d, seed)
        jkey = jax.random.key(seed)
        want = jax_meddit(x, jkey, metric=metric, batch=batch, max_pulls=cap)
        got = meddit_medoid(torch.from_numpy(x), torch_key(jkey),
                            metric=metric, batch=batch, max_pulls=cap)
        assert int(got.pulls) == int(want.pulls)
        assert int(got.medoid) == int(want.medoid)
        assert (int(got.pulls) < cap) == stops
        assert int(got.pulls) < cap + batch


def test_meddit_options_and_checks():
    x = torch.from_numpy(int_rows(64, 4, 2))
    key = rng.key(4)
    kw = dict(metric="l1", sigma=0.5, delta=0.01, batch=8, init_pulls=3,
              max_pulls=2000)
    want = jax_meddit(x.numpy(), jax.random.key(4), **kw)
    got = meddit_medoid(x, key, **kw)
    assert (int(got.medoid), int(got.pulls)) == (int(want.medoid),
                                                 int(want.pulls))
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="batch"):
        meddit_medoid(x, key, batch=65)
    with pytest.raises(ValueError, match="CUDA"):
        meddit_medoid(x, key, graph=True)


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_rand_matches_jax(metric, replace):
    x = case(300, 7, seed=5, positive=metric == "cosine")
    for seed, refs in ((0, 30), (1, 300), (2, 1000)):
        if not replace and refs > 300:
            continue
        want = jax_rand(x, jax.random.key(seed), num_refs=refs, metric=metric,
                        replace=replace)
        got = rand_medoid(torch.from_numpy(x), rng.key(seed), num_refs=refs,
                          metric=metric, replace=replace)
        assert got.dtype == torch.int64 and int(got) == int(want)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("algo", ["meddit", "rand"])
def test_facade_baselines_match_jax(algo, metric):
    """``find_medoid(algo=...)`` with the facade's defaults (Med-dit: batch
    64, a cap of 1000 n pulls; RAND: ``budget_per_arm`` references)."""
    x = int_rows(64, 4, 3) if algo == "meddit" else case(256, 6, seed=2)
    jkey = jax.random.key(6)
    want = japi.find_medoid(x, jkey, algo=algo, metric=metric)
    got = tapi.find_medoid(x, torch_key(jkey), algo=algo, metric=metric,
                           device="cpu")
    assert (got.medoid, got.pulls, got.algo, got.n) == \
        (want.medoid, want.pulls, want.algo, want.n)
    assert got.rounds == want.rounds == ()


@pytest.mark.parametrize("overrides", [
    {"algo": "meddit", "telemetry": True}, {"algo": "rand",
                                            "precision": "bf16"}])
def test_facade_baselines_refuse_corr_sh_options(overrides):
    with pytest.raises(ValueError, match="requires algo='corr_sh'"):
        tapi.find_medoid(case(16, 4), device="cpu", **overrides)
    with pytest.raises(ValueError, match="requires algo='corr_sh'"):
        japi.find_medoid(case(16, 4), **overrides)
