"""The port's round loop against ``repro.engine.run_halving`` on the same
numpy data and key: equal reference draws, equal output-round survivors,
output-round estimates within the stated tolerance, equal winners."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_compare import assert_close, case, torch_key
from repro.engine import halving as jhalving
from repro.engine import estimators as jest
from repro.engine import schedule as jsched
from repro_torch.core import backend as tbackend
from repro_torch.engine import halving as thalving
from repro_torch.engine import estimators as t_est
from repro_torch.engine import programs, rng
from repro_torch.engine import schedule as tsched

pytestmark = pytest.mark.torch_port

BACKENDS = ("reference", "pallas_fused", "pallas_fused_topk")
METRICS = ("l1", "l2", "sql2", "cosine")


def _size(backend: str, metric: str):
    # Pallas runs in interpret mode on the JAX side: keep it small there;
    # d=300 crosses the 256-wide d tile of the Pallas kernels.
    n = 1024 if backend == "reference" else 257
    d = 300 if metric in ("l1", "cosine") else 8
    return n, d


def test_sample_refs_chained_keys():
    jk = jax.random.key(123)
    tk = torch_key(jk)
    for step, (n, t) in enumerate([(257, 2), (257, 100), (1024, 37),
                                   (2000, 1999), (64, 64), (64, 80),
                                   (1, 1), (4097, 4)]):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        want = np.asarray(jhalving.sample_refs(jsub, n, t))
        got = thalving.sample_refs(tsub, n, t)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(step))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric", METRICS)
def test_run_halving_matches_jax(backend, metric):
    n, d = _size(backend, metric)
    x = case(n, d, seed=n + d, positive=metric == "cosine")
    jk = jax.random.key(1000 + n)
    rounds = jsched.round_schedule(n, 16 * n)
    want = jhalving.run_halving(
        jhalving.HalvingProblem(jnp.asarray(x),
                                jest.medoid_centrality(backend, metric)),
        rounds, backend, key=jk)
    got = thalving.run_halving(
        thalving.HalvingProblem(torch.from_numpy(x),
                                t_est.medoid_centrality(backend, metric)),
        tsched.round_schedule(n, 16 * n), backend, key=torch_key(jk))
    assert got.r_stop == want.r_stop
    np.testing.assert_array_equal(got.survivors.numpy(),
                                  np.asarray(want.survivors))
    assert_close(got.theta, np.asarray(want.theta), metric, x)
    assert int(got.winner) == int(want.winner)
    assert int(got.winner_pos) == int(want.winner_pos)


def test_run_halving_rejects_empty_schedule():
    with pytest.raises(ValueError):
        thalving.run_halving(
            thalving.HalvingProblem(torch.zeros(1, 3),
                                    t_est.medoid_centrality()),
            [], key=rng.key(0))


def test_backend_registry_and_unported_names():
    assert set(BACKENDS) <= set(tbackend.list_backends())
    assert tbackend.get_backend(None).name == "reference"
    assert tbackend.get_backend("pallas_fused_topk").survivor_order \
        is not None
    assert thalving.resolve_order_fn("pallas_fused") is \
        thalving.default_order
    for name in ("pallas_pairwise", "quant_bf16", "quant_int8"):
        with pytest.raises(ValueError, match="ROADMAP"):
            tbackend.get_backend(name)
    with pytest.raises(ValueError, match="ROADMAP"):
        tbackend.get_backend("pallas_fused").pairwise("l2")
    with pytest.raises(ValueError):
        tbackend.get_backend("no_such_backend")
    assert t_est.list_estimators() == ("medoid_centrality",)


def test_medoid_program_is_memoized():
    from repro_torch.engine import instrument

    with instrument.deltas() as dl:
        a = programs.medoid_program(budget=999, metric="l2",
                                    backend="reference")
        b = programs.medoid_program(budget=999, metric="l2",
                                    backend="reference")
    assert a is b and dl.trace("medoid") == 1
    x = torch.from_numpy(case(40, 4))
    assert int(a(x, rng.key(3))) == int(b(x, rng.key(3)))
    assert int(a(x[:1], rng.key(3))) == 0               # n == 1
