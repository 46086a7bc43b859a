"""The port's quantized path against a live run of ``repro``'s: margin-
widened halving (winner, live finalists, ``live``, ``margin_ok``), the
facades' medoid, ``verified`` and pulls in both branches of the fp32
fallback, batch and ragged queries, k-medoids on the quantized backends,
and the facade's validation. Pallas runs in interpret mode on the JAX side,
so the sizes stay small there; every input is in general position with
d >= 2 (ROADMAP Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import case, kmedoids_same_as_jax, torch_key
from repro import quant as jquant
from repro.engine import estimators as jest
from repro.engine import halving as jhalving
from repro.engine import schedule as jsched
from repro_torch import api as tapi
from repro_torch import quant as tquant
from repro_torch.core import backend as tbackend
from repro_torch.engine import estimators as test_
from repro_torch.engine import halving as thalving

pytestmark = pytest.mark.torch_port

METRICS = ("l1", "l2", "sql2", "cosine")
QUANT = ("bf16", "int8")


def _widened(x, jk, metric, widen, backend="quant_bf16", length=None):
    """One widened run in each package on ``x`` with key ``jk`` (masked to
    the first ``length`` rows when given): (JAX outcome, port outcome)."""
    n = x.shape[0]
    rounds = jsched.round_schedule(n, 16 * n)
    jmask = tmask = None
    if length is not None:
        jmask = jnp.arange(n) < length
        tmask = torch.arange(n) < length
    want = jhalving.run_halving(
        jhalving.HalvingProblem(jnp.asarray(x),
                                jest.medoid_centrality(backend, metric),
                                arm_mask=jmask, ref_mask=jmask),
        rounds, backend, key=jk, widen=jnp.float32(widen))
    got = thalving.run_halving(
        thalving.HalvingProblem(torch.from_numpy(x),
                                test_.medoid_centrality(backend, metric),
                                arm_mask=tmask, ref_mask=tmask),
        rounds, backend, key=torch_key(jk), widen=torch.tensor(widen))
    return want, got


def _same_outcome(want, got):
    live = int(want.live)
    assert int(got.live) == live
    assert bool(got.margin_ok) == bool(want.margin_ok)
    assert int(got.winner) == int(want.winner)
    np.testing.assert_array_equal(got.survivors[:live].numpy(),
                                  np.asarray(want.survivors)[:live])
    assert got.r_stop == want.r_stop


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("length", (None, 83))
def test_widened_halving_matches_jax(metric, length):
    """At the probe margin, plain (length None) and masked to 83 of 128
    rows; survivors, ``live`` and ``margin_ok`` as JAX's."""
    x = case(128, 6, seed=31, positive=metric == "cosine")
    jk = jax.random.key(41)
    widen = float(tquant.margin(torch.from_numpy(x), metric, "bf16"))
    want, got = _widened(x, jk, metric, widen, length=length)
    _same_outcome(want, got)
    assert got.survivors.shape[0] == tquant.verify_width(
        128, jsched.round_schedule(128, 16 * 128))
    assert bool(got.margin_ok)
    if length is not None:
        assert int(got.winner) < length


@pytest.mark.parametrize("length", (None, 83))
def test_widened_halving_overflow_matches_jax(length):
    """A huge ``widen`` keeps every arm in every band: the first band
    boundary cuts the live set and ``margin_ok`` goes false in both."""
    x = case(128, 6, seed=32)
    want, got = _widened(x, jax.random.key(42), "l2", 1e30, length=length)
    assert not bool(want.margin_ok)
    _same_outcome(want, got)


def test_widened_outcome_plain_run_has_no_certificate():
    x = torch.from_numpy(case(40, 3, seed=2))
    out = thalving.run_halving(
        thalving.HalvingProblem(x, test_.medoid_centrality("quant_int8",
                                                           "l2")),
        jsched.round_schedule(40, 640), key=torch_key(jax.random.key(0)))
    assert out.live is None and out.margin_ok is None


def _same_result(got, want):
    assert (got.medoid, got.verified, got.pulls, got.precision, got.rounds,
            got.backend) == (want.medoid, want.verified, want.pulls,
                             want.precision, want.rounds, want.backend)


@pytest.mark.parametrize("backend", ("reference", "pallas_fused"))
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_find_medoid_quantized_matches_jax(precision, metric, backend):
    """The probe model: ``reference`` runs the plain quantized backends,
    ``pallas_fused`` keeps ``quant_bf16_fused`` for bf16 (the JAX kernel's
    bf16 mode, interpreted). All verify but int8 cosine, whose rounding on
    these 8-wide rows overflows the widened buffers in both packages."""
    x = case(160, 8, seed=51, positive=metric == "cosine")
    jk = jax.random.key(61)
    kw = dict(metric=metric, backend=backend, budget_per_arm=16,
              precision=precision)
    want = japi.find_medoid(x, jk, **kw)
    got = tapi.find_medoid(x, torch_key(jk), device="cpu", **kw)
    _same_result(got, want)
    assert got.verified is not (precision == "int8" and metric == "cosine")


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("metric", ("l2", "cosine"))
def test_find_medoid_fallback_matches_jax(precision, metric):
    """The analytic model on rows far from the origin: its margin spans
    every estimate, the widened sets overflow, and both packages re-run in
    fp32 under the same key (pulls: scheduled + check + scheduled)."""
    x = case(100, 5, seed=52) + np.float32(40.0)
    jk = jax.random.key(62)
    kw = dict(metric=metric, budget_per_arm=16, precision=precision,
              quant_error_model="analytic")
    want = japi.find_medoid(x, jk, **kw)
    got = tapi.find_medoid(x, torch_key(jk), device="cpu", **kw)
    _same_result(got, want)
    assert got.verified is False
    fp32 = tapi.find_medoid(x, torch_key(jk), device="cpu", metric=metric,
                            budget_per_arm=16)
    rounds = jsched.round_schedule(100, 1600)
    assert got.medoid == fp32.medoid
    assert got.pulls == 2 * fp32.pulls + tquant.verify_pulls(100, rounds)


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("shift", (0.0, 40.0))
def test_batch_and_ragged_quantized_match_jax(precision, shift):
    """Batch and ragged medoids, verified (shift 0, probe model) and with
    every query on the fp32 fallback (shift 40, analytic model)."""
    model = "probe" if shift == 0.0 else "analytic"
    kw = dict(budget_per_arm=12, precision=precision,
              quant_error_model=model)
    batch = np.stack([case(40, 4, seed=70 + i) + np.float32(shift)
                      for i in range(3)])
    jk = jax.random.key(71)
    want = japi.find_medoids_batch(batch, jk, **kw)
    got = tapi.find_medoids_batch(batch, torch_key(jk), device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qs = [case(m, 4, seed=80 + m) + np.float32(shift) for m in (9, 15, 30)]
    want = japi.find_medoids_ragged(qs, key=jk, **kw)
    got = tapi.find_medoids_ragged(qs, key=torch_key(jk), device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ("quant_int8", "quant_bf16"))
def test_kmedoids_on_quant_backends_matches_jax(backend):
    x = case(60, 4, seed=90)
    kmedoids_same_as_jax(x, 3, jax.random.key(91), backend=backend)


def test_quantized_facade_validation_matches_jax():
    """The errors of JAX's ``test_facade_validation``, the unknown error
    model, and k-medoids' missing ``precision`` field."""
    x = np.ones((8, 3), np.float32)
    for kw, err, match in (
            ({"precision": "fp16"}, ValueError, "unknown precision"),
            ({"precision": "bf16", "algo": "exact"}, ValueError,
             "requires algo='corr_sh'"),
            ({"precision": "int8", "quant_error_model": "nope"}, ValueError,
             "unknown error model")):
        with pytest.raises(err, match=match):
            japi.find_medoid(x, jax.random.key(0), **kw)
        with pytest.raises(err, match=match):
            tapi.find_medoid(x, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown precision"):
        tapi.find_medoids_batch(x[None], device="cpu", precision="fp16")
    for precision in ("fp32", "int8"):
        with pytest.raises(TypeError):
            japi.kmedoids(x, 2, jax.random.key(0), precision=precision)
        with pytest.raises(TypeError):
            tapi.kmedoids(x, 2, device="cpu", precision=precision)
    one = tapi.find_medoid(x[:1], device="cpu", precision="bf16")
    assert (one.medoid, one.pulls, one.verified, one.precision) == \
        (0, 0, True, "bf16")


def test_quant_backends_registered():
    names = tbackend.list_backends()
    for name in ("quant_bf16", "quant_int8", "quant_bf16_fused"):
        assert name in names
        assert tbackend.get_backend(name).name == name
        assert tbackend.get_backend(name).survivor_order is None
    for base in ("reference", "pallas_pairwise", "pallas_fused",
                 "pallas_fused_topk"):
        for precision in tquant.PRECISIONS:
            assert tquant.backend_for(precision, base) == \
                jquant.backend_for(precision, base)
