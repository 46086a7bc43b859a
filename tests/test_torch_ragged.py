"""The port's bucketing, masked round loop, batch and ragged engines against
the JAX package on the same numpy inputs and keys; the full-bucket
property; and the unmasked loop held bit for bit against a snapshot of
itself from before the masks were added."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import assert_close, case, torch_key
from repro.core import bucketing as jbucket
from repro.engine import estimators as jest
from repro.engine import halving as jhalving
from repro.engine import schedule as jsched
from repro_torch import api as tapi
from repro_torch.core import bucketing as tbucket
from repro_torch.core import corr_sh as tcorr
from repro_torch.engine import estimators as t_est
from repro_torch.engine import halving as thalving
from repro_torch.engine import instrument, rng
from repro_torch.engine import schedule as tsched

pytestmark = pytest.mark.torch_port

BACKENDS = ("reference", "pallas_fused", "pallas_fused_topk")
LENGTHS = (5, 33, 64, 20)


# --------------------------------- bucketing --------------------------------

def test_bucket_sizes_and_plans_match_jax():
    for n in (1, 2, 7, 8, 9, 63, 64, 65, 1000, 4097):
        assert tbucket.next_pow2(n) == jbucket.next_pow2(n)
        for mb in (1, 8, 64):
            assert tbucket.bucket_n(n, mb) == jbucket.bucket_n(n, mb)
    for lo, hi in ((1, 1), (3, 9), (5, 1000), (100, 100000)):
        assert tbucket.num_buckets_for_range(lo, hi) == \
            jbucket.num_buckets_for_range(lo, hi)
    lens = [5, 300, 17, 8, 9, 1, 1000, 40, 300]
    for mb in (8, 32):
        assert tbucket.plan_buckets(lens, mb) == jbucket.plan_buckets(lens, mb)
    for bad in ((tbucket.next_pow2, 0), (tbucket.bucket_n, 5, 3)):
        with pytest.raises(ValueError):
            bad[0](*bad[1:])


@pytest.mark.parametrize("pad_to", (None, 8))
def test_pack_queries_matches_jax(pad_to):
    qs = [case(n, 3, seed=n) for n in (5, 12, 9)]
    jd, jl = jbucket.pack_queries([jnp.asarray(q) for q in qs],
                                  pad_batch_to=pad_to)
    td, tl = tbucket.pack_queries([torch.from_numpy(q) for q in qs],
                                  pad_batch_to=pad_to)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32
    for bad in ([], [torch.zeros(3, 4), torch.zeros(3, 5)],
                [torch.zeros(0, 4)], [torch.zeros(4)]):
        with pytest.raises(ValueError):
            tbucket.pack_queries(bad)
    with pytest.raises(ValueError):
        tbucket.pack_queries([torch.zeros(3, 2)] * 3, pad_batch_to=2)


# ------------------------------ masked draws --------------------------------

def test_sample_refs_masked_bit_equal_to_jax():
    jk = jax.random.key(31)
    tk = torch_key(jk)
    gen = np.random.default_rng(0)
    for step, (n, t) in enumerate([(64, 5), (64, 40), (257, 100),
                                   (1024, 3), (64, 64), (64, 90), (8, 7)]):
        valid = gen.random(n) > 0.4
        valid[0] = True
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        want = np.asarray(jhalving.sample_refs_masked(jsub, n, t,
                                                      jnp.asarray(valid)))
        got = thalving.sample_refs_masked(tsub, n, t, torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(step))
    # every point valid: the plain draw
    k = rng.key(5)
    np.testing.assert_array_equal(
        thalving.sample_refs_masked(k, 300, 40, torch.ones(300, dtype=bool)),
        thalving.sample_refs(k, 300, 40))


@pytest.mark.parametrize("backend", BACKENDS)
def test_masked_run_halving_matches_jax(backend):
    n = 200 if backend == "reference" else 96
    x = case(n, 6, seed=n)
    gen = np.random.default_rng(n)
    arm = gen.random(n) > 0.3
    ref = gen.random(n) > 0.5
    jk = jax.random.key(9)
    rounds = jsched.round_schedule(n, 12 * n)
    want = jhalving.run_halving(
        jhalving.HalvingProblem(jnp.asarray(x),
                                jest.medoid_centrality(backend, "l1"),
                                arm_mask=jnp.asarray(arm),
                                ref_mask=jnp.asarray(ref)),
        rounds, backend, key=jk)
    got = thalving.run_halving(
        thalving.HalvingProblem(torch.from_numpy(x),
                                t_est.medoid_centrality(backend, "l1"),
                                arm_mask=torch.from_numpy(arm),
                                ref_mask=torch.from_numpy(ref)),
        tsched.round_schedule(n, 12 * n), backend, key=torch_key(jk))
    np.testing.assert_array_equal(got.survivors.numpy(),
                                  np.asarray(want.survivors))
    finite = np.isfinite(np.asarray(want.theta))
    np.testing.assert_array_equal(np.isfinite(got.theta.numpy()), finite)
    assert_close(got.theta[torch.from_numpy(finite)],
                 np.asarray(want.theta)[finite], "l1", x)
    assert int(got.winner) == int(want.winner) and bool(arm[int(got.winner)])


# ------------------------ the unmasked loop, unchanged -----------------------

def _unmasked_loop_snapshot(problem, schedule, order_fn, key):
    """The port's round loop as it stood before masks were added."""
    sched = tsched.as_schedule(schedule)
    data, est = problem.data, problem.estimator
    n = data.shape[0]
    r_stop = tsched.stop_round(list(sched))
    idx = torch.arange(n, device=data.device)
    for r in range(r_stop):
        t = sched[r].num_refs
        key, sub = rng.split(key)
        refs = rng.permutation(sub, n)[:t]
        sums, _ = est.score(data[idx], data[refs], refs=refs)
        idx = idx[order_fn(thalving._mean(sums, t))][:sched[r + 1].survivors]
    key, sub = rng.split(key)
    refs = thalving.sample_refs(sub, n, sched[r_stop].num_refs)
    sums, aux = est.score(data[idx], data[refs], refs=refs)
    theta = thalving._mean(sums, refs.shape[0])
    pos = torch.argmin(theta)
    return idx[pos], pos, idx, theta


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", (2, 3, 100, 1000))
def test_unmasked_run_halving_is_unchanged(backend, n):
    x = torch.from_numpy(case(n, 5, seed=n))
    problem = thalving.HalvingProblem(x, t_est.medoid_centrality(backend,
                                                                 "l2"))
    rounds = tsched.round_schedule(n, 10 * n)
    order_fn = thalving.resolve_order_fn(backend)
    out = thalving.run_halving(problem, rounds, key=rng.key(n),
                               survivor_order=order_fn)
    winner, pos, idx, theta = _unmasked_loop_snapshot(problem, rounds,
                                                      order_fn, rng.key(n))
    assert torch.equal(out.survivors, idx) and torch.equal(out.theta, theta)
    assert int(out.winner) == int(winner) and int(out.winner_pos) == int(pos)


# --------------------------- batch and ragged -------------------------------

def _queries():
    return [case(n, 6, seed=100 + n) for n in LENGTHS]


@pytest.mark.parametrize("backend", BACKENDS)
def test_ragged_matches_jax(backend):
    qs = _queries()
    jk = jax.random.key(21)
    want = np.asarray(japi.find_medoids_ragged(qs, key=jk, backend=backend,
                                               budget_per_arm=12))
    got = tapi.find_medoids_ragged(qs, key=torch_key(jk), backend=backend,
                                   budget_per_arm=12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < np.asarray(LENGTHS)).all()
    # the pre-packed form answers the same
    data, lengths = tbucket.pack_queries([torch.from_numpy(q) for q in qs])
    again = tapi.find_medoids_ragged(data, lengths, torch_key(jk),
                                     backend=backend, budget_per_arm=12)
    assert torch.equal(again, got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_matches_jax(backend):
    batch = np.stack([case(40, 6, seed=s) for s in range(3)])
    jk = jax.random.key(22)
    want = np.asarray(japi.find_medoids_batch(batch, jk, backend=backend,
                                              budget_per_arm=10))
    got = tapi.find_medoids_batch(batch, torch_key(jk), backend=backend,
                                  budget_per_arm=10, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    one = tapi.find_medoids_batch(batch[:, :1], torch_key(jk), device="cpu")
    assert one.tolist() == [0, 0, 0]                       # n == 1
    with pytest.raises(ValueError):
        tapi.find_medoids_batch(batch[0], device="cpu")   # not (B, n, d)


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_bucket_query_gets_the_single_query_answer(backend):
    qs = [torch.from_numpy(case(n, 4, seed=n)) for n in (64, 20, 64, 37)]
    key = rng.key(8)
    got = tapi.find_medoids_ragged(qs, key=key, backend=backend,
                                   budget_per_arm=12)
    keys = rng.split_many(key, len(qs))
    for i in (0, 2):                       # the queries that fill bucket 64
        single = tapi.find_medoid(qs[i], keys[i], backend=backend,
                                  budget_per_arm=12)
        assert int(got[i]) == single.medoid


def test_admission_errors_and_options():
    data, lengths = tbucket.pack_queries([torch.zeros(5, 2),
                                          torch.zeros(3, 2)])
    with pytest.raises(ValueError, match="all-padding"):
        tcorr.ragged_medoids(data, [5, 0], rng.key(0), budget=80)
    with pytest.raises(ValueError, match="exceeds"):
        tcorr.ragged_medoids(data, [5, 9], rng.key(0), budget=80)
    with pytest.raises(ValueError, match="lengths must be"):
        tcorr.ragged_medoids(data, [5], rng.key(0), budget=80)
    with pytest.raises(ValueError):
        tcorr.ragged_medoids(data[0], [5], rng.key(0), budget=80)
    with pytest.raises(ValueError, match="explicit lengths"):
        tapi.find_medoids_ragged(data, key=rng.key(0))
    with pytest.raises(ValueError, match="only with pre-packed"):
        tapi.find_medoids_ragged([torch.zeros(3, 2)], [3], rng.key(0))
    for mode, call in (("ragged", tapi.find_medoids_ragged),
                       ("batched", tapi.find_medoids_batch)):
        with pytest.raises(ValueError, match=mode):
            call(data, lengths, algo="exact") if mode == "ragged" \
                else call(data, algo="exact")
    meds, tel = tapi.find_medoids_ragged([torch.zeros(3, 2)], telemetry=True)
    assert meds.shape == (1,) and tel["pulls"].shape[0] == 1
    with pytest.raises(ValueError, match="unknown precision"):
        tapi.find_medoids_batch(data, precision="int4")


def test_ragged_programs_are_one_per_bucket():
    """One program per bucket, and per input signature within it: the
    trace odometer moves as JAX's does on the same calls (a batch of 3 and
    then of 2 in the 16-bucket is one table entry, two signatures)."""
    from repro.engine import instrument as jinstrument

    xs = [case(n, 3, seed=n) for n in (9, 15, 16)]
    qs = [torch.from_numpy(x) for x in xs]
    with instrument.deltas() as dl:
        tapi.find_medoids_ragged(qs, key=rng.key(1), budget_per_arm=7)
        tapi.find_medoids_ragged(qs[:2], key=rng.key(2), budget_per_arm=7)
    with jinstrument.deltas() as jdl:
        japi.find_medoids_ragged(xs, key=jax.random.key(1), budget_per_arm=7)
        japi.find_medoids_ragged(xs[:2], key=jax.random.key(2),
                                 budget_per_arm=7)
    assert dl.trace("ragged") == jdl.trace("ragged") == 2
    assert dl.dispatch("ragged") == jdl.dispatch("ragged") == 2
    assert tcorr.ragged_compile_count() >= 1


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qs = _queries()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.find_medoids_ragged(qs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.find_medoids_batch(np.stack([qs[1][:5], qs[2][:5]]))
    assert tapi.find_medoids_ragged(qs, device="cpu").shape == (4,)
