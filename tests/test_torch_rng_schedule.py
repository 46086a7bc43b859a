"""The port's random stream and round schedule against the JAX package.

Every round-by-round comparison of the port rests on these: the threefry
stream must be bit-equal to ``jax.random`` (split, fold_in, bits,
permutation), and the schedules must be equal tuples.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_compare import torch_key
from repro.engine import schedule as jsched
from repro_torch.engine import rng
from repro_torch.engine import schedule as tsched

pytestmark = pytest.mark.torch_port

SEEDS = (0, 1, 42, 2 ** 31 - 1, -7)


def _words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_bit_equal(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    np.testing.assert_array_equal(_words(jk), tk.data.numpy())
    for step in range(4):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        np.testing.assert_array_equal(_words(jk), tk.data.numpy())
        np.testing.assert_array_equal(_words(jsub), tsub.data.numpy())
        for many in (1, 3):
            got = rng.split_many(tk, many)
            want = jax.random.split(jk, many)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_words(w), g.data.numpy())
        np.testing.assert_array_equal(
            _words(jax.random.fold_in(jk, 1000 + step)),
            rng.fold_in(tk, 1000 + step).data.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jsub, (97,))).astype(np.int64),
            rng.bits(tsub, 97).numpy())


@pytest.mark.parametrize("n", (1, 2, 64, 257, 1024, 1625, 1626, 4097))
def test_permutation_bit_equal(n):
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.key(seed), n)
        want = np.asarray(jax.random.permutation(jk, n))
        got = rng.permutation(torch_key(jk), n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_shuffle_round_count():
    # 0 rounds at n=1, one up to n=1625, two from n=1626 (jax's _shuffle)
    assert [rng.shuffle_rounds(n) for n in (1, 2, 1625, 1626, 20000)] == \
        [0, 1, 1, 2, 2]


def test_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        rng.key(2 ** 32)


def _sampled_cases():
    rs = np.random.default_rng(11)
    ns = [1, 2, 3, 4, 5, 64, 257, 1024, 6424, 20000]
    ns += [int(v) for v in rs.integers(2, 50000, size=40)]
    for n in ns:
        for bpa in (1, 16, 30, int(rs.integers(2, 200))):
            yield n, bpa * n
        yield n, int(rs.integers(1, 40 * n + 2))


def test_schedule_equal_over_sampled_cases():
    for n, budget in _sampled_cases():
        want = jsched.round_schedule(n, budget)
        got = tsched.round_schedule(n, budget)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want], (n, budget)
        assert tsched.stop_round(got) == jsched.stop_round(want)
        assert tsched.schedule_pulls(n, budget) == \
            jsched.schedule_pulls(n, budget)
        if not want:
            continue
        for band_rounds in (1, 3):
            for slack in (1, 2):
                w = jsched.Schedule.from_budget(n, budget).stacked(
                    n, band_rounds=band_rounds, slack=slack)
                g = tsched.Schedule.from_budget(n, budget).stacked(
                    n, band_rounds=band_rounds, slack=slack)
                assert dataclasses.astuple(g) == dataclasses.astuple(w)


def test_main_path_schedule_shapes():
    # n=20000, 30 pulls per arm: 15 rounds from (20000, 2) to (2, 20000)
    rounds = tsched.round_schedule(20000, 30 * 20000)
    shapes = [(r.survivors, r.num_refs) for r in rounds]
    assert len(shapes) == 15
    assert shapes[0] == (20000, 2) and shapes[-1] == (2, 20000)
    assert (40, 1000) in shapes and (3, 13333) in shapes
    assert tsched.stop_round(rounds) == 14
