"""The port's deprecated pre-facade entry points against the live JAX
package, on the cases of ``tests/test_api.py::test_deprecated_entrypoints_
warn``: ``corr_sh_medoid``, ``corr_sh_medoid_batch``,
``corr_sh_medoid_ragged`` (``repro_torch.core``) and ``bandit_kmedoids``
(``repro_torch.cluster``). Each still works, warns ``DeprecationWarning``
exactly once per process over two calls, pointing at its
``repro_torch.api`` replacement, and returns what the facade returns and
what JAX's shim returns on the same input and key (exact integer
answers)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import deprecation as jdeprecation
from repro.cluster import bandit_kmedoids as jbandit_kmedoids
from repro.core import corr_sh_medoid as jcorr_sh_medoid
from repro.core import corr_sh_medoid_batch as jcorr_sh_medoid_batch
from repro.core import corr_sh_medoid_ragged as jcorr_sh_medoid_ragged
from repro.core import pack_queries as jpack_queries
from repro.data.medoid_datasets import planted_clusters
from repro_torch import deprecation
from repro_torch.api import (find_medoid, find_medoids_batch,
                             find_medoids_ragged, kmedoids)
from repro_torch.core.bucketing import pack_queries

from _torch_compare import torch_key

pytestmark = pytest.mark.torch_port


def _inputs():
    rng = np.random.default_rng(10)
    data = rng.standard_normal((64, 8)).astype(np.float32)
    batch = rng.standard_normal((2, 32, 4)).astype(np.float32)
    qs = [rng.standard_normal((n, 4)).astype(np.float32) for n in (5, 17)]
    cdata, _ = planted_clusters(jax.random.key(14), 96, d=4, k=2)
    return data, batch, qs, np.asarray(cdata)


def test_shims_are_exported_lazily():
    import repro_torch.cluster as cluster
    import repro_torch.core as core
    from repro_torch.cluster.kmedoids import bandit_kmedoids
    from repro_torch.core.corr_sh import corr_sh_medoid

    assert core.corr_sh_medoid is corr_sh_medoid
    assert {"corr_sh_medoid", "corr_sh_medoid_batch",
            "corr_sh_medoid_ragged"} <= set(core.__all__)
    assert cluster.bandit_kmedoids is bandit_kmedoids
    assert "bandit_kmedoids" in cluster.__all__


def test_deprecated_entrypoints_warn_once_and_match():
    from repro_torch.cluster import bandit_kmedoids
    from repro_torch.core import (corr_sh_medoid, corr_sh_medoid_batch,
                                  corr_sh_medoid_ragged)

    data, batch, qs, cdata = _inputs()
    jkey = jax.random.key(11)
    key = torch_key(jkey)
    packed, lengths = pack_queries([torch.from_numpy(q) for q in qs])
    jpacked, jlengths = jpack_queries([jnp.asarray(q) for q in qs])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    km = dict(refine_sweeps=0, max_swap_rounds=0)

    calls = {
        "corr_sh_medoid": lambda: int(corr_sh_medoid(
            torch.from_numpy(data), key, budget=16 * 64)),
        "corr_sh_medoid_batch": lambda: [int(m) for m in corr_sh_medoid_batch(
            torch.from_numpy(batch), key, budget=16 * 32)],
        "corr_sh_medoid_ragged": lambda: [int(m) for m in
                                          corr_sh_medoid_ragged(
                                              packed, lengths, key,
                                              budget=16 * 32)],
        "bandit_kmedoids": lambda: bandit_kmedoids(
            torch.from_numpy(cdata), 2, key, **km).medoids,
    }
    deprecation._reset_for_tests()
    results = {}
    for name, call in calls.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results[name] = call()
            assert call() == results[name]           # no warning this time
        dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
               and "repro_torch.api" in str(w.message)]
        assert len(dep) == 1, (name, [str(w.message) for w in caught])
        assert name in str(dep[0].message)
    deprecation._reset_for_tests()

    # the facade's answers on the same input and key
    assert results["corr_sh_medoid"] == find_medoid(
        torch.from_numpy(data), key, budget_per_arm=16).medoid
    assert results["corr_sh_medoid_batch"] == [int(m) for m in
                                               find_medoids_batch(
                                                   torch.from_numpy(batch),
                                                   key, budget_per_arm=16)]
    assert results["corr_sh_medoid_ragged"] == [int(m) for m in
                                                find_medoids_ragged(
                                                    packed, lengths, key,
                                                    budget_per_arm=16)]
    assert results["bandit_kmedoids"] == kmedoids(
        torch.from_numpy(cdata), 2, key, **km).medoids

    # JAX's shims on the same input and key
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = {
            "corr_sh_medoid": int(jcorr_sh_medoid(jnp.asarray(data), jkey,
                                                  budget=16 * 64)),
            "corr_sh_medoid_batch": [int(m) for m in jcorr_sh_medoid_batch(
                jnp.asarray(batch), jkey, budget=16 * 32)],
            "corr_sh_medoid_ragged": [int(m) for m in jcorr_sh_medoid_ragged(
                jpacked, jlengths, jkey, budget=16 * 32)],
            "bandit_kmedoids": jbandit_kmedoids(jnp.asarray(cdata), 2, jkey,
                                                **km).medoids,
        }
    jdeprecation._reset_for_tests()
    assert results == want


def test_warn_once_is_per_name():
    deprecation._reset_for_tests()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            deprecation.warn_once("a.old", "repro_torch.api.new")
            deprecation.warn_once("b.old", "repro_torch.api.new")
    deprecation._reset_for_tests()
    assert [str(w.message) for w in caught] == [
        "a.old is deprecated; use repro_torch.api.new instead",
        "b.old is deprecated; use repro_torch.api.new instead"]
    assert all(w.category is DeprecationWarning for w in caught)
