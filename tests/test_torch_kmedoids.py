"""The port's bandit k-medoids against ``repro.api.kmedoids`` on the same
numpy data and key (medoids, labels, swaps and every pull counter equal,
cost to rtol 1e-5) on the ``reference`` backend and in the degenerate
cases; plus its datasets, ARI, exact PAM, the top-2 cache summary and the
CLI. The kernel backends' cases are in ``test_torch_kmedoids_backends.py``.
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import assert_close, case, kmedoids_same_as_jax
from repro.cluster import kmedoids as jkm
from repro.cluster import metrics as jmetrics
from repro.data import medoid_datasets as jdata
from repro_torch import api as tapi
from repro_torch import cluster as tcluster
from repro_torch.cluster import kmedoids as tkm
from repro_torch.data import medoid_datasets as tdata
from repro_torch.engine import rng
from repro_torch.launch import kmedoids as tcli

pytestmark = pytest.mark.torch_port

jpam = importlib.import_module("repro.cluster.pam_exact")   # the package
#                                     re-exports a function of that name

# ------------------------------- k-medoids ---------------------------------

def test_kmedoids_matches_jax():
    x, labels = tdata.planted_clusters(1, 300, 16, 4)
    res = kmedoids_same_as_jax(x, 4, jax.random.key(2))
    assert tcluster.adjusted_rand_index(res.labels, labels) >= 0.95
    assert res.pulls == (res.build_pulls + res.assign_pulls
                         + res.refine_pulls + res.swap_pulls)


def test_degenerate_k_matches_jax():
    x = case(40, 5, seed=4)
    kmedoids_same_as_jax(x, 1, jax.random.key(3))                 # k == 1
    kmedoids_same_as_jax(x[:6], 6, jax.random.key(3))             # k == n
    one = kmedoids_same_as_jax(x[:1], 1, jax.random.key(3))       # n == 1
    assert one.medoids == [0] and one.cost == 0.0 and one.swap_pulls == 0
    kmedoids_same_as_jax(x, 3, jax.random.key(3), max_swap_rounds=0,
                         refine_sweeps=2, metric="cosine")


def test_input_validation_and_unported_options():
    x = case(10, 3)
    for bad_k in (0, 11):
        with pytest.raises(ValueError, match="1 <= k <= n"):
            tapi.kmedoids(x, bad_k, device="cpu")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        tapi.kmedoids(x[0], 1, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.kmedoids(x, 2, device="cpu", backend="nope")
    with pytest.raises(TypeError):
        tapi.kmedoids(x, 2, device="cpu", config=tapi.MedoidConfig())
    with pytest.raises(TypeError):              # no such KMedoidsConfig field
        tapi.kmedoids(x, 2, device="cpu", telemetry=True)
    with pytest.raises(TypeError):              # no such KMedoidsConfig field
        tapi.kmedoids(x, 2, device="cpu", precision="int8")
    with pytest.raises(ValueError, match="1 <= k <= n"):
        tcluster.kmedoids_via_service(x, 11, rng.key(0), device="cpu")
    assert tapi.KMedoidsConfig().__dict__ == japi.KMedoidsConfig().__dict__
    assert [f.name for f in dataclasses.fields(tkm.KMedoidsResult)] \
        == [f.name for f in dataclasses.fields(jkm.KMedoidsResult)]


def test_kmedoids_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = case(30, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.kmedoids(x, 2)
    with pytest.raises(RuntimeError):
        tcli.run(30, 3, 2, "planted")
    assert tapi.kmedoids(torch.from_numpy(x), 2).k == 2   # keeps its device


def test_custom_refiner_is_used():
    x, _ = tdata.planted_clusters(0, 120, 8, 3)
    seen = []
    direct = tkm.make_direct_refiner(metric="l2", backend="reference",
                                     budget_per_arm=20)

    def refiner(arrays, key):
        seen.append([a.shape[0] for a in arrays])
        return direct(arrays, key)

    a = tapi.kmedoids(x, 3, rng.key(1), refiner=refiner, device="cpu")
    b = tapi.kmedoids(x, 3, rng.key(1), device="cpu")
    assert seen and sum(seen[0]) == 120
    assert (a.medoids, a.refine_pulls) == (b.medoids, b.refine_pulls)


# ------------------------------ the pieces ---------------------------------

def test_uneven_sizes_equal_jax():
    for n in (2, 17, 64, 123, 700, 2000, 20000):
        for k in sorted({1, 2, 3, 8, 10} | ({n // 2, n - 1, n}
                                             if n < 1000 else set())):
            if k > n:
                continue
            assert tdata.uneven_sizes(n, k) == jdata.uneven_sizes(n, k)
    with pytest.raises(ValueError):
        tdata.uneven_sizes(3, 4)


@pytest.mark.parametrize("name", sorted(tdata.CLUSTER_DATASETS))
def test_cluster_datasets_shapes_and_labels(name):
    metric, gen = tdata.CLUSTER_DATASETS[name]
    assert metric == jdata.CLUSTER_DATASETS[name][0]
    x, labels = gen(0, 300, 24, 5)
    assert x.shape == (300, 24) and x.dtype == np.float32
    assert np.isfinite(x).all()
    assert np.bincount(labels).tolist() == jdata.uneven_sizes(300, 5)
    again, _ = gen(0, 300, 24, 5)
    np.testing.assert_array_equal(x, again)              # seeded


def test_ari_semantics_and_against_jax():
    a = [0, 0, 1, 1, 2, 2]
    assert tcluster.adjusted_rand_index(a, a) == 1.0
    assert tcluster.adjusted_rand_index(a, [2, 2, 0, 0, 1, 1]) == 1.0
    assert tcluster.adjusted_rand_index(a, [0, 1, 0, 1, 0, 1]) < 0.5
    assert tcluster.adjusted_rand_index([3], [4]) == 1.0
    with pytest.raises(ValueError, match="same points"):
        tcluster.adjusted_rand_index([0, 1], [0, 1, 2])
    gen = np.random.default_rng(0)
    for _ in range(5):
        u, v = gen.integers(0, 4, 50), gen.integers(0, 3, 50)
        assert tcluster.adjusted_rand_index(u, v) == \
            jmetrics.adjusted_rand_index(u, v)
    d = gen.random(20).astype(np.float32)
    assert tcluster.clustering_cost(d) == jmetrics.clustering_cost(d)


@pytest.mark.parametrize("metric", ("l2", "l1"))
def test_pam_exact_matches_jax(metric):
    x, _ = tdata.planted_clusters(3, 150, 6, 4)
    want = jpam.pam_exact(jnp.asarray(x), 4, metric)
    got = tcluster.pam_exact(torch.from_numpy(x), 4, metric)
    assert (got.medoids, got.swaps, got.build_medoids, got.pulls) == \
        (want.medoids, want.swaps, want.build_medoids, want.pulls)
    np.testing.assert_array_equal(got.labels, want.labels)
    # the cost holds the k medoids' own (self-pair) distances
    assert_close(np.float64(got.cost), np.float64(want.cost), metric, x, 4)
    dm = tcluster.distance_matrix(torch.from_numpy(x), metric, block=64)
    assert_close(dm, jpam.distance_matrix(x, metric), metric, x)
    assert tcluster.pam_build(dm, 4)[0] == want.build_medoids
    assert tcluster.pam_swap(dm, want.build_medoids)[0] == want.medoids
    with pytest.raises(ValueError):
        tcluster.pam_exact(torch.from_numpy(x), 151)


@pytest.mark.parametrize("k", (1, 2, 4))
def test_top2_of_matches_lax_top_k(k):
    gen = np.random.default_rng(k)
    dmat = gen.integers(0, 3, (300, k)).astype(np.float32)   # many ties
    dmat[::7, 0] = -0.0
    dmat[::5] = 0.0
    dmat[::11, -1] = -0.0
    want = jkm._top2_of(jnp.asarray(dmat))
    got = tkm._top2_of(torch.from_numpy(dmat))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(np.signbit(g.numpy()), np.signbit(w))


def test_assign_to_medoids_matches_jax():
    x, _ = tdata.planted_clusters(5, 37, 6, 3)
    meds = x[[0, 20, 36]]
    want = jkm.assign_to_medoids(x, meds, min_bucket=8)
    got = tcluster.assign_to_medoids(torch.from_numpy(x),
                                     torch.from_numpy(meds), min_bucket=8)
    np.testing.assert_array_equal(got[0], want[0])
    assert_close(got[1], want[1], "l2", x)      # the medoids' own rows: 0
    assert got[0].dtype == np.int32 and got[2] == want[2] == 64 * 3
    with pytest.raises(ValueError):
        tcluster.assign_to_medoids(torch.zeros(4), torch.zeros(2, 4))


def test_cli_on_cpu(capsys):
    tcli.main(["--device", "cpu", "--n", "300", "--d", "16", "--k", "4",
               "--dataset", "planted", "--compare"])
    out = json.loads(capsys.readouterr().out)
    assert out["ari"] >= 0.95 and out["cost_vs_pam"] <= 1.01
    assert out["pulls"] == sum(out["pulls_breakdown"].values())
    assert out["pam_pulls"] == 300 * 300 and out["device"] == "cpu"
    assert {"medoids", "cost", "swaps", "refine_updates", "pulls_ratio",
            "wall_s", "pam", "ari_vs_pam"} <= set(out)
    with pytest.raises(ValueError, match="unknown dataset"):
        tcli.run(10, 2, 2, "nope", device="cpu")
