"""The port's service refiner against a live run of
``repro.cluster.service``: ``kmedoids_via_service`` (medoids, labels,
every pull counter, the server's dispatches), ``ClusterStream.add`` with
the direct and the service refiner, and the ``ClusterService`` routes.
Pallas runs in interpret mode on the JAX side, so n stays small."""
import jax
import numpy as np
import pytest

from _torch_compare import KMEDOIDS_FIELDS, RTOL, torch_key
from repro.cluster import service as jsvc
from repro.launch.serve_medoid import MedoidServer as JServer
from repro_torch.cluster import service as tsvc
from repro_torch.launch.serve_medoid import MedoidServer as TServer

pytestmark = [pytest.mark.torch_port, pytest.mark.cluster]


def blobs(n: int, d: int, k: int, seed: int) -> np.ndarray:
    """``k`` separated Gaussian blobs of uneven sizes, general position."""
    rg = np.random.default_rng(seed)
    centers = rg.normal(scale=6.0, size=(k, d))
    sizes = rg.multinomial(n - 2 * k, np.ones(k) / k) + 2
    return np.concatenate([c + rg.normal(size=(m, d)) for c, m in
                           zip(centers, sizes)]).astype(np.float32)


def same_fit(got, want) -> None:
    assert {f: getattr(got, f) for f in KMEDOIDS_FIELDS} == \
        {f: getattr(want, f) for f in KMEDOIDS_FIELDS}
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert abs(got.cost - want.cost) <= RTOL * abs(want.cost)


@pytest.mark.parametrize("backend", ("reference", "pallas_fused"))
def test_kmedoids_via_service_matches_jax(backend):
    x = blobs(60, 4, 3, seed=1)
    jk = jax.random.key(5)
    want, wsrv = jsvc.kmedoids_via_service(x, 3, jk, backend=backend)
    got, gsrv = tsvc.kmedoids_via_service(x, 3, torch_key(jk),
                                          backend=backend, device="cpu")
    same_fit(got, want)
    # the refine pulls are the server's scheduled pulls per request
    assert got.refine_pulls == sum(q.pulls for q in gsrv.done.values())
    gs, ws = gsrv.stats(), wsrv.stats()
    assert gs == ws and gs["answered"] > 0


def test_cluster_stream_add_matches_jax():
    x = blobs(80, 3, 3, seed=2)
    rg = np.random.default_rng(3)
    arrivals = [rg.normal(scale=6.0, size=(m, 3)).astype(np.float32)
                for m in (5, 9)]
    jk = jax.random.key(6)
    for refiner in ("direct", "service"):
        kw = {}
        if refiner == "service":
            kw = {"want": dict(refiner=jsvc.ServiceRefiner(
                JServer(budget_per_arm=20))),
                "got": dict(refiner=tsvc.ServiceRefiner(
                    TServer(budget_per_arm=20, device="cpu")))}
        want = jsvc.ClusterStream(x, 3, jk, **kw.get("want", {}))
        got = tsvc.ClusterStream(x, 3, torch_key(jk), device="cpu",
                                 **kw.get("got", {}))
        same_fit(got.fit, want.fit)
        for pts in arrivals:
            w, g = want.add(pts), got.add(pts)
            np.testing.assert_array_equal(g.pop("assigned"),
                                          np.asarray(w.pop("assigned")))
            assert g == w
            assert got.medoids == want.medoids
            np.testing.assert_array_equal(got.labels, want.labels)
        assert got.stats() == want.stats()
        assert got.cost() == pytest.approx(want.cost(), rel=RTOL)
    with pytest.raises(ValueError):
        got.add(np.zeros((2, 4), np.float32))


def test_cluster_service_routes_match_jax():
    x = blobs(60, 4, 2, seed=4)
    jk = jax.random.key(7)
    _, wsrv = jsvc.kmedoids_via_service(x, 2, jk)
    _, gsrv = tsvc.kmedoids_via_service(x, 2, torch_key(jk), device="cpu")
    want = jsvc.ClusterService(wsrv, stream=jsvc.ClusterStream(x, 2, jk))
    got = tsvc.ClusterService(gsrv, stream=tsvc.ClusterStream(
        x, 2, torch_key(jk), device="cpu"))
    assert got.routes() == want.routes() == ("/buckets", "/metrics",
                                             "/stats", "/stream")
    for route in ("/buckets", "/stream"):
        assert got.handle(route) == want.handle(route)
    gs, ws = got.handle("/stats"), want.handle("/stats")
    assert set(gs) == set(ws) and set(gs["metrics"]) == set(ws["metrics"])
    assert {k: v for k, v in gs.items() if k != "metrics"} == \
        {k: v for k, v in ws.items() if k != "metrics"}
    text = got.handle("/metrics")
    assert "# TYPE medoid_requests_total counter" in text
    with pytest.raises(KeyError, match="/nope"):
        got.handle("/nope")
