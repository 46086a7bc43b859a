"""The port's live corpus against a live run of ``repro.serve``: seeded
mutation streams on ``reference``, ``pallas_pairwise`` and
``pallas_fused`` (version, live slots, served slot, reason, reran, pulls
and the centralities at every version), the stream CLI with ``--verify``,
the ``maintain_medoid`` facade, the scheduling policies, "no retrace on
mutate", and the device rule of the new entry points.

The centralities are sums over the live slots, held as
``_torch_compare.assert_close`` holds sums (rtol 1e-5, its floor, and the
l2 self-pair allowance once for the bootstrap's diagonal). Data is in
general position (d >= 2), where the incremental decisions cannot part on
a near-tie (ROADMAP Queue 3). Pallas runs in interpret mode on the JAX
side, so the capacity stays <= 64 and d <= 8."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import assert_close, case
from repro.serve import stream as jstream
from repro.serve.corpus import CorpusStore as JStore
from repro.serve.maintain import MaintainedMedoid as JMaintained
from repro.serve.scheduler import EdfPolicy as JEdf
from repro.serve.scheduler import FifoPolicy as JFifo
from repro.serve.scheduler import LatencyModel as JLatency
from repro.obs import ServerMetrics as JMetrics
from repro_torch import api as tapi
from repro_torch.engine import instrument
from repro_torch.obs import ServerMetrics
from repro_torch.obs import validate as tvalidate
from repro_torch.serve import (CorpusStore, EdfPolicy, FifoPolicy,
                               LatencyModel, MaintainedMedoid,
                               resolve_policy)
from repro_torch.serve import stream as tstream

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

D = 4


def _mutate(mms, rg, n_lo=6, n_hi=28):
    """One seeded mutation applied to every maintained medoid in ``mms``
    (an insert below ``n_lo`` or with probability 0.6 below ``n_hi``, else
    the deletion of a random live slot); returns their updates."""
    store = mms[0].store
    if store.n <= n_lo or (store.n < n_hi and rg.random() < 0.6):
        x = rg.normal(size=D).astype(np.float32)
        return [m.insert(x) for m in mms]
    slot = int(rg.choice(store.live_slots()))
    return [m.delete(slot) for m in mms]


def same_update(got, want) -> None:
    """The same MedoidUpdate fields (the two packages' classes differ)."""
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def same_state(got: MaintainedMedoid, want: JMaintained, metric: str):
    gs, ws = got.store, want.store
    assert gs.version == ws.version and gs.capacity == ws.capacity
    np.testing.assert_array_equal(gs.live_slots(), ws.live_slots())
    assert got.query() == want.query()
    live = gs.live_slots()
    assert_close(gs.cent.numpy()[live], np.asarray(ws.cent)[live], metric,
                 gs.snapshot(), per_value_refs=1)
    assert got.stats() == want.stats()


@pytest.mark.parametrize("backend", ("reference", "pallas_pairwise",
                                     "pallas_fused"))
def test_mutation_stream_matches_jax(backend):
    """44 mutations from 12 points in a 16-slot bucket: the corpus grows to
    32 slots on the way, and every served slot, reason and pull count is
    JAX's."""
    rg = np.random.default_rng(3)
    pts = rg.normal(size=(12, D)).astype(np.float32)
    kw = dict(metric="l2", backend=backend)
    want = JMaintained(JStore.from_points(pts, **kw), budget_per_arm=40,
                       seed=5)
    got = MaintainedMedoid(CorpusStore.from_points(pts, device="cpu", **kw),
                           budget_per_arm=40, seed=5)
    same_state(got, want, "l2")
    reasons = set()
    for _ in range(44):
        w, g = _mutate([want, got], rg)
        same_update(g, w)
        reasons.add(g.reason)
        same_state(got, want, "l2")
    assert got.store.grows == 1
    assert {"kept", "challenger"} <= reasons


@pytest.mark.parametrize("metric", ("l1", "cosine"))
def test_incumbent_deletion_and_emptying_match_jax(metric):
    """Delete the incumbent from 6 points down to 3 (two points would tie
    exactly: each one's centrality is their one distance), then empty a
    one-point corpus and insert again: ``deleted_incumbent``, ``emptied``
    and ``bootstrap`` in both."""
    rg = np.random.default_rng(7)
    pts = rg.normal(size=(6, D)).astype(np.float32)
    kw = dict(metric=metric, budget_per_arm=64, seed=2)
    want = japi.maintain_medoid(pts, **kw)
    got = tapi.maintain_medoid(pts, device="cpu", **kw)
    for _ in range(3):
        slot = got.query()[0]
        assert want.query()[0] == slot
        upd = got.delete(slot)
        same_update(upd, want.delete(slot))
        assert upd.reason == "deleted_incumbent"
        same_state(got, want, metric)
    want = japi.maintain_medoid(pts[:1], **kw)
    got = tapi.maintain_medoid(pts[:1], device="cpu", **kw)
    for step in (lambda m: m.delete(0), lambda m: m.insert(pts[1])):
        g, w = step(got), step(want)
        same_update(g, w)
    assert (g.reason, g.medoid_slot) == ("bootstrap", 0)
    assert got.stats() == want.stats()
    empty = tapi.maintain_medoid(d=3, device="cpu")
    assert empty.query() == (None, 0) and empty.store.capacity == 8


def test_quantized_store_matches_jax():
    rg = np.random.default_rng(9)
    pts = rg.normal(size=(10, D)).astype(np.float32)
    kw = dict(precision="bf16", backend="pallas_fused", budget_per_arm=40)
    want = japi.maintain_medoid(pts, **kw)
    got = tapi.maintain_medoid(pts, device="cpu", **kw)
    assert got.store.backend == want.store.backend == "quant_bf16_fused"
    for _ in range(12):
        w, g = _mutate([want, got], rg)
        same_update(g, w)
        same_state(got, want, "l2")


def test_no_retrace_within_capacity_bucket():
    """A mutation stream inside one capacity bucket builds nothing; growing
    into a new bucket is a new signature (d = 7 is this test's alone, so
    its programs have not seen these shapes)."""
    rg = np.random.default_rng(4)
    store = CorpusStore.from_points(rg.normal(size=(10, 7)), device="cpu")
    store.insert(rg.normal(size=7))
    store.delete(0)
    with instrument.deltas() as d:
        for _ in range(20):
            if store.n < 14 and rg.random() < 0.6:
                store.insert(rg.normal(size=7))
            elif store.n > 4:
                store.delete(int(rg.choice(store.live_slots())))
        assert store.capacity == 16
    assert d.trace("corpus") == 0 and d.dispatch("corpus") == 20
    with instrument.deltas() as d:
        while store.capacity == 16:
            store.insert(rg.normal(size=7))
    assert d.trace("corpus") == 2            # the grow and the insert


def test_corpus_rejects_bad_input():
    store = CorpusStore(4, device="cpu")
    with pytest.raises(ValueError):
        store.insert(np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        store.delete(0)
    with pytest.raises(ValueError):
        CorpusStore(0, device="cpu")
    with pytest.raises(ValueError):
        CorpusStore(4, metric="nope", device="cpu")
    with pytest.raises(ValueError):
        tapi.maintain_medoid(device="cpu")
    with pytest.raises(ValueError, match="corr_sh"):
        tapi.maintain_medoid(d=3, algo="exact", device="cpu")


def test_stores_own_their_device():
    """A store moves what it is handed to its own device; ``exact_state``
    and ``check_answer`` agree with the served answer."""
    pts = torch.from_numpy(case(20, 3, seed=5))
    mm = tapi.maintain_medoid(pts.numpy(), device="cpu", budget_per_arm=160)
    slot = mm.insert(pts[0] + 0.01).medoid_slot
    assert mm.store.buf.device.type == "cpu"
    want, cent = tstream.exact_state(mm.store)
    assert slot == want and tstream.check_answer(mm.store, slot)
    assert cent.shape == (21,)


def test_stream_cli_matches_jax(tmp_path, capsys):
    args = ["--steps", "40", "--n0", "12", "--d", "6", "--verify"]
    jstream.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tr, mx = str(tmp_path / "s.jsonl"), str(tmp_path / "s.txt")
    tstream.main(args + ["--device", "cpu", "--trace", tr,
                         "--metrics-out", mx])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["verified"] == 40
    assert tvalidate.main([tr, mx]) == 0
    assert tvalidate.validate_trace(tr)["selects"] == 40


def test_policies_match_jax():
    class Req:
        def __init__(self, rid, bucket, deadline_s=None, priority=0):
            self.rid, self.bucket = rid, bucket
            self.deadline_s, self.priority = deadline_s, priority

    q = [Req(0, "a"), Req(1, "b", 2.0), Req(2, "b", 9.0, 1), Req(3, "a", 0.5),
         Req(4, "b", 9.0, 2), Req(5, "a", 30.0)]
    for got_p, want_p in ((FifoPolicy(), JFifo()), (EdfPolicy(), JEdf()),
                          (EdfPolicy(shed_hopeless=False),
                           JEdf(shed_hopeless=False))):
        for est in (None, 1.5):
            outs = [p.select(q, now=1.0, max_batch=2,
                             bucket_key=lambda r: r.bucket,
                             estimate=lambda r, e=est: e)
                    for p in (got_p, want_p)]
            assert [[r.rid for r in part] for part in outs[0]] == \
                [[r.rid for r in part] for part in outs[1]]
    assert isinstance(resolve_policy("edf"), EdfPolicy)
    with pytest.raises(ValueError):
        resolve_policy("lifo")
    got_m, want_m = ServerMetrics(), JMetrics()
    for m in (got_m, want_m):
        m.record_dispatch("8x4", wall_s=0.3, batch=1, slots=2,
                          pulls_per_request=10, waits=[0], compiled=True)
    for compiled in (True, False):
        assert LatencyModel(got_m).estimate("8x4", compiled=compiled) == \
            JLatency(want_m).estimate("8x4", compiled=compiled)


def test_serving_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.cluster import ClusterStream, kmedoids_via_service
    from repro_torch.launch.serve_medoid import MedoidServer
    from repro_torch.engine import rng

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = case(20, 3)
    for call in (lambda: CorpusStore(3), lambda: CorpusStore.from_points(x),
                 lambda: MaintainedMedoid(d=3),
                 lambda: tapi.maintain_medoid(x), lambda: MedoidServer(),
                 lambda: ClusterStream(x, 2, rng.key(0)),
                 lambda: kmedoids_via_service(x, 2, rng.key(0)),
                 lambda: tstream.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
