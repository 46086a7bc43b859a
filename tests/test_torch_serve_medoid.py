"""The port's continuous-batching medoid server against a live run of
``repro.launch.serve_medoid``: with an injected clock, under FIFO and EDF,
the answers and pulls per request id, the shed set, the dispatches, the
buckets and ``recompiles`` after ``warmup`` are JAX's; the CLI prints
JAX's JSON apart from its times; the quantized server's fp32 fallback;
``synthetic_trace``'s sizes; and the gap telemetry leaves answers alone.

Queries are numpy rows in general position (d >= 2), handed to both
servers; Pallas runs in interpret mode on the JAX side, so n <= 64 and
d <= 8."""
import json

import numpy as np
import pytest

from _torch_compare import case, tolerance
from repro.launch import serve_medoid as jsrv
from repro_torch.launch import serve_medoid as tsrv
from repro_torch.obs import TraceSession
from repro_torch.obs import validate as tvalidate

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

SIZES = (12, 30, 9, 20, 5, 17, 8, 25, 32, 3)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _drive(srv, clock, queries, deadlines):
    """Submit ``queries`` two per step (deadlines absolute on ``clock``,
    None for best-effort), advancing the clock one second a step, and
    drain."""
    for i in range(0, len(queries), 2):
        for j in (i, i + 1):
            if j < len(queries):
                srv.submit(queries[j], deadline_s=deadlines[j],
                           priority=j % 3)
        srv.step()
        clock.t += 1.0
    while srv.pending:
        srv.step()
        clock.t += 1.0


def _outcome(srv) -> dict:
    s = srv.stats()
    return {"answers": {r: (q.medoid, q.pulls, q.wait_steps,
                            q.deadline_met) for r, q in srv.done.items()},
            "shed_rids": sorted(srv.shed),
            "buckets": sorted(srv.buckets_seen),
            **{k: s[k] for k in ("answered", "shed", "dispatches",
                                 "distinct_buckets", "recompiles",
                                 "total_pulls", "deadlines_met",
                                 "deadlines_missed", "policy",
                                 "quant_fallbacks")}}


@pytest.mark.parametrize("policy, backend", (("fifo", "reference"),
                                             ("edf", "reference"),
                                             ("fifo", "pallas_fused_topk")))
def test_server_matches_jax(policy, backend):
    """Deadlines: some already past when their step comes (shed under
    EDF, missed under FIFO), some far ahead, some none."""
    queries = [case(n, 4, seed=100 + i) for i, n in enumerate(SIZES)]
    deadlines = [None if i % 3 == 0 else (1.5 if i % 3 == 1 else 1e6)
                 for i in range(len(SIZES))]
    out = {}
    for pkg, kw in ((jsrv, {}), (tsrv, {"device": "cpu"})):
        clock = FakeClock()
        srv = pkg.MedoidServer(budget_per_arm=10, max_batch=2, seed=4,
                               policy=policy, clock=clock, backend=backend,
                               **kw)
        srv.warmup([(n, 4) for n in SIZES])
        _drive(srv, clock, queries, deadlines)
        out[pkg] = _outcome(srv)
        gaps = [q.gap for q in srv.done.values()]
        assert all(g is not None for g in gaps)
        out[pkg, "gaps"] = np.asarray(gaps, np.float64)
    assert out[tsrv] == out[jsrv]
    assert out[tsrv]["recompiles"] == 0
    assert (out[tsrv]["shed_rids"] != []) == (policy == "edf")
    # a gap is a difference of two estimates, each held as
    # _torch_compare holds means: twice their tolerance
    rows = np.concatenate(queries)
    tol = 2 * tolerance(out[jsrv, "gaps"], "l2", rows, 1.0)
    assert (np.abs(out[tsrv, "gaps"] - out[jsrv, "gaps"]) <= tol).all()


def test_quantized_server_fallback_matches_jax():
    """bf16 with the analytic model on rows far from the origin: every
    dispatch falls back to one exact fp32 dispatch, in both packages."""
    queries = [case(n, 4, seed=120 + i) + np.float32(40.0)
               for i, n in enumerate((20, 30, 12))]
    out = {}
    for pkg, kw in ((jsrv, {}), (tsrv, {"device": "cpu"})):
        srv = pkg.MedoidServer(budget_per_arm=10, max_batch=2, seed=1,
                               precision="bf16", quant_error_model="analytic",
                               collect_gaps=False, **kw)
        srv.warmup([(32, 4)])
        for q in queries:
            srv.submit(q)
        srv.drain()
        out[pkg] = _outcome(srv)
    assert out[tsrv] == out[jsrv]
    assert out[tsrv]["quant_fallbacks"] == 2


def test_gap_collection_and_trace_keep_answers(tmp_path):
    queries = [case(n, 4, seed=140 + i) for i, n in enumerate((24, 20, 9))]
    answers = []
    for gaps, trace in ((False, None), (True, None),
                        (False, TraceSession(str(tmp_path / "t.jsonl")))):
        srv = tsrv.MedoidServer(budget_per_arm=8, max_batch=2, seed=9,
                                collect_gaps=gaps, trace=trace, device="cpu")
        for q in queries:
            srv.submit(q)
        srv.drain()
        answers.append([srv.done[r].medoid for r in sorted(srv.done)])
    trace.close()
    assert answers[0] == answers[1] == answers[2]
    assert tvalidate.validate_trace(trace.path)["selects"] == 3


@pytest.mark.parametrize("precision", ("fp32", "bf16"))
def test_padding_slots_run_nothing(precision):
    """A dispatch of 2 queries padded to 4 slots (``live=2``): the real
    slots' answers and telemetry are those of the unpadded run under the
    same key, and the padding answers 0 with rows of no alive arm."""
    import torch

    from repro_torch.core.bucketing import pack_queries
    from repro_torch.core.corr_sh import ragged_medoids
    from repro_torch.engine import rng

    queries = [torch.from_numpy(case(n, 4, seed=160 + n)) for n in (20, 13)]
    data, lengths = pack_queries(queries, pad_batch_to=4)
    key = rng.key(5, torch.device("cpu"))
    kw = dict(budget=10 * data.shape[1], telemetry=True, precision=precision)
    full = ragged_medoids(data, lengths, key, **kw)
    part = ragged_medoids(data, lengths, key, live=2, **kw)
    assert len(full) == len(part)
    for got, want in zip(part[:-1], full[:-1]):
        assert torch.equal(got[:2], want[:2])
        assert not got[2:].any() if got.dtype != torch.bool else got[2:].all()
    for k, v in part[-1].items():
        assert torch.equal(v[:2], full[-1][k][:2]), k
    pad = {k: v[2:] for k, v in part[-1].items()}
    assert (pad["alive"] == 0).all() and pad["gap"].isnan().all()
    assert torch.isinf(pad["theta_min"]).all()
    assert torch.equal(pad["pulls"], full[-1]["pulls"][2:])
    for live in (0, 5):
        with pytest.raises(ValueError, match="live"):
            ragged_medoids(data, lengths, key, live=live, **kw)


def test_admission_and_device():
    import torch

    srv = tsrv.MedoidServer(device="cpu")
    with pytest.raises(ValueError):
        srv.submit(np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        srv.submit(np.zeros((0, 4), np.float32))
    rid = srv.submit(torch.zeros(3, 4, dtype=torch.float64))
    assert srv.queue[0].data.dtype == torch.float32
    with pytest.raises(ValueError):
        srv.submit(np.zeros((3, 4), np.float32), rid=rid)
    with pytest.raises(ValueError):
        tsrv.MedoidServer(metric="nope", device="cpu")
    with pytest.raises(ValueError):
        tsrv.MedoidServer(backend="nope", device="cpu")


def test_synthetic_trace_sizes_match_jax():
    want = jsrv.synthetic_trace(6, 5, 700, 3, seed=7)
    got = tsrv.synthetic_trace(6, 5, 700, 3, seed=7, device="cpu")
    assert [tuple(q.shape) for q in got] == [tuple(q.shape) for q in want]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ("fifo", "edf"))
def test_cli_matches_jax(policy, tmp_path, capsys):
    args = ["--requests", "8", "--n-min", "8", "--n-max", "30", "--d", "6",
            "--warmup", "--policy", policy, "--deadline-frac", "0.5",
            "--deadline-s", "1000", "--budget-per-arm", "8"]
    jsrv.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tr, mx = str(tmp_path / "m.jsonl"), str(tmp_path / "m.txt")
    tsrv.main(args + ["--device", "cpu", "--trace", tr, "--metrics-out", mx,
                      "--compile-cache", str(tmp_path / "cache")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for out in (got, want):
        out.pop("wall_s")
        out["warmup"].pop("wall_s")
        out["warmup"]["buckets"] = sorted(out["warmup"]["buckets"])
    assert got == want and got["recompiles"] == 0
    assert tvalidate.main([tr, mx]) == 0
