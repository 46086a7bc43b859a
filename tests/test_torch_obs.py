"""The port's observability against a live run of ``repro``'s: per-round
telemetry of ``find_medoid``, ``find_medoids_batch`` and
``find_medoids_ragged`` in fp32 and bf16 (verified and on the fp32
fallback), the hardness quantities, ``round_stats`` on edge cases, and the
trace and exposition files, each checked by both packages' validators.

Tolerances: the schedule columns and ``alive`` are equal; the theta
columns are estimates held as ``_torch_compare.assert_close`` holds means
(rtol 1e-5 with its floor and the l2 self-pair allowance), and ``gap``, a
difference of two such estimates, to the sum of their two tolerances. The
hardness quantities: the sorted centralities ``theta``, ``sigma`` and
``rho`` within that tolerance, the gaps ``delta`` (differences of two
centralities) within the sum of theirs, and ``h2`` and ``h2_tilde``
against JAX's own values within rtol 1e-5 plus the relative error that the
gaps' and ``rho``'s tolerances carry into their terms (the smallest gap's
sets it). A gap of ~1e-3 of the centralities (n = 60) turns their rtol
1e-5 into ~1e-2 on ``h2``, so a flat rtol on ``h2`` would test the
summation order, not the port. Where the smallest gap lies within its
tolerance ``h2`` has no bound, and only the gaps are held: the
``find_medoid`` cases on l2 (the self-pair allowance) and on the shifted
cosine rows; ``test_hardness_matches_jax`` holds ``h2`` and ``h2_tilde``
for every metric. ``rho`` is a deviation of distance differences over
``sigma``, so it is held to twice one distance's tolerance over ``sigma``.
For cosine, ``1 - cos`` is formed next to 1.0, so every distance carries
an absolute error of a few fp32 ulps of 1.0 whatever its size: cosine
values get an absolute 8 eps on top (the bf16 fallback's rows, shifted 40
from the origin, have cosine distances ~1e-4). Pallas runs in interpret
mode on the JAX side, so n <= 64 and d <= 8."""
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import RTOL, case, tolerance, torch_key
from repro.core import hardness as jhard
from repro.obs import TraceSession as JTrace
from repro.obs import telemetry as jtel
from repro.obs import validate as jvalidate
from repro_torch import api as tapi
from repro_torch.core import hardness as thard
from repro_torch.engine import instrument, programs
from repro_torch.obs import TraceSession, ServerMetrics
from repro_torch.obs import telemetry as ttel
from repro_torch.obs import validate as tvalidate

pytestmark = [pytest.mark.torch_port, pytest.mark.obs]

SCHEDULE = ("survivors", "num_refs", "pulls", "budget_frac", "alive")
THETA = ("theta_min", "theta_med", "theta_max")
# (precision, error model, shift): verified bf16 on data near the origin;
# the analytic model on rows far from it overflows every widened set, so
# bf16 falls back to the same-key fp32 re-run (see test_torch_quant.py)
MODES = {"fp32": ("fp32", "probe", 0.0),
         "bf16": ("bf16", "probe", 0.0),
         "bf16_fallback": ("bf16", "analytic", 40.0)}


EPS32 = float(np.finfo(np.float32).eps)


def _tol(want, metric: str, rows: np.ndarray) -> np.ndarray:
    """Allowed |got - want| for estimates and centralities (see the module
    docstring)."""
    tol = tolerance(np.asarray(want), metric, rows, 1.0)
    return tol + (8 * EPS32 if metric == "cosine" else 0.0)


def _close(got, want, metric: str, rows: np.ndarray) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    tol = _tol(want, metric, rows)
    assert (err <= tol).all(), (float(err.max()), float(tol.min()))


def same_telemetry(got: dict, want: dict, metric: str,
                   rows: np.ndarray) -> None:
    """Schedule columns and ``alive`` equal, with equal dtypes and shapes;
    the theta columns within the module docstring's tolerances."""
    assert list(got) == list(jtel.FIELDS) and set(want) == set(jtel.FIELDS)
    for k in jtel.FIELDS:
        a, b = np.asarray(want[k]), got[k]
        assert isinstance(b, np.ndarray)
        assert (b.dtype, b.shape) == (a.dtype, a.shape), k
    for k in SCHEDULE:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in THETA:
        _close(got[k], want[k], metric, rows)
    tol = 2 * _tol(want["theta_max"], metric, rows)
    jg = np.asarray(want["gap"])
    assert (np.isnan(got["gap"]) == np.isnan(jg)).all()
    fin = ~np.isnan(jg)
    assert (np.abs(got["gap"][fin] - jg[fin]) <= tol[fin]).all()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("metric, backend", (("l2", "reference"),
                                             ("l1", "pallas_fused"),
                                             ("cosine", "pallas_fused_topk")))
def test_find_medoid_telemetry_matches_jax(metric, backend, mode):
    precision, model, shift = MODES[mode]
    x = case(60, 5, seed=3) + np.float32(shift)
    jk = jax.random.key(11)
    kw = dict(metric=metric, backend=backend, budget_per_arm=10,
              precision=precision, quant_error_model=model)
    want = japi.find_medoid(x, jk, telemetry=True, **kw)
    got = tapi.find_medoid(x, torch_key(jk), telemetry=True, device="cpu",
                           **kw)
    off = tapi.find_medoid(x, torch_key(jk), device="cpu", **kw)
    assert (got.medoid, got.pulls, got.verified, got.rounds) == \
        (want.medoid, want.pulls, want.verified, want.rounds)
    assert (off.medoid, off.pulls, off.verified) == \
        (got.medoid, got.pulls, got.verified)
    assert got.verified is (None if precision == "fp32"
                            else mode == "bf16")
    same_telemetry(got.telemetry, want.telemetry, metric, x)
    assert int(got.telemetry["pulls"].sum()) == sum(s * t
                                                   for s, t in got.rounds)
    hs = thard.hardness_stats(torch.from_numpy(x), metric=metric)
    assert got.hardness == {"delta2": float(hs.delta[1]),
                            "sigma": float(hs.sigma), "h2": float(hs.h2),
                            "h2_tilde": float(hs.h2_tilde)}
    assert set(got.hardness) == set(want.hardness)
    same_hardness(hs, jhard.hardness_stats(x, metric=metric), metric, x)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_and_ragged_telemetry_match_jax(mode):
    precision, model, shift = MODES[mode]
    kw = dict(budget_per_arm=9, precision=precision, quant_error_model=model,
              telemetry=True)
    batch = np.stack([case(40, 4, seed=20 + i) + np.float32(shift)
                      for i in range(3)])
    jk = jax.random.key(21)
    wm, wt = japi.find_medoids_batch(batch, jk, **kw)
    gm, gt = tapi.find_medoids_batch(batch, torch_key(jk), device="cpu", **kw)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    same_telemetry(gt, wt, "l2", batch.reshape(-1, 4))
    plain = tapi.find_medoids_batch(batch, torch_key(jk), device="cpu",
                                    **{**kw, "telemetry": False})
    assert torch.equal(plain, gm)

    qs = [case(m, 4, seed=30 + m) + np.float32(shift) for m in (9, 15, 30)]
    wm, wt = japi.find_medoids_ragged(qs, key=jk, backend="pallas_fused",
                                      **kw)
    gm, gt = tapi.find_medoids_ragged(qs, key=torch_key(jk), device="cpu",
                                      backend="pallas_fused", **kw)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    same_telemetry(gt, wt, "l2", np.concatenate(qs))
    # padding: fewer alive arms than scheduled survivors in round 0
    assert (gt["alive"][:, 0] == [9, 15, 30]).all()


def test_single_point_and_kmedoids_surface_match_jax():
    got = tapi.find_medoid(np.zeros((1, 3), np.float32), telemetry=True,
                           device="cpu")
    want = japi.find_medoid(np.zeros((1, 3), np.float32), telemetry=True)
    assert (got.medoid, got.pulls, got.hardness) == (0, 0, None) == \
        (want.medoid, want.pulls, want.hardness)
    same_telemetry(got.telemetry, want.telemetry, "l2", np.zeros((1, 3)))
    for call in (japi.find_medoid, tapi.find_medoid):
        with pytest.raises(ValueError, match="corr_sh"):
            call(case(8, 2), telemetry=True, algo="exact",
                 **({"device": "cpu"} if call is tapi.find_medoid else {}))


def _max_rel(w: np.ndarray, t: np.ndarray) -> float:
    """The largest relative error of ``1 / g**2`` over gaps ``g`` with
    ``|g - w| <= t`` (every ``w > t``)."""
    return float(np.max(np.maximum((w / (w - t)) ** 2 - 1,
                                   1 - (w / (w + t)) ** 2)))


def same_hardness(got, want, metric: str, x: np.ndarray,
                  require_h2: bool = False) -> None:
    """Port's HardnessStats against JAX's (see the module docstring);
    ``h2`` and ``h2_tilde`` are held where every gap and rho lies above its
    tolerance, and must be with ``require_h2``."""
    theta = np.asarray(want.theta)
    tol = _tol(theta, metric, x)
    _close(got.theta, theta, metric, x)
    _close(got.sigma, want.sigma, metric, x)
    one = _tol(np.asarray([theta.max()]), metric, x)[0]   # one distance
    rho = np.asarray(want.rho).astype(np.float64)
    rho_tol = 2 * one / float(want.sigma) + RTOL * np.abs(rho)
    assert (np.abs(got.rho.numpy() - rho) <= rho_tol).all()
    gaps = np.asarray(want.delta).astype(np.float64)
    dtol = tol + tol[0]
    assert (np.abs(got.delta.numpy() - gaps) <= dtol).all()
    # h2 = max_i i / delta_i^2 and h2_tilde = max_k k * q_(k), q = rho^2 /
    # delta^2 in descending order: both move by at most the largest
    # relative error of their terms, set by the smallest gap's tolerance
    w, t, r, rt = gaps[1:], dtol[1:], rho[1:], rho_tol[1:]
    if not ((w > t).all() and (r > rt).all()):
        assert not require_h2, "a gap or rho within its tolerance"
        return
    e_h2 = _max_rel(w, t)
    e_ht = float(np.max(np.maximum(
        ((r + rt) / r) ** 2 * (w / (w - t)) ** 2 - 1,
        1 - ((r - rt) / r) ** 2 * (w / (w + t)) ** 2)))
    for name, e in (("h2", e_h2), ("h2_tilde", e_ht)):
        g, j = float(getattr(got, name)), float(getattr(want, name))
        assert abs(g - j) <= (e + RTOL) * j, (name, g, j, e)


@pytest.mark.parametrize("metric", ("l1", "l2", "sql2", "cosine"))
def test_hardness_matches_jax(metric):
    x = case(48, 6, seed=40, positive=metric == "cosine")
    want = jhard.hardness_stats(x, metric=metric)
    got = thard.hardness_stats(torch.from_numpy(x), metric=metric)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    same_hardness(got, want, metric, x, require_h2=True)
    # the bound, from the port's own stats by JAX's formula
    h2t, sigma = float(got.h2_tilde), float(got.sigma)
    bound = min(1.0, 3 * np.log2(48) * np.exp(
        -480 / (16 * h2t * sigma ** 2 * np.log2(48))))
    assert float(thard.predicted_error_bound(48, 480, got)) == \
        pytest.approx(bound, rel=RTOL)


@pytest.mark.parametrize("theta", (
    [3.0, 1.0, 2.0, 5.0],
    [np.inf, 2.0, np.inf, np.inf],          # one alive arm: gap +inf
    [np.inf, np.inf, np.inf],               # none alive: gap NaN
    [0.0, -0.0, 1.0, np.inf, 1.0],          # signed zeros, ties
    [np.nan, 1.0, np.inf, -2.0]))           # NaN sorts after +inf
def test_round_stats_matches_jax(theta):
    t = np.asarray(theta, np.float32)
    want = {k: np.asarray(v) for k, v in jtel.round_stats(t).items()}
    got = {k: v.numpy() for k, v in
           ttel.round_stats(torch.from_numpy(t)).items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_telemetry_variant_is_its_own_program():
    x = torch.from_numpy(case(24, 3, seed=50))
    with instrument.deltas() as dl:
        for tel in (False, True, True):
            programs.medoid_program(budget=24 * 13, telemetry=tel)(
                x, torch_key(jax.random.key(0)))
    assert dl.trace("medoid") == 2
    with instrument.deltas() as dl:
        programs.medoid_program(budget=24 * 13, telemetry=True)(
            x[:20], torch_key(jax.random.key(0)))
    assert dl.trace("medoid") == 1          # a new signature retraces


def _trace_files(tmp, pkg):
    """One traced find_medoid and a server's exposition, written by
    ``pkg`` ("jax" or "torch") with the same inputs."""
    x = case(33, 4, seed=60)
    if pkg == "jax":
        from repro.launch.serve_medoid import MedoidServer

        sess, srv = JTrace(str(tmp / "j.jsonl")), MedoidServer(
            budget_per_arm=8, max_batch=2)
        res = japi.find_medoid(x, jax.random.key(61), budget_per_arm=8,
                               telemetry=True)
    else:
        from repro_torch.launch.serve_medoid import MedoidServer

        sess, srv = TraceSession(str(tmp / "t.jsonl")), MedoidServer(
            budget_per_arm=8, max_batch=2, device="cpu")
        res = tapi.find_medoid(x, torch_key(jax.random.key(61)),
                               budget_per_arm=8, telemetry=True,
                               device="cpu")
    with sess:
        with sess.span("query"):
            sess.record_result(res)
    for i, n in enumerate((12, 30, 20)):
        srv.submit(case(n, 4, seed=62 + i))
    srv.drain()
    expo = tmp / f"{pkg}.txt"
    expo.write_text(srv.exposition())
    return sess.path, str(expo), sess.events


def _families(path: str) -> set:
    """(sample name, label names) of every sample of an exposition."""
    out = set()
    for line in open(path).read().splitlines():
        if line and not line.startswith("#"):
            name, _, rest = line.partition("{")
            labels = tuple(sorted(kv.split("=")[0] for kv in
                                  rest.split("}")[0].split(",") if kv)) \
                if rest else ()
            out.add((name.split()[0], labels))
    return out


def test_trace_and_exposition_validate_in_both_packages(tmp_path):
    jt, je, jev = _trace_files(tmp_path, "jax")
    tt, te, tev = _trace_files(tmp_path, "torch")
    for trace, expo in ((jt, je), (tt, te)):
        assert tvalidate.validate_trace(trace) == \
            jvalidate.validate_trace(trace)
        assert tvalidate.validate_exposition(expo) == \
            jvalidate.validate_exposition(expo)
    assert tvalidate.validate_trace(tt) == jvalidate.validate_trace(jt)
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for a, b in zip(tev, jev):
        assert set(a) == set(b), a["event"]
    # the same metric families and label names; the odometer label values
    # depend on what else ran in the process
    assert _families(te) == _families(je)
    assert tvalidate.main([tt, te]) == 0


def test_validator_rejects_bad_pull_accounting(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with TraceSession(path) as sess:
        sess.event("round", r=0, **{k: 1 for k in ttel.FIELDS})
        sess.event("select", winner=0, pulls=999)
    for check in (tvalidate.validate_trace, jvalidate.validate_trace):
        with pytest.raises(ValueError, match="round records sum"):
            check(path)
    with pytest.raises(RuntimeError):
        sess.event("late")


def test_profiler_hooks_write_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    with TraceSession(str(tmp_path / "p.jsonl"), annotate=True,
                      profiler_dir=str(prof)) as sess:
        with sess.span("query"):
            tapi.find_medoid(case(20, 3), budget_per_arm=8, device="cpu")
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "query" for e in events)
    assert tvalidate.validate_trace(sess.path)["events"] == 3


def test_server_metrics_match_jax():
    from repro.obs import ServerMetrics as JMetrics

    got, want = ServerMetrics(), JMetrics()
    for m in (got, want):
        m.record_submit("64x4")
        m.record_dispatch("64x4", wall_s=1.5, batch=2, slots=4,
                          pulls_per_request=100, waits=[0, 1], compiled=True)
        m.record_gap("64x4", 0.03)
        m.record_gap("64x4", float("nan"))
        m.record_shed("64x4")
        m.record_deadline("64x4", True)
    assert got.snapshot() == want.snapshot()
    assert got.exposition() == want.exposition()
