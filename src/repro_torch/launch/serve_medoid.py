"""Continuous-batching medoid service over the ragged multi-query engine,
the counterpart of ``repro/launch/serve_medoid.py``.

An admit/step loop: clients
submit independent medoid queries (a ``(n, d)`` candidate set each, arbitrary
``n`` per request); the scheduler coalesces queued requests into power-of-two
shape buckets (:mod:`repro_torch.core.bucketing`), pads each group to a fixed slot
count, and answers a whole bucket in one ragged-engine dispatch (the same
path as :func:`repro_torch.api.find_medoids_ragged`). Every dispatch has
the same signature per bucket — ``(max_batch, n_bucket, d)`` with a
bucket-derived budget — so the engine builds at most one program per
distinct bucket and variant however traffic is shaped, which the trace
odometer (``ragged_compile_count``) shows.

Per-request accounting mirrors a serving stack: queue-wait steps, batch wall
time, and the schedule's pull count (distance evaluations) for the bucket the
request rode in. ``warmup()`` runs each expected bucket through both
program variants, base and telemetry-carrying (and the fp32 fallback of a
quantized server), before traffic arrives, so ``recompiles`` stays 0 after
it. ``compile_cache_dir=`` (CLI ``--compile-cache``) is accepted for
parity with the JAX package's persistent XLA cache and does nothing: the
port compiles no programs (its CUDA kernels persist under
``build/kernels/``).

Multi-tenant scheduling (``policy=`` / CLI ``--policy``): requests carry an
optional priority and absolute deadline; the ``"edf"`` policy serves the
earliest deadline first and sheds requests whose deadline became infeasible
(priced from the live compile-vs-steady latency histograms through
:class:`repro_torch.serve.scheduler.LatencyModel`). The default ``"fifo"`` policy
reproduces the original arrival-order behavior exactly.

Observability (see :mod:`repro_torch.obs`): every server carries a
:class:`~repro_torch.obs.metrics.ServerMetrics` bundle — per-bucket
request/answer/pull counters plus queue-wait, batch-occupancy and
compile-vs-steady dispatch-latency histograms — exposed as a JSON
:meth:`MedoidServer.metrics` snapshot and a Prometheus text
:meth:`MedoidServer.exposition` (CLI ``--metrics-out``). Passing a
:class:`~repro_torch.obs.trace.TraceSession` (CLI ``--trace``) additionally
runs every dispatch with round telemetry and streams span / round / select
events to JSONL, with per-round pull sums that reconcile with the reported
totals (``python -m repro_torch.obs.validate`` checks).

The server owns its device (``device=``, CUDA unless ``"cpu"`` is asked;
without CUDA and without ``device`` it raises): submitted queries move
there whatever their own device. Its key stream is the JAX server's: one
``key, sub = split(key)`` per dispatch, and the batch is padded to
``max_batch`` slots with dummy length-1 queries, so each slot's key is the
one JAX gives it. JAX runs the padding slots for a fixed vmapped
signature; the port's slots are a loop, so it runs only the real ones
(``ragged_medoids(..., live=)``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve_medoid --requests 24 \
      --n-min 16 --n-max 700 --d 32 --backend pallas_fused \
      --trace build/medoid_trace.jsonl --metrics-out build/medoid_metrics.txt
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import quant
from repro_torch.convert import resolve_device
from repro_torch.core.backend import get_backend, list_backends
from repro_torch.core.bucketing import (DEFAULT_MIN_BUCKET, bucket_n,
                                        pack_queries)
from repro_torch.core.corr_sh import ragged_compile_count, ragged_medoids
from repro_torch.core.distances import METRICS
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, stop_round
from repro_torch.obs import (ServerMetrics, TraceSession,
                             instrument_exposition, telemetry_to_host)
from repro_torch.serve.scheduler import LatencyModel, resolve_policy


@dataclasses.dataclass
class MedoidRequest:
    """One queued medoid query and, once answered, its result + accounting.

    ``priority`` / ``deadline_s`` feed the scheduling policy (see
    :mod:`repro_torch.serve.scheduler`): the deadline is *absolute* on the
    server's clock, priority breaks ties among equal deadlines under EDF.
    A request the scheduler gave up on (its deadline became infeasible)
    lands in ``server.shed`` with ``shed=True`` and no medoid."""
    rid: int
    data: torch.Tensor                 # (n, d) candidate set
    submit_step: int
    priority: int = 0                  # higher = more urgent (EDF tie-break)
    deadline_s: Optional[float] = None  # absolute, on the server's clock
    medoid: Optional[int] = None       # index < n once answered
    wait_steps: int = 0                # scheduler steps spent queued
    batch_wall_s: float = 0.0          # wall time of the dispatch it rode in
    pulls: int = 0                     # scheduled distance evals of that dispatch
    submit_s: float = 0.0              # server-clock admission time
    finish_s: Optional[float] = None   # server-clock answer/shed time
    shed: bool = False                 # dropped unanswered by the policy
    deadline_met: Optional[bool] = None  # answered in time? (None: no deadline)
    gap: Optional[float] = None        # final-round winner gap (hardness)

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @property
    def done(self) -> bool:
        return self.medoid is not None


class MedoidServer:
    """Continuous-batching medoid server (admit / step / drain).

    One ``step()`` asks the scheduling policy (``policy=`` — ``"fifo"``
    default, ``"edf"`` for earliest-deadline-first with load shedding, see
    :mod:`repro_torch.serve.scheduler`) which bucket group to service: the chosen
    requests share one ``(n_bucket, d)`` signature, up to ``max_batch`` of
    them, dispatched as one ragged batch padded to exactly ``max_batch``
    slots (dummy length-1 queries fill the tail, so group size never
    changes the signature). Remaining requests wait for the next step.
    """

    def __init__(self, *, metric: str = "l2", backend: str = "reference",
                 budget_per_arm: int = 24, max_batch: int = 8,
                 min_bucket: int = DEFAULT_MIN_BUCKET, seed: int = 0,
                 compile_cache_dir: Optional[str] = None,
                 trace: Optional[TraceSession] = None,
                 policy="fifo", clock=None, collect_gaps: bool = True,
                 latency_quantile: float = 0.9, precision: str = "fp32",
                 quant_error_model: str = "probe", device=None):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; one of {METRICS}")
        get_backend(backend)      # fail at construction, not mid-dispatch
        quant.check_precision(precision)
        if quant_error_model not in quant.ERROR_MODELS:
            raise ValueError(f"unknown error model {quant_error_model!r}; "
                             f"one of {quant.ERROR_MODELS}")
        self.device = resolve_device(device)
        self.metric = metric
        self.backend = backend
        # precision != "fp32" runs every dispatch on the quantized Gram
        # backend with margin-widened halving + exact fp32 verification
        # (see repro_torch.quant); a batch whose certificate fails is re-answered
        # by ONE exact fp32 dispatch with the same key, so served answers
        # are always fp32-exact. ``quant_fallbacks`` counts those re-runs.
        self.precision = precision
        self.quant_error_model = quant_error_model
        self.quant_fallbacks = 0
        self.budget_per_arm = budget_per_arm
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.queue: list[MedoidRequest] = []
        self.done: dict[int, MedoidRequest] = {}
        self.shed: dict[int, MedoidRequest] = {}
        self.dispatches = 0
        self.buckets_seen: set[tuple[int, int]] = set()   # (n_bucket, d)
        self._step = 0
        self._next_rid = 0
        self._key = rng.key(seed, self.device)
        self._recompiles = 0
        # observability: metrics are always on (host-side counters cost
        # nothing on the device path); a TraceSession additionally switches
        # every dispatch to the telemetry-carrying program variant (the
        # same answers) and streams span / round /
        # select events to JSONL. ``collect_gaps`` rides the same telemetry
        # variant WITHOUT a trace session to feed the winner-gap hardness
        # histogram (answers stay bit-identical either way).
        self.trace = trace
        self.collect_gaps = collect_gaps
        self._metrics = ServerMetrics()
        # scheduling: policy objects are pure queue transformers (see
        # repro_torch.serve.scheduler); the latency model prices a request's
        # bucket from the live compile-vs-steady dispatch histograms, and
        # the clock (monotonic unless injected — tests inject a fake) is
        # the timeline deadlines are expressed on.
        self._policy = resolve_policy(policy)
        self._clock = clock if clock is not None else time.monotonic
        self._latency_model = LatencyModel(self._metrics,
                                           quantile=latency_quantile)

    @property
    def policy(self) -> str:
        return getattr(self._policy, "name", type(self._policy).__name__)

    @property
    def _telemetry_on(self) -> bool:
        return self.trace is not None or self.collect_gaps

    # ------------------------------- admission ----------------------------
    def submit(self, data, rid: Optional[int] = None, *,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue one (n, d) query; returns its request id. Rejects empty or
        mis-shaped queries at admission (never mid-dispatch).

        ``priority`` and ``deadline_s`` (absolute, on the server's clock —
        ``now() + budget`` for a relative budget) feed the scheduling
        policy; under the default FIFO policy they are recorded but do not
        reorder anything. The query moves to the server's device."""
        if isinstance(data, torch.Tensor):
            data = data.to(device=self.device, dtype=torch.float32)
        else:
            data = torch.as_tensor(np.asarray(data, dtype=np.float32)) \
                .to(self.device)
        if data.ndim != 2:
            raise ValueError(f"query must be (n, d), got shape "
                             f"{tuple(data.shape)}")
        if data.shape[0] < 1:
            raise ValueError("all-padding query rejected: n must be >= 1")
        if rid is None:
            rid = self._next_rid
        if rid in self.done or rid in self.shed \
                or any(q.rid == rid for q in self.queue):
            raise ValueError(f"duplicate request id {rid}")
        self._next_rid = max(self._next_rid, rid) + 1
        self.queue.append(MedoidRequest(rid=rid, data=data,
                                        submit_step=self._step,
                                        priority=priority,
                                        deadline_s=deadline_s,
                                        submit_s=self._clock()))
        self._metrics.record_submit(
            self._bucket_label(*self._bucket_key(self.queue[-1])))
        return rid

    def now(self) -> float:
        """The server's clock (deadlines are absolute on this timeline)."""
        return self._clock()

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -------------------------------- warmup ------------------------------
    def warmup(self, shapes: list[tuple[int, int]]) -> dict:
        """Build the dispatch programs for each ``(n, d)`` signature by
        answering a dummy batch at that bucket, so a warmed server's first
        real ``step()`` on a known bucket builds nothing (and the CUDA
        kernels it launches are built and loaded). Warmup builds don't count
        against :attr:`recompiles`, which only tracks live dispatches.
        Returns per-bucket wall times and the traces the warmup noted."""
        timings: dict = {"buckets": {}, "traces": 0, "wall_s": 0.0}
        compiles0 = ragged_compile_count()
        t_all = time.time()
        # every program variant a live dispatch can select: base and
        # telemetry-carrying at the server's precision, and for a quantized
        # server the exact fp32 fallback (no telemetry)
        variants = [(self.precision, with_tel) for with_tel in (False, True)]
        if self.precision != "fp32":
            variants.append(("fp32", False))
        for n, d in shapes:
            n_bucket = bucket_n(max(1, int(n)), self.min_bucket)
            t0 = time.time()
            for prec, with_tel in variants:
                data, lengths = pack_queries(
                    [torch.zeros((1, int(d)), dtype=torch.float32,
                                 device=self.device)],
                    min_bucket=n_bucket, pad_batch_to=self.max_batch)
                ragged_medoids(
                    data, lengths, rng.key(0, self.device), live=1,
                    budget=self.budget_per_arm * n_bucket,
                    metric=self.metric, backend=self.backend,
                    min_bucket=self.min_bucket, telemetry=with_tel,
                    precision=prec, error_model=self.quant_error_model)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings["buckets"][f"{n_bucket}x{int(d)}"] = round(
                time.time() - t0, 4)
        timings["traces"] = ragged_compile_count() - compiles0
        timings["wall_s"] = round(time.time() - t_all, 4)
        return timings

    # ------------------------------ scheduling ----------------------------
    def _bucket_key(self, req: MedoidRequest) -> tuple[int, int]:
        return (bucket_n(req.n, self.min_bucket), int(req.data.shape[1]))

    @staticmethod
    def _bucket_label(n_bucket: int, d: int) -> str:
        return f"{n_bucket}x{d}"

    def _estimate(self, req: MedoidRequest) -> Optional[float]:
        """Seconds one dispatch of ``req``'s bucket should take (None: the
        latency model has no applicable observation yet)."""
        bkey = self._bucket_key(req)
        return self._latency_model.estimate(self._bucket_label(*bkey),
                                            compiled=bkey in self.buckets_seen)

    def step(self) -> list[MedoidRequest]:
        """Service the scheduling policy's chosen bucket group; returns the
        answered requests. Requests the policy shed (deadline infeasible)
        land in :attr:`shed` with ``shed=True``."""
        self._step += 1
        if not self.queue:
            return []
        now = self._clock()
        batch, rest, shed = self._policy.select(
            self.queue, now=now, max_batch=self.max_batch,
            bucket_key=self._bucket_key, estimate=self._estimate)
        for q in shed:
            q.shed = True
            q.finish_s = self._clock()
            q.wait_steps = self._step - q.submit_step - 1
            self.shed[q.rid] = q
            label = self._bucket_label(*self._bucket_key(q))
            self._metrics.record_shed(label)
            self._metrics.record_deadline(label, False)
            if self.trace is not None:
                self.trace.event("shed", rid=q.rid, bucket=label, n=q.n,
                                 deadline_s=q.deadline_s, step=self._step)
        self.queue = rest
        if not batch:
            return []
        bkey = self._bucket_key(batch[0])
        n_bucket, _ = bkey

        # (max_batch, n_bucket, d) with dummy length-1 tail slots: group size
        # never changes the signature
        data, lengths = pack_queries([q.data for q in batch],
                                     min_bucket=self.min_bucket,
                                     pad_batch_to=self.max_batch)
        budget = self.budget_per_arm * n_bucket
        self._key, sub = rng.split(self._key)

        label = self._bucket_label(*bkey)
        with_tel = self._telemetry_on
        compiles0 = ragged_compile_count()
        t0 = time.time()
        fellback = False
        try:
            out = ragged_medoids(
                data, lengths, sub, budget=budget, metric=self.metric,
                backend=self.backend, min_bucket=self.min_bucket,
                telemetry=with_tel, precision=self.precision,
                error_model=self.quant_error_model, live=len(batch))
            if self.precision == "fp32":
                medoids, tel = out if with_tel else (out, None)
            else:
                if with_tel:
                    medoids, verified, tel = out
                else:
                    (medoids, verified), tel = out, None
                if not bool(verified.all()):
                    # certificate failed for some slot: ONE exact fp32
                    # re-dispatch with the same key answers the whole
                    # batch; verified slots keep the (identical) quantized
                    # answer. Served answers are always fp32-exact.
                    fellback = True
                    fout = ragged_medoids(
                        data, lengths, sub, budget=budget,
                        metric=self.metric, backend=self.backend,
                        min_bucket=self.min_bucket, telemetry=False,
                        live=len(batch))
                    medoids = torch.where(verified, medoids, fout)
            medoids = medoids.tolist()               # waits for the device
        except Exception:
            # dispatch failed: requests go back to the head of the queue so
            # nothing is ever lost between `queue` and `done`
            self.queue = batch + self.queue
            raise
        wall = time.time() - t0
        traced = ragged_compile_count() - compiles0
        self._recompiles += traced

        # executed-round accounting (matches the facade and the telemetry
        # rows; identical to schedule_pulls whenever the schedule ends at
        # its output round, which round_schedule guarantees)
        rounds = round_schedule(n_bucket, budget)
        stop = stop_round(rounds)
        pulls = sum(r.pulls for r in rounds[: stop + 1])
        if self.precision != "fp32":
            # the exact verification epilogue's distance evals, plus the
            # full fp32 re-run when the certificate failed
            pulls += quant.verify_pulls(n_bucket, rounds)
            if fellback:
                self.quant_fallbacks += 1
                pulls += sum(r.pulls for r in rounds[: stop + 1])
        self.dispatches += 1
        self.buckets_seen.add(bkey)
        finish = self._clock()
        for slot, q in enumerate(batch):
            q.medoid = medoids[slot]
            q.wait_steps = self._step - q.submit_step - 1
            q.batch_wall_s = round(wall, 4)
            q.pulls = pulls
            q.finish_s = finish
            if q.deadline_s is not None:
                q.deadline_met = finish <= q.deadline_s
                self._metrics.record_deadline(label, q.deadline_met)
            self.done[q.rid] = q
        self._metrics.record_dispatch(
            label, wall_s=wall, batch=len(batch), slots=self.max_batch,
            pulls_per_request=pulls, waits=[q.wait_steps for q in batch],
            compiled=traced > 0)
        tel_host = telemetry_to_host(tel) if with_tel else None
        if tel_host is not None and len(rounds):
            # final executed round's winner gap per slot: the server's
            # per-query hardness signal (NaN — fewer than two alive arms —
            # is dropped by the histogram)
            for slot, q in enumerate(batch):
                q.gap = float(tel_host["gap"][slot, stop])
                self._metrics.record_gap(label, q.gap)
        if self.trace is not None:
            self.trace.event("span", name="dispatch", dur_s=round(wall, 6),
                             traces={"ragged": traced} if traced else {},
                             dispatches={"ragged": 1}, bucket=label,
                             batch=len(batch), step=self._step)
            if fellback:
                self.trace.event("quant_fallback", bucket=label,
                                 precision=self.precision, step=self._step)
            for slot, q in enumerate(batch):
                # per-request rows: batched queries share the schedule
                # columns but each slot's alive/theta/gap are its own
                self.trace.record_rounds(tel_host, slot=slot, rid=q.rid,
                                         bucket=label)
                self.trace.event("select", winner=q.medoid, pulls=q.pulls,
                                 n=q.n, rid=q.rid, bucket=label,
                                 wait_steps=q.wait_steps)
        return batch

    def drain(self) -> dict[int, MedoidRequest]:
        """Step until the queue is empty; returns all answered requests."""
        while self.queue:
            self.step()
        return self.done

    # ------------------------------- telemetry ----------------------------
    @property
    def recompiles(self) -> int:
        """Programs the ragged engine built during this server's dispatches
        (at most one per bucket and variant, by the fixed dispatch shape; a
        table warmed by another server only lowers it)."""
        return self._recompiles

    def stats(self) -> dict:
        lat = [q.wait_steps for q in self.done.values()]
        deadlined = [q for q in self.done.values()
                     if q.deadline_met is not None]
        return {
            "answered": len(self.done),
            "pending": len(self.queue),
            "shed": len(self.shed),
            "dispatches": self.dispatches,
            "distinct_buckets": len(self.buckets_seen),
            "recompiles": self.recompiles,
            "mean_wait_steps": round(sum(lat) / len(lat), 2) if lat else 0.0,
            "max_wait_steps": max(lat) if lat else 0,
            "total_pulls": sum(q.pulls for q in self.done.values()),
            "deadlines_met": sum(q.deadline_met for q in deadlined),
            "deadlines_missed": sum(not q.deadline_met for q in deadlined),
            "policy": self.policy,
            "backend": self.backend,
            "metric": self.metric,
            "precision": self.precision,
            "quant_fallbacks": self.quant_fallbacks,
        }

    def metrics(self) -> dict:
        """JSON-able snapshot of the per-bucket serving metrics (counters:
        value per label set; histograms: bucket counts + sum + count)."""
        return self._metrics.snapshot()

    def exposition(self) -> str:
        """Prometheus text exposition of the serving metrics, with the
        engine-wide trace/dispatch odometers appended — one artifact shows
        both per-bucket serving behavior and compile-vs-steady traffic."""
        return self._metrics.exposition() + instrument_exposition()


def synthetic_trace(num: int, n_lo: int, n_hi: int, d: int,
                    seed: int = 0, device=None) -> list[torch.Tensor]:
    """A mixed-size query stream: log-uniform n in [n_lo, n_hi], the JAX
    package's sizes exactly and its standard normal rows up to the last
    bits of ``erfinv`` (see :func:`repro_torch.engine.rng.normal`)."""
    dev = resolve_device(device)
    key = rng.key(seed, dev)
    out = []
    for i in range(num):
        u = float(rng.uniform(rng.fold_in(key, 2 * i)))
        n = max(n_lo, min(n_hi, round(math.exp(
            math.log(n_lo) + u * (math.log(n_hi) - math.log(n_lo))))))
        out.append(rng.normal(rng.fold_in(key, 2 * i + 1), (n, d)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--n-min", type=int, default=16)
    ap.add_argument("--n-max", type=int, default=512)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--metric", default="l2",
                    choices=["l1", "l2", "sql2", "cosine"])
    ap.add_argument("--backend", default="reference",
                    choices=list(list_backends()))
    ap.add_argument("--precision", default="fp32",
                    choices=list(quant.PRECISIONS),
                    help="distance precision: quantized Gram + margin-"
                         "widened halving + exact fp32 verification "
                         "(failed certificates fall back to one exact "
                         "fp32 dispatch)")
    ap.add_argument("--budget-per-arm", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--arrivals-per-step", type=int, default=4,
                    help="requests admitted between scheduler steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="fifo", choices=["fifo", "edf"],
                    help="scheduling policy: fifo (arrival order, default) "
                         "or edf (earliest-deadline-first with load "
                         "shedding)")
    ap.add_argument("--deadline-frac", type=float, default=0.0,
                    help="fraction of synthetic requests carrying a "
                         "deadline (0 disables deadlines)")
    ap.add_argument("--deadline-s", type=float, default=0.5,
                    help="relative deadline budget (seconds from admission) "
                         "for deadlined synthetic requests")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="accepted for parity with the JAX package's "
                         "persistent XLA cache; the port keeps nothing there")
    ap.add_argument("--warmup", action="store_true",
                    help="build every bucket's programs the synthetic trace "
                         "will hit before admitting any request")
    ap.add_argument("--trace", default=None, metavar="PATH", dest="trace_out",
                    help="stream span/round/select events to this JSONL file "
                         "(dispatches run with round telemetry; the answers "
                         "are the same)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition of the "
                         "serving metrics here on exit")
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: cuda)")
    args = ap.parse_args(argv)
    if args.arrivals_per_step < 1:
        ap.error("--arrivals-per-step must be >= 1")

    session = TraceSession(args.trace_out, meta={
        "workload": "serve_medoid", "backend": args.backend,
        "metric": args.metric}) if args.trace_out else None
    srv = MedoidServer(metric=args.metric, backend=args.backend,
                       budget_per_arm=args.budget_per_arm,
                       max_batch=args.max_batch, seed=args.seed,
                       compile_cache_dir=args.compile_cache,
                       trace=session, policy=args.policy,
                       precision=args.precision, device=args.device)
    trace = synthetic_trace(args.requests, args.n_min, args.n_max, args.d,
                            seed=args.seed, device=srv.device)
    warmup_stats = None
    if args.warmup:
        shapes = sorted({(q.shape[0], q.shape[1]) for q in trace})
        warmup_stats = srv.warmup(shapes)
    t0 = time.time()
    it = iter(trace)
    admitted = 0
    while admitted < len(trace) or srv.pending:
        for _ in range(args.arrivals_per_step):
            q = next(it, None)
            if q is None:
                break
            deadlined = args.deadline_frac > 0 and \
                (admitted % max(1, round(1 / args.deadline_frac))) == 0
            srv.submit(q, deadline_s=srv.now() + args.deadline_s
                       if deadlined else None,
                       priority=1 if deadlined else 0)
            admitted += 1
        srv.step()
    out = srv.stats()
    out["wall_s"] = round(time.time() - t0, 2)
    if warmup_stats is not None:
        out["warmup"] = warmup_stats
    out["schedules"] = {
        str(nb): [(r.survivors, r.num_refs)
                  for r in round_schedule(nb, args.budget_per_arm * nb)]
        for (nb, _) in sorted(srv.buckets_seen)}
    if session is not None:
        session.close()
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(srv.exposition())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
