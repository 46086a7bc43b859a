"""Mutation-stream driver of the live corpus, the counterpart of
``repro/serve/stream.py``.

``python -m repro_torch.serve.stream`` feeds a seeded insert/delete stream
through a :class:`~repro_torch.serve.maintain.MaintainedMedoid`, answering a
query after every mutation, and writes a Prometheus text exposition
(``--metrics-out``) and a JSONL trace (``--trace``) that
``python -m repro_torch.obs.validate`` accepts. It runs on CUDA unless
``--device cpu`` is given.

``--verify`` re-derives every answer from scratch: after each mutation the
live snapshot is re-bootstrapped into a fresh
:class:`~repro_torch.serve.corpus.CorpusStore` (one exact O(n^2) pass) and the
served slot must equal the exact medoid of that corpus version (exact ties
and float32 accumulation residue excepted — see :func:`check_answer`).
That is the acceptance property of the incremental maintenance layer; it
holds whenever the re-run budget is in the exact regime, so with
``--verify`` and no explicit ``--budget-per-arm`` the driver picks
``B * ceil(log2 B)`` for the largest reachable bucket ``B`` automatically.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from repro_torch.core.backend import list_backends
from repro_torch.core.bucketing import DEFAULT_MIN_BUCKET, bucket_n
from repro_torch.obs import (MetricsRegistry, TraceSession,
                             instrument_exposition)
from repro_torch.serve.corpus import CorpusStore
from repro_torch.serve.maintain import MaintainedMedoid

# Pull-count buckets for the per-mutation cost histogram: spans one
# capacity-bucket n-vector (O(n)) through full re-runs (O(n log n)).
MUTATION_PULL_BUCKETS = (16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0,
                         65536.0, 262144.0)


class StreamMetrics:
    """Instrument bundle of the mutation-stream driver (same registry /
    exposition machinery as :class:`~repro_torch.obs.metrics.ServerMetrics`)."""

    def __init__(self):
        self.registry = MetricsRegistry()
        r = self.registry
        self.mutations = r.counter(
            "corpus_mutations_total", "corpus mutations applied", ("kind",))
        self.settles = r.counter(
            "corpus_settle_total",
            "how each mutation re-established the medoid", ("reason",))
        self.pulls = r.counter(
            "corpus_pulls_total",
            "distance evaluations spent maintaining the medoid", ("phase",))
        self.mutation_cost = r.histogram(
            "corpus_mutation_pulls",
            "distance evaluations charged to one mutation",
            buckets=MUTATION_PULL_BUCKETS)

    def record(self, kind: str, update) -> None:
        self.mutations.labels(kind).inc()
        self.settles.labels(update.reason).inc()
        self.mutation_cost.observe(update.pulls)

    def finalize(self, mm: MaintainedMedoid) -> None:
        s = mm.stats()
        self.pulls.labels("init").inc(s["init_pulls"])
        self.pulls.labels("incremental").inc(s["incremental_pulls"])
        self.pulls.labels("rerun").inc(s["rerun_pulls"])

    def exposition(self) -> str:
        return self.registry.exposition() + instrument_exposition()


def exact_state(store: CorpusStore):
    """From-scratch reference for ``store``'s current version: re-bootstrap
    the live rows in a fresh store on the store's device (one O(n^2) pass
    through the same :func:`~repro_torch.engine.programs.corpus_init_program`
    every store uses; the rows never leave the device) and return ``(exact medoid slot, centralities in live-slot
    order)``."""
    live = torch.from_numpy(store.live_slots()).to(store.device)
    fresh = CorpusStore.from_points(store.buf.index_select(0, live),
                                    metric=store.metric,
                                    backend=store.backend,
                                    min_bucket=store.min_bucket,
                                    device=store.device)
    cent = fresh.cent.cpu().numpy()[fresh.live_slots()]
    return int(store.live_slots()[int(cent.argmin())]), cent


def check_answer(store: CorpusStore, slot: int) -> bool:
    """Whether served ``slot`` matches the from-scratch recompute of this
    corpus version: the same slot on generic-position data, or (under
    ties / float32 accumulation residue — see the precision caveat in
    :mod:`repro_torch.serve.corpus`) a slot whose true centrality is within
    fractional tolerance of the true minimum."""
    want, cent = exact_state(store)
    if slot == want:
        return True
    pos = int(np.searchsorted(store.live_slots(), slot))
    lo = float(cent.min())
    return float(cent[pos]) <= lo + 1e-3 * max(1.0, abs(lo))


def run_stream(mm: MaintainedMedoid, *, steps: int, seed: int = 0,
               insert_frac: float = 0.7, verify: bool = False,
               metrics: StreamMetrics | None = None,
               trace: TraceSession | None = None) -> dict:
    """Apply ``steps`` seeded mutations, querying after each; returns the
    final stats dict (plus ``verified`` when ``verify`` is set). Raises
    ``AssertionError`` on the first served answer that is not the exact
    medoid of its corpus version."""
    rng = np.random.default_rng(seed)
    store = mm.store
    verified = 0
    for step in range(steps):
        do_insert = store.n == 0 or rng.random() < insert_frac
        if do_insert:
            upd = mm.insert(rng.normal(size=store.d).astype(np.float32))
            kind = "insert"
        else:
            upd = mm.delete(int(rng.choice(store.live_slots())))
            kind = "delete"
        slot, version = mm.query()
        if metrics is not None:
            metrics.record(kind, upd)
        if trace is not None:
            trace.event("mutation", kind=kind, version=version,
                        reason=upd.reason, reran=upd.reran, n=store.n)
            trace.event("select", winner=slot, pulls=int(upd.pulls),
                        n=store.n, version=version)
        if verify and store.n:
            assert check_answer(store, slot), (
                f"step {step} (version {version}): served slot {slot} is "
                f"not the exact medoid of this corpus version")
            verified += 1
    if metrics is not None:
        metrics.finalize(mm)
    out = mm.stats()
    if verify:
        out["verified"] = verified
    return out


def exact_budget_per_arm(max_n: int, min_bucket: int) -> int:
    """The per-arm budget putting every reachable bucket in the exact
    regime (``B * ceil(log2 B)`` at the largest bucket ``B``)."""
    b = bucket_n(max(2, max_n), min_bucket)
    return b * max(1, math.ceil(math.log2(b)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n0", type=int, default=24,
                    help="initial corpus size (seeded bootstrap)")
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--metric", default="l2",
                    choices=["l1", "l2", "sql2", "cosine"])
    ap.add_argument("--backend", default="reference",
                    choices=list(list_backends()))
    ap.add_argument("--insert-frac", type=float, default=0.7,
                    help="probability a mutation is an insert")
    ap.add_argument("--budget-per-arm", type=int, default=None,
                    help="re-run budget per arm (default: 24, or the exact "
                         "regime when --verify is set)")
    ap.add_argument("--min-bucket", type=int, default=DEFAULT_MIN_BUCKET)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="assert every served answer equals the exact "
                         "medoid of its corpus version (from scratch)")
    ap.add_argument("--trace", default=None, metavar="PATH", dest="trace_out",
                    help="stream mutation/select events to this JSONL file")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition here on exit")
    ap.add_argument("--device", default=None,
                    help="torch device of the store (default: cuda)")
    args = ap.parse_args(argv)

    budget = args.budget_per_arm
    if budget is None:
        budget = exact_budget_per_arm(args.n0 + args.steps,
                                      args.min_bucket) if args.verify else 24

    rng = np.random.default_rng(args.seed + 1)
    store = CorpusStore.from_points(
        rng.normal(size=(args.n0, args.d)).astype(np.float32),
        metric=args.metric, backend=args.backend, min_bucket=args.min_bucket,
        device=args.device)
    mm = MaintainedMedoid(store, budget_per_arm=budget, seed=args.seed)

    session = TraceSession(args.trace_out, meta={
        "workload": "serve_stream", "backend": args.backend,
        "metric": args.metric}) if args.trace_out else None
    metrics = StreamMetrics()
    out = run_stream(mm, steps=args.steps, seed=args.seed,
                     insert_frac=args.insert_frac, verify=args.verify,
                     metrics=metrics, trace=session)
    if session is not None:
        session.close()
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(metrics.exposition())
    out["budget_per_arm"] = budget
    print(json.dumps(out))


if __name__ == "__main__":
    main()
