"""Multi-tenant scheduling policies for the continuous-batching server, the
counterpart of ``repro/serve/scheduler.py`` (pure Python; the port keeps
its own copy). They sit behind the ``policy=`` flag of
:class:`~repro_torch.launch.serve_medoid.MedoidServer`:

* :class:`FifoPolicy` — the original behavior, bit-for-bit: the oldest
  request's bucket group dispatches first (the default, so existing
  callers see no change);
* :class:`EdfPolicy` — earliest-deadline-first admission with load
  shedding: the queue is ordered by ``(deadline, -priority, arrival)``,
  the most urgent request's shape bucket dispatches next, and requests
  that *cannot* make their deadline anymore are shed at scheduling time
  instead of wasting a dispatch. "Cannot" is estimated from the live
  :class:`~repro_torch.obs.metrics.ServerMetrics` dispatch-latency
  histograms through a :class:`LatencyModel` — a bucket that has already
  been served is priced at its steady-state quantile, an unseen bucket at
  the worst observed compile-phase quantile. No observations yet means no
  shedding: the model never invents a latency.

A policy is a pure queue transformer: ``select(queue, now=..., ...)``
returns ``(batch, rest, shed)`` and never touches the device — the server
owns dispatching, accounting, and metrics.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

# Estimate callback the server hands the policy: request -> seconds one
# dispatch of its bucket is expected to take (None: no data, never shed).
EstimateFn = Callable[[object], Optional[float]]


class LatencyModel:
    """Deadline-feasibility estimates from the server's latency histograms.

    Reads the ``medoid_dispatch_seconds`` family of a
    :class:`~repro_torch.obs.metrics.ServerMetrics` bundle. For a bucket the
    server has already compiled, the estimate is the steady-phase
    ``quantile`` (falling back to that bucket's compile-phase data before
    any steady dispatch landed). For an unseen bucket the honest estimate
    is a *compile*: the worst compile-phase quantile observed across all
    buckets. Returns ``None`` when there is no applicable observation —
    the caller must treat that as "cannot estimate", not "free".
    """

    def __init__(self, metrics, *, quantile: float = 0.9):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        self.metrics = metrics
        self.quantile = quantile

    def estimate(self, bucket: str, *, compiled: bool) -> Optional[float]:
        fam = self.metrics.latency
        if compiled:
            for phase in ("steady", "compile"):
                child = fam.children.get((bucket, phase))
                if child is not None and child.count:
                    return child.quantile(self.quantile)
            return None
        worst = None
        for (_, phase), child in fam.children.items():
            if phase == "compile" and child.count:
                q = child.quantile(self.quantile)
                worst = q if worst is None else max(worst, q)
        return worst


class FifoPolicy:
    """The pre-policy scheduler, verbatim: service the oldest request's
    bucket group, up to ``max_batch`` of its bucket-mates, in arrival
    order. Deadlines and priorities are carried but ignored."""

    name = "fifo"

    def select(self, queue: Sequence, *, now: float, max_batch: int,
               bucket_key: Callable, estimate: EstimateFn):
        if not queue:
            return [], [], []
        bkey = bucket_key(queue[0])
        batch, rest = [], []
        for q in queue:
            if len(batch) < max_batch and bucket_key(q) == bkey:
                batch.append(q)
            else:
                rest.append(q)
        return batch, rest, []


class EdfPolicy:
    """Earliest-deadline-first with load shedding.

    Ordering: ``(deadline, -priority, arrival)`` — an absent deadline
    sorts last (best-effort traffic), priority breaks ties among equal
    deadlines, arrival order breaks everything else (so two undated
    equal-priority requests still serve FIFO). The most urgent request
    picks the bucket; its bucket-mates fill the batch in the same urgency
    order.

    Shedding (``shed_hopeless=True``): a request whose deadline already
    passed, or whose deadline precedes ``now + estimate(request)``, is
    removed from the queue unanswered — a dispatch it cannot use is a
    dispatch some other tenant loses. Requests the model cannot price
    (``estimate`` returns None) are never shed.
    """

    name = "edf"

    def __init__(self, *, shed_hopeless: bool = True):
        self.shed_hopeless = shed_hopeless

    @staticmethod
    def _urgency(req, seq: int):
        deadline = req.deadline_s if req.deadline_s is not None else math.inf
        return (deadline, -getattr(req, "priority", 0), seq)

    def select(self, queue: Sequence, *, now: float, max_batch: int,
               bucket_key: Callable, estimate: EstimateFn):
        shed, viable = [], []
        for q in queue:
            if self.shed_hopeless and q.deadline_s is not None:
                if q.deadline_s <= now:
                    shed.append(q)
                    continue
                est = estimate(q)
                if est is not None and now + est > q.deadline_s:
                    shed.append(q)
                    continue
            viable.append(q)
        if not viable:
            return [], [], shed
        order = sorted(range(len(viable)),
                       key=lambda i: self._urgency(viable[i], i))
        bkey = bucket_key(viable[order[0]])
        batch = [viable[i] for i in order
                 if bucket_key(viable[i]) == bkey][:max_batch]
        chosen = {q.rid for q in batch}
        rest = [q for q in viable if q.rid not in chosen]
        return batch, rest, shed


POLICIES = {"fifo": FifoPolicy, "edf": EdfPolicy}


def resolve_policy(policy):
    """``"fifo"`` / ``"edf"`` / a policy instance -> a policy instance."""
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown policy {policy!r}; one of "
                             f"{sorted(POLICIES)}") from None
    if not hasattr(policy, "select"):
        raise TypeError(f"policy must define select(), got {type(policy)!r}")
    return policy
