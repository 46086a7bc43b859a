"""Serving metrics: counters + histograms with a Prometheus text exposition,
the counterpart of ``repro/obs/metrics.py`` (the same metric names, label
sets and buckets; the port keeps its own copy).

A deliberately tiny, dependency-free metrics layer (the container has no
prometheus_client, and the serving loop only needs counters and fixed-bucket
histograms). Three pieces:

* :class:`MetricsRegistry` — named metric families (``counter`` /
  ``histogram``) with label sets, a JSON-able :meth:`~MetricsRegistry.snapshot`
  and a Prometheus text-format :meth:`~MetricsRegistry.exposition`;
* :class:`ServerMetrics` — the concrete instrument bundle of the
  continuous-batching :class:`~repro_torch.launch.serve_medoid.MedoidServer`
  (per-bucket request/dispatch counters, queue-wait / batch-occupancy /
  dispatch-latency histograms split compile-vs-steady, pulls per request);
* :func:`instrument_exposition` — the engine-wide trace/dispatch odometers
  (:mod:`repro_torch.engine.instrument`) rendered in the same text format, so the
  launch CLIs' ``--metrics-out`` files are one consistent artifact.

Everything here is host-side bookkeeping over values the engine already
produced: nothing touches a device tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional

# Default latency buckets (seconds): spans sub-ms steady-state dispatches
# through multi-second first-call compiles.
LATENCY_BUCKETS_S = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)
WAIT_BUCKETS_STEPS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
OCCUPANCY_BUCKETS = (0.25, 0.5, 0.75, 1.0)
# Winner-gap buckets (distance units): final-round runner-up minus winner.
# A near-zero gap is a *hard* query (halving barely separated the medoid);
# the histogram is the fleet's per-query hardness monitor.
GAP_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 4.0)


def _fmt(v: float) -> str:
    """Prometheus-style number formatting (integers stay integral)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _labels_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


@dataclass
class _Counter:
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up, got inc({v})")
        self.value += v


@dataclass
class _Histogram:
    bounds: tuple            # ascending upper bounds (an implicit +Inf last)
    counts: list = field(default_factory=list)   # len(bounds) + 1
    total: float = 0.0
    count: int = 0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += v
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the q-quantile from the fixed buckets
        (None with no observations; overflow-bucket mass falls back to the
        running mean, floored at the last finite bound)."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            if cum >= target:
                return float(b)
        last = float(self.bounds[-1]) if self.bounds else 0.0
        return max(last, self.total / self.count)


class _Family:
    """One named metric family: a child per label-value tuple."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: tuple = (), bounds: Optional[tuple] = None):
        self.kind, self.name, self.help = kind, name, help
        self.labelnames = tuple(labelnames)
        self.bounds = tuple(bounds) if bounds is not None else None
        self.children: dict[tuple, object] = {}

    def labels(self, *values):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        child = self.children.get(values)
        if child is None:
            child = (_Counter() if self.kind == "counter"
                     else _Histogram(self.bounds))
            self.children[values] = child
        return child

    # counter-family conveniences for the label-free case
    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


class MetricsRegistry:
    """A set of metric families with snapshot + Prometheus exposition."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def counter(self, name: str, help: str, labelnames: tuple = ()) -> _Family:
        return self._register(_Family("counter", name, help, labelnames))

    def histogram(self, name: str, help: str, labelnames: tuple = (),
                  buckets: Iterable[float] = LATENCY_BUCKETS_S) -> _Family:
        return self._register(
            _Family("histogram", name, help, labelnames,
                    bounds=tuple(sorted(float(b) for b in buckets))))

    def _register(self, fam: _Family) -> _Family:
        if fam.name in self._families:
            raise ValueError(f"metric {fam.name!r} already registered")
        self._families[fam.name] = fam
        return fam

    def snapshot(self) -> dict:
        """JSON-able state of every family (counters: value per label tuple;
        histograms: per-bucket counts + sum + count)."""
        out: dict = {}
        for fam in self._families.values():
            fd: dict = {"type": fam.kind, "help": fam.help, "series": []}
            for values, child in sorted(fam.children.items()):
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "counter":
                    fd["series"].append({"labels": labels,
                                         "value": child.value})
                else:
                    fd["series"].append({
                        "labels": labels,
                        "buckets": dict(zip([str(b) for b in fam.bounds]
                                            + ["+Inf"], child.counts)),
                        "sum": child.total, "count": child.count})
            out[fam.name] = fd
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE block per
        family, cumulative ``_bucket`` series for histograms)."""
        lines: list[str] = []
        for fam in self._families.values():
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in sorted(fam.children.items()):
                ls = _labels_str(fam.labelnames, values)
                if fam.kind == "counter":
                    lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
                    continue
                cum = 0
                for b, c in zip(fam.bounds, child.counts):
                    cum += c
                    bls = _labels_str(fam.labelnames + ("le",),
                                      values + (_fmt(b),))
                    lines.append(f"{fam.name}_bucket{bls} {cum}")
                bls = _labels_str(fam.labelnames + ("le",),
                                  values + ("+Inf",))
                lines.append(f"{fam.name}_bucket{bls} {child.count}")
                lines.append(f"{fam.name}_sum{ls} {_fmt(child.total)}")
                lines.append(f"{fam.name}_count{ls} {_fmt(child.count)}")
        return "\n".join(lines) + ("\n" if lines else "")


class ServerMetrics:
    """The MedoidServer's instrument bundle, labeled by shape bucket
    (``"<n_bucket>x<d>"``). ``phase`` on dispatch metrics separates first
    dispatches that built a program for a new signature (``compile``) from
    cached steady-state dispatches (``steady``)."""

    def __init__(self):
        self.registry = MetricsRegistry()
        r = self.registry
        self.requests = r.counter(
            "medoid_requests_total", "medoid queries admitted", ("bucket",))
        self.answered = r.counter(
            "medoid_answered_total", "medoid queries answered", ("bucket",))
        self.dispatches = r.counter(
            "medoid_dispatches_total",
            "ragged engine dispatches", ("bucket", "phase"))
        self.pulls = r.counter(
            "medoid_pulls_total",
            "scheduled distance evaluations charged to answered requests",
            ("bucket",))
        self.queue_wait = r.histogram(
            "medoid_queue_wait_steps", "scheduler steps spent queued",
            ("bucket",), buckets=WAIT_BUCKETS_STEPS)
        self.occupancy = r.histogram(
            "medoid_batch_occupancy",
            "real requests / batch slots per dispatch",
            ("bucket",), buckets=OCCUPANCY_BUCKETS)
        self.latency = r.histogram(
            "medoid_dispatch_seconds", "wall time of one ragged dispatch",
            ("bucket", "phase"), buckets=LATENCY_BUCKETS_S)
        self.winner_gap = r.histogram(
            "medoid_winner_gap",
            "final-round runner-up minus winner estimate (query hardness)",
            ("bucket",), buckets=GAP_BUCKETS)
        self.shed = r.counter(
            "medoid_shed_total",
            "requests shed unanswered (deadline hopeless at scheduling time)",
            ("bucket",))
        self.deadline = r.counter(
            "medoid_deadline_total",
            "deadlined requests answered, by whether they made it",
            ("bucket", "outcome"))

    def record_submit(self, bucket: str) -> None:
        self.requests.labels(bucket).inc()

    def record_gap(self, bucket: str, gap: float) -> None:
        """One answered query's final-round winner gap (NaN — fewer than
        two alive arms — is dropped by the histogram)."""
        self.winner_gap.labels(bucket).observe(gap)

    def record_shed(self, bucket: str) -> None:
        self.shed.labels(bucket).inc()

    def record_deadline(self, bucket: str, met: bool) -> None:
        self.deadline.labels(bucket, "met" if met else "missed").inc()

    def record_dispatch(self, bucket: str, *, wall_s: float, batch: int,
                        slots: int, pulls_per_request: int,
                        waits: Iterable[int], compiled: bool) -> None:
        """Account one served batch: ``batch`` real requests in ``slots``
        padded slots, ``compiled`` = this dispatch built a new program."""
        phase = "compile" if compiled else "steady"
        self.dispatches.labels(bucket, phase).inc()
        self.latency.labels(bucket, phase).observe(wall_s)
        self.occupancy.labels(bucket).observe(batch / max(1, slots))
        for w in waits:
            self.queue_wait.labels(bucket).observe(float(w))
        self.answered.labels(bucket).inc(batch)
        self.pulls.labels(bucket).inc(pulls_per_request * batch)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def exposition(self) -> str:
        return self.registry.exposition()


def instrument_exposition() -> str:
    """The engine-wide trace/dispatch odometers
    (:mod:`repro_torch.engine.instrument`) in Prometheus text format,
    appended to every ``--metrics-out`` file."""
    from repro_torch.engine import instrument

    c = instrument.counters()
    lines = ["# HELP engine_traces_total programs built per entry point and "
             "signature",
             "# TYPE engine_traces_total counter"]
    for kind, v in c["traces"].items():
        lines.append(f'engine_traces_total{{kind="{kind}"}} {v}')
    lines += ["# HELP engine_dispatches_total host-side dispatches per "
              "entry point",
              "# TYPE engine_dispatches_total counter"]
    for kind, v in c["dispatches"].items():
        lines.append(f'engine_dispatches_total{{kind="{kind}"}} {v}')
    return "\n".join(lines) + "\n"
