"""Structured trace events: JSONL spans and optional ``torch.profiler``
hooks, the counterpart of ``repro/obs/trace.py`` with the same JSONL schema
(:data:`SCHEMA_VERSION`):

    {"event": "session", "seq": 0, "ts": ..., "version": 1, ...}
    {"event": "span", "name": "dispatch", "dur_s": ..., "traces": {...}, ...}
    {"event": "round", "r": 0, "survivors": 512, "num_refs": 23, ...}
    {"event": "select", "winner": 318, "pulls": 15402, ...}

Every record carries ``event``, a monotone ``seq`` and a wall ``ts``. A
span records its duration and the deltas of the engine odometers
(:mod:`repro_torch.engine.instrument`) while it was open. Round events come
from a host telemetry dict (:func:`repro_torch.obs.telemetry_to_host`);
their ``pulls`` sum to the enclosing ``select``'s, which
:mod:`repro_torch.obs.validate` checks.

Profiler hooks (both off by default):

* ``annotate=True`` wraps every span in a
  ``torch.profiler.record_function`` of the same name, so the phases line
  up with the device activities of a profile;
* ``profiler_dir=...`` runs a ``torch.profiler.profile`` (CPU, and CUDA
  where a card is present) over the whole session and writes its Chrome
  trace to ``<profiler_dir>/trace.json`` on ``close()``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import IO, Optional

from repro_torch.engine import instrument

SCHEMA_VERSION = 1


def _jsonable(v):
    """numpy and torch scalars as Python values; NaN and +-inf as null
    (JSON has no spelling for them)."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            v = v.item()
        except (TypeError, ValueError, RuntimeError):
            v = str(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class TraceSession:
    """One JSONL trace stream (the events are also kept in ``events``).
    A context manager; ``close()`` is idempotent."""

    def __init__(self, path: Optional[str] = None, *, annotate: bool = False,
                 profiler_dir: Optional[str] = None,
                 meta: Optional[dict] = None):
        self._fh: Optional[IO[str]] = open(path, "w") if path else None
        self.path = path
        self.annotate = annotate
        self.profiler_dir = profiler_dir
        self.events: list[dict] = []
        self._seq = 0
        self._closed = False
        self._prof = None
        if profiler_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self.event("session", version=SCHEMA_VERSION, **(meta or {}))

    def event(self, event: str, **fields) -> dict:
        """Append one record to the stream (and to ``events``)."""
        if self._closed:
            raise RuntimeError("TraceSession is closed")
        rec = {"event": event, "seq": self._seq, "ts": round(time.time(), 6)}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self._seq += 1
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Wrap a host-side phase: one ``span`` record on exit with
        ``dur_s`` and the odometer deltas seen while it was open."""
        ann = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            ann = record_function(name)
        t0 = time.perf_counter()
        with instrument.deltas() as d, ann:
            yield
        self.event("span", name=name, dur_s=round(time.perf_counter() - t0, 6),
                   traces=d.counters()["traces"],
                   dispatches=d.counters()["dispatches"], **fields)

    def record_rounds(self, telemetry: dict, *, slot: Optional[int] = None,
                      **fields) -> None:
        """One ``round`` event per telemetry row of a host telemetry dict
        (leaves ``(R,)``, or ``(B, R)`` with ``slot`` picking a query)."""
        tel = telemetry
        if slot is not None:
            tel = {k: v[slot] for k, v in telemetry.items()}
        rows = len(next(iter(tel.values()))) if tel else 0
        for r in range(rows):
            self.event("round", r=r, **{k: tel[k][r] for k in tel}, **fields)

    def record_result(self, result, **fields) -> None:
        """A :class:`repro_torch.api.MedoidResult`: its round rows (when it
        ran with ``telemetry=True``), then the ``select`` record whose
        ``pulls`` they sum to."""
        if getattr(result, "telemetry", None) is not None:
            self.record_rounds(result.telemetry)
        self.event("select", winner=result.medoid, pulls=result.pulls,
                   n=result.n, algo=result.algo, metric=result.metric,
                   backend=result.backend, **fields)

    def close(self) -> None:
        if self._closed:
            return
        self.event("session_end", events=self._seq)
        self._closed = True
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.profiler_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.profiler_dir, "trace.json"))
            self._prof = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
