"""Engine-wide dispatch/trace odometers (the counterpart of
``repro/engine/instrument.py``).

* ``note_trace(kind)`` — called when :mod:`repro_torch.engine.programs`
  builds a program for a new configuration (the eager port's analogue of a
  JAX trace: once per memo-table entry, never on a cached call);
* ``note_dispatch(kind)`` — called in the host-side wrapper, once per call.

Both are monotone odometers (never reset): consumers assert on *deltas*,
so independent test files and servers can't clobber each other.
"""
from __future__ import annotations

from collections import Counter

_TRACES: Counter = Counter()
_DISPATCHES: Counter = Counter()


def note_trace(kind: str) -> None:
    """Record one program build of the ``kind`` entry point."""
    _TRACES[kind] += 1


def note_dispatch(kind: str) -> None:
    """Record one host-side call into the ``kind`` entry point."""
    _DISPATCHES[kind] += 1


def trace_count(kind: str | None = None) -> int:
    """Programs traced so far — for ``kind``, or in total."""
    return _TRACES[kind] if kind is not None else sum(_TRACES.values())


def dispatch_count(kind: str | None = None) -> int:
    """Dispatches so far — for ``kind``, or in total."""
    return _DISPATCHES[kind] if kind is not None else sum(_DISPATCHES.values())


def counters() -> dict:
    """Snapshot of both odometers (per kind), for benchmark emission."""
    return {"traces": dict(sorted(_TRACES.items())),
            "dispatches": dict(sorted(_DISPATCHES.items()))}


class deltas:
    """Context helper over the monotone odometers: snapshot on enter, deltas
    on demand — so consumers stop hand-rolling ``before = trace_count(...)``
    / ``after - before`` arithmetic::

        with instrument.deltas() as d:
            find_medoid(data, key)
        assert d.trace("medoid") <= 1      # programs traced inside the block
        assert d.dispatch("medoid") == 1   # dispatches inside the block

    Deltas are readable both mid-block and after exit (exit freezes them, so
    work done later never contaminates a recorded measurement). ``counters()``
    returns the per-kind nonzero deltas in the same shape as the module-level
    :func:`counters` snapshot.
    """

    def __enter__(self) -> "deltas":
        self._t0 = Counter(_TRACES)
        self._d0 = Counter(_DISPATCHES)
        self._t1 = self._d1 = None
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = Counter(_TRACES)
        self._d1 = Counter(_DISPATCHES)

    def _now(self) -> tuple[Counter, Counter]:
        if self._t1 is not None:
            return self._t1, self._d1
        return _TRACES, _DISPATCHES

    def trace(self, kind: str | None = None) -> int:
        """Programs traced since enter — for ``kind``, or in total."""
        cur, _ = self._now()
        if kind is not None:
            return cur[kind] - self._t0[kind]
        return sum(cur.values()) - sum(self._t0.values())

    def dispatch(self, kind: str | None = None) -> int:
        """Dispatches since enter — for ``kind``, or in total."""
        _, cur = self._now()
        if kind is not None:
            return cur[kind] - self._d0[kind]
        return sum(cur.values()) - sum(self._d0.values())

    def counters(self) -> dict:
        """Per-kind nonzero deltas, same shape as the module snapshot."""
        t, d = self._now()
        return {"traces": {k: v for k, v in sorted((t - self._t0).items())},
                "dispatches": {k: v
                               for k, v in sorted((d - self._d0).items())}}
