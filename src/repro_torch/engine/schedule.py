"""The paper's deterministic round schedule (shared by every workload).

Given ``(n, budget)``, the per-round sizes

    s_r  = |S_r|   (number of surviving arms)
    t_r  = clip(floor(budget / (s_r * ceil(log2 n))), 1, n)

are *deterministic Python integers* — so every round's score block
``(s_r, t_r)`` has a shape known before any data is read, and the round loop
needs no host round-trip to decide what to run next.

The logic is a line-for-line copy of ``repro/engine/schedule.py`` (the port
imports nothing of the JAX package). The port's round loop runs each round at
its exact shape; ``Schedule.stacked`` is kept so that the banded form JAX
scans over can be compared and reasoned about from the port.
"""
from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass


@dataclass(frozen=True)
class Round:
    """Static per-round schedule entry."""
    survivors: int   # s_r going *into* the round
    num_refs: int    # t_r
    exact: bool      # t_r == n -> estimates are exact, output now

    @property
    def pulls(self) -> int:
        return self.survivors * self.num_refs


def round_schedule(n: int, budget: int) -> list[Round]:
    """The paper's deterministic round schedule for (n, budget)."""
    if n < 1:
        raise ValueError("need at least one point")
    if n == 1:
        return []
    log2n = max(1, math.ceil(math.log2(n)))
    rounds: list[Round] = []
    s = n
    for _ in range(log2n):
        t = min(max(budget // (s * log2n), 1), n)
        exact = t >= n
        rounds.append(Round(survivors=s, num_refs=t, exact=exact))
        if exact or s <= 1:
            break
        s = math.ceil(s / 2)
        if s == 1:
            break
    return rounds


# ---------------------------------------------------------------------------
# stacked (scan-ready) schedule form
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StackedBand:
    """A contiguous run of rounds executed as ONE ``lax.scan`` at one static
    buffer shape.

    ``width`` is the survivor-buffer width (the arm count *entering* the
    band's first round) and ``ref_cap`` the reference-buffer width (the
    largest ``t_r`` in the band); within the band, the per-round live counts
    ``survivors``/``num_refs`` are applied as positional masks over those
    fixed-width buffers. Banding bounds the fixed-width compute overhead: a
    band of B halving rounds scores at most ``(2^B - 1)/B`` times the
    scheduled pulls of its rounds, while the scan body compiles once per
    band instead of once per round.
    """
    start: int                     # index of the band's first round
    width: int                     # static survivor-buffer width
    ref_cap: int                   # static reference-buffer width
    survivors: tuple[int, ...]     # live arm count entering each round
    num_refs: tuple[int, ...]      # t_r per round

    def __len__(self) -> int:
        return len(self.num_refs)


@dataclass(frozen=True)
class StackedSchedule:
    """Array form of a schedule for ``n`` arms: the scanned prefix (bands
    over rounds ``[0, r_stop)``) plus the static output round ``r_stop``.

    ``sizes[r]`` is the number of arms *entering* round r (``sizes[0] == n``,
    then ``ceil(size/2)`` per halving — the exact sizes the pre-scan Python
    loop materialized), so ``sizes[r_stop]`` is the static width of the
    output round's survivor set.
    """
    bands: tuple[StackedBand, ...]
    r_stop: int
    sizes: tuple[int, ...]


@dataclass(frozen=True)
class Schedule(Sequence):
    """A round schedule plus its scan-ready ``stacked()`` array form."""
    rounds: tuple[Round, ...]

    @classmethod
    def from_budget(cls, n: int, budget: int) -> "Schedule":
        return cls(tuple(round_schedule(n, budget)))

    def __len__(self) -> int:
        return len(self.rounds)

    def __getitem__(self, i):
        return self.rounds[i]

    @property
    def pulls(self) -> int:
        return sum(r.pulls for r in self.rounds)

    def stacked(self, n: int, *, band_rounds: int = 3,
                slack: int = 1) -> StackedSchedule:
        """Band the schedule for an ``n``-arm problem (see
        :class:`StackedBand`). ``band_rounds`` caps rounds per band (the
        compile-vs-compute knob: 1 = per-round shapes, no waste; large =
        one scan body, up to ``2^B/B``-fold extra scored pulls).

        ``slack > 1`` inflates every band's buffer width to
        ``min(n, slack * sizes[start])`` — headroom for margin-widened
        halving (``run_halving(widen=...)``), where a round may keep more
        than ``sizes[r+1]`` arms. The per-round scheduled live counts are
        unchanged; only the static buffer shapes grow.
        """
        if band_rounds < 1:
            raise ValueError(f"band_rounds must be >= 1, got {band_rounds}")
        if slack < 1:
            raise ValueError(f"slack must be >= 1, got {slack}")
        if not self.rounds:
            raise ValueError("empty schedule has no stacked form")
        sizes = [int(n)]
        for _ in self.rounds[:-1]:
            sizes.append(math.ceil(sizes[-1] / 2))
        r_stop = len(self.rounds) - 1
        for r, rd in enumerate(self.rounds):
            if rd.exact or sizes[r] <= 2:
                r_stop = r
                break
        bands = []
        for start in range(0, r_stop, band_rounds):
            stop = min(start + band_rounds, r_stop)
            bands.append(StackedBand(
                start=start,
                width=min(int(n), slack * sizes[start]),
                ref_cap=max(rd.num_refs for rd in self.rounds[start:stop]),
                survivors=tuple(sizes[start:stop]),
                num_refs=tuple(rd.num_refs
                               for rd in self.rounds[start:stop])))
        return StackedSchedule(bands=tuple(bands), r_stop=r_stop,
                               sizes=tuple(sizes))


def as_schedule(schedule) -> Schedule:
    """Coerce a ``Sequence[Round]`` (or ``Schedule``) to a :class:`Schedule`."""
    if isinstance(schedule, Schedule):
        return schedule
    return Schedule(tuple(schedule))


def stop_round(schedule: list[Round]) -> int:
    """Index of the round that produces the output: the first exact round or
    the first with <= 2 survivors (both static properties of the schedule —
    the engine's early-out branch never depends on data)."""
    for r, rd in enumerate(schedule):
        if rd.exact or rd.survivors <= 2:
            return r
    return len(schedule) - 1


def schedule_pulls(n: int, budget: int) -> int:
    """Total distance computations the schedule will actually perform."""
    return sum(r.pulls for r in round_schedule(n, budget))
