"""Realistic arrival traffic: diurnal cycles, bursts, flash crowds, replay.

Every bench so far drove the fleet with constant-rate Poisson arrivals
(or one synthetic 2x ramp).  Real agentic traffic is none of that: it
follows a daily cycle, arrives in correlated bursts, and occasionally
spikes when something goes viral.  This module models all three as
*piecewise-constant intensities* — a :class:`TrafficModel` composes a
diurnal sinusoid, an MMPP-style on/off burst modulator and a flash-crowd
spike into one ``[(rate, duration), ...]`` segment list, the exact shape
:meth:`ClusterDriver.schedule_arrivals` already turns into a lazy
:class:`~repro_torch.workflows.runtime.ArrivalSource` (one pending loop event,
O(1) heap space).  Piecewise-constant segments keep the process exactly
analyzable: the integrated intensity of every segment is ``rate ×
duration``, which the rate-conservation property test checks empirical
counts against, and seeded draws are bit-identical run to run.

The second half is trace replay: :func:`record_trace` samples a fleet of
models into an :class:`ArrivalTrace` of ``(t, workflow, session)`` rows
(JSONL on disk, checked-in golden fixtures under ``tests/data/``), and
:func:`replay_trace` replays one through a dict of drivers sharing an
event loop — lazily by default, again with a single pending event.
"""
from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.workflows.runtime import ClusterDriver

RateSegment = Tuple[float, float]  # (rate requests/s, duration s)


# ---------------------------------------------------------------------------
# Intensity components (each emits piecewise-constant multiplier pieces)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiurnalCycle:
    """Sinusoidal day/night modulation, sampled piecewise-constant.

    The multiplier is ``1 + amplitude * sin(2π(t/period - phase))``
    evaluated at each bin midpoint, so the mean multiplier over a full
    period is 1 and the peak sits at ``t = period * (phase + 1/4)``.
    """

    period_s: float
    amplitude: float = 0.5  # 0..1: peak-to-mean modulation depth
    phase: float = 0.0  # fraction of a period
    bins: int = 48  # piecewise resolution per period

    def pieces(self, duration_s: float) -> List[RateSegment]:
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0,1], got {self.amplitude}")
        dt = self.period_s / self.bins
        out: List[RateSegment] = []
        t = 0.0
        while t < duration_s - 1e-12:
            d = min(dt, duration_s - t)
            mid = t + d / 2.0
            x = 2.0 * math.pi * (mid / self.period_s - self.phase)
            out.append((1.0 + self.amplitude * math.sin(x), d))
            t += d
        return out


@dataclass(frozen=True)
class BurstModulator:
    """MMPP-style on/off burst process: exponentially-distributed quiet
    periods (multiplier 1) alternating with exponentially-distributed
    bursts (multiplier ``factor``) — arrivals inside a burst are still
    Poisson, but counts across bursts are over-dispersed relative to a
    homogeneous process, the correlation signature of real traffic."""

    factor: float = 2.5
    mean_on_s: float = 30.0
    mean_off_s: float = 150.0

    def pieces(self, duration_s: float, rng: random.Random) -> List[RateSegment]:
        out: List[RateSegment] = []
        t, on = 0.0, False  # always start quiet: bursts are drawn, not given
        while t < duration_s - 1e-12:
            mean = self.mean_on_s if on else self.mean_off_s
            d = min(rng.expovariate(1.0 / mean), duration_s - t)
            out.append((self.factor if on else 1.0, d))
            t += d
            on = not on
        return out


@dataclass(frozen=True)
class FlashCrowd:
    """One deterministic viral spike: linear ramp to ``peak``, hold,
    linear decay back to 1 — piecewise-constant in ``steps`` stairs per
    ramp so the integrated intensity stays exact."""

    at_s: float
    peak: float = 3.0
    ramp_s: float = 30.0
    hold_s: float = 60.0
    decay_s: float = 120.0
    steps: int = 8

    def pieces(self, duration_s: float) -> List[RateSegment]:
        out: List[RateSegment] = [(1.0, self.at_s)]

        def stair(f0: float, f1: float, span: float) -> None:
            d = span / self.steps
            for i in range(self.steps):
                frac = (i + 0.5) / self.steps
                out.append((f0 + (f1 - f0) * frac, d))

        stair(1.0, self.peak, self.ramp_s)
        out.append((self.peak, self.hold_s))
        stair(self.peak, 1.0, self.decay_s)
        # clip/extend to the requested window
        total, clipped = 0.0, []
        for f, d in out:
            if total >= duration_s:
                break
            d = min(d, duration_s - total)
            clipped.append((f, d))
            total += d
        if total < duration_s:
            clipped.append((1.0, duration_s - total))
        return clipped


def _merge(pieces_list: Sequence[Sequence[RateSegment]],
           duration_s: float) -> List[RateSegment]:
    """Product of piecewise-constant factors over a common breakpoint
    grid: the output changes value wherever ANY input does."""
    cuts = {0.0, duration_s}
    starts: List[List[Tuple[float, float]]] = []
    for pieces in pieces_list:
        t, row = 0.0, []
        for value, d in pieces:
            row.append((t, value))
            t += d
            cuts.add(min(t, duration_s))
        starts.append(row)
    grid = sorted(c for c in cuts if c < duration_s)
    out: List[RateSegment] = []
    idx = [0] * len(starts)
    for j, t0 in enumerate(grid):
        t1 = grid[j + 1] if j + 1 < len(grid) else duration_s
        prod = 1.0
        for k, row in enumerate(starts):
            while idx[k] + 1 < len(row) and row[idx[k] + 1][0] <= t0 + 1e-12:
                idx[k] += 1
            prod *= row[idx[k]][1]
        if t1 - t0 > 1e-12:
            out.append((prod, t1 - t0))
    return out


@dataclass(frozen=True)
class TrafficModel:
    """One workflow's arrival intensity over a day: ``base_rate``
    modulated multiplicatively by whichever components are present.
    ``segments()`` is deterministic in ``seed`` (only the burst
    modulator draws randomness) and feeds straight into
    :meth:`ClusterDriver.schedule_arrivals`."""

    base_rate: float
    diurnal: Optional[DiurnalCycle] = None
    bursts: Optional[BurstModulator] = None
    flash: Optional[FlashCrowd] = None

    def segments(self, duration_s: float, *, seed: int = 0) -> List[RateSegment]:
        pieces: List[List[RateSegment]] = [[(self.base_rate, duration_s)]]
        if self.diurnal is not None:
            pieces.append(self.diurnal.pieces(duration_s))
        if self.bursts is not None:
            pieces.append(self.bursts.pieces(duration_s, random.Random(seed)))
        if self.flash is not None:
            pieces.append(self.flash.pieces(duration_s))
        return _merge(pieces, duration_s)

    def mean_rate(self, duration_s: float, *, seed: int = 0) -> float:
        segs = self.segments(duration_s, seed=seed)
        total = sum(r * d for r, d in segs)
        return total / max(duration_s, 1e-12)

    def peak_rate(self, duration_s: float, *, seed: int = 0) -> float:
        return max(r for r, _ in self.segments(duration_s, seed=seed))


def poisson_arrivals(segments: Sequence[RateSegment], *, seed: int = 0,
                     start: float = 0.0, rid_start: int = 0
                     ) -> Iterator[Tuple[float, int]]:
    """Seeded inhomogeneous-Poisson arrival times over piecewise-constant
    segments, as ``(t, rid)`` pairs.  Draw order matches
    :meth:`ClusterDriver.schedule_arrivals` exactly, so a trace recorded
    here replays bit-identically through the driver."""
    rng = random.Random(seed)
    rid = rid_start
    t_seg = start
    for rate, duration in segments:
        t_end = t_seg + duration
        t = t_seg
        while rate > 0:
            t += rng.expovariate(rate)
            if t >= t_end:
                break
            yield t, rid
            rid += 1
        t_seg = t_end


# ---------------------------------------------------------------------------
# Recorded traces: (t, workflow, session) rows, JSONL on disk
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceEvent:
    t: float
    workflow: str
    session: int  # per-workflow session id (the driver's request id)


@dataclass
class ArrivalTrace:
    """A recorded arrival trace, sorted by time (ties broken by workflow
    then session so replay order is total and deterministic)."""

    events: List[TraceEvent]

    def __post_init__(self) -> None:
        self.events = sorted(self.events,
                             key=lambda e: (e.t, e.workflow, e.session))

    def __len__(self) -> int:
        return len(self.events)

    @property
    def duration(self) -> float:
        return self.events[-1].t if self.events else 0.0

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.workflow] = out.get(ev.workflow, 0) + 1
        return out

    def save(self, path) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps({"t": ev.t, "workflow": ev.workflow,
                                    "session": ev.session}) + "\n")

    @staticmethod
    def load(path) -> "ArrivalTrace":
        events = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                events.append(TraceEvent(float(row["t"]), row["workflow"],
                                         int(row["session"])))
        return ArrivalTrace(events)


def record_trace(models: Dict[str, TrafficModel], duration_s: float, *,
                 seed: int = 0) -> ArrivalTrace:
    """Sample every model over one window into a single merged trace.
    Per-workflow arrival seeds follow the fleet convention
    (``seed * 1000 + k`` over sorted names, matching
    ``benchmarks.common.drive_fleet``)."""
    events: List[TraceEvent] = []
    for k, name in enumerate(sorted(models)):
        segs = models[name].segments(duration_s, seed=seed * 1000 + k)
        for t, rid in poisson_arrivals(segs, seed=seed * 1000 + k):
            events.append(TraceEvent(t, name, rid))
    return ArrivalTrace(events)


class TraceReplaySource:
    """Lazy multi-driver trace replay: ONE pending loop event (the next
    trace row) regardless of trace length, dispatching each row to its
    workflow's driver — the replay twin of
    :class:`~repro_torch.workflows.runtime.ArrivalSource`."""

    def __init__(self, drivers: Dict[str, ClusterDriver],
                 trace: ArrivalTrace, *, seed: int = 0):
        missing = sorted({e.workflow for e in trace.events} - set(drivers))
        if missing:
            raise KeyError(f"trace names workflows with no driver: {missing}")
        loops = {id(d.loop) for d in drivers.values()}
        if len(loops) > 1:
            raise ValueError("replay drivers must share one event loop")
        self._drivers = drivers
        self._loop = next(iter(drivers.values())).loop
        self._it = iter(trace.events)
        self._seed = seed
        self.scheduled = 0
        self.exhausted = False
        self._arm()

    def _arm(self) -> None:
        try:
            ev = next(self._it)
        except StopIteration:
            self.exhausted = True
            return
        self._loop.schedule(ev.t, self._fire, ev)

    def _fire(self, ev: TraceEvent) -> None:
        self.scheduled += 1
        self._arm()  # keep the stream primed before running the program
        self._drivers[ev.workflow].start_request(ev.session, seed=self._seed)


def replay_trace(drivers: Dict[str, ClusterDriver], trace: ArrivalTrace, *,
                 seed: int = 0, eager: bool = False):
    """Schedule a recorded trace onto the drivers' shared loop.  Lazy by
    default (returns the :class:`TraceReplaySource`); ``eager=True``
    pre-schedules every row and returns the count — both paths start
    each session with the same ``(rid, seed)``, so completions match
    bit-for-bit (gated by the parity test)."""
    if eager:
        missing = sorted({e.workflow for e in trace.events} - set(drivers))
        if missing:
            raise KeyError(f"trace names workflows with no driver: {missing}")
        for ev in trace.events:
            drv = drivers[ev.workflow]
            drv.loop.schedule(ev.t, drv.start_request, ev.session, seed)
        return len(trace.events)
    return TraceReplaySource(drivers, trace, seed=seed)
