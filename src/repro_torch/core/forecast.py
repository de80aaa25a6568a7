"""Short-horizon arrival forecasting for proactive replanning.

The drift monitor (:mod:`repro_torch.core.drift`) is *reactive*: its rate
detector fires only after arrivals have already deviated, so the replan
ladder pays the ramp's queueing damage before capacity moves.  This
module closes the PR-3 carry-over ("react before the ramp"): per-workflow
arrival counts are binned into fixed windows, smoothed by a damped
Holt-Winters recursion (level + trend + optional multiplicative seasonal
indices for diurnal traffic), and extrapolated ``lead_s`` ahead.  A
:class:`ForecastTrigger` compares the extrapolation against deployed
capacity and emits a :class:`ForecastDrift` — a ``RateDrift`` subtype the
ladder's rung mapping already understands — *before* the crossing
happens.

Two layers of hysteresis keep false forecasts from thrashing the ladder:
the trigger itself requires ``confirm`` consecutive breached polls and
then latches (re-arming only once the forecast recedes below
``rearm × capacity``), and the :class:`~repro_torch.core.replan.ReplanController`
rung cool-down applies on top unchanged.  Telemetry arrives through the
monitor: ``DriftMonitor.record_arrival`` forwards every arrival to an
attached forecaster, so the forecaster sees exactly the stream the
reactive detectors see.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from repro_torch.core.drift import RateDrift


@dataclass(frozen=True)
class ForecastConfig:
    """Forecaster + trigger knobs.

    Defaults are sized for bench-scale days (minutes, not hours): a
    10 s bin at λ = 5/s holds ~50 arrivals, so bin-count noise is ~14%
    and the damped trend needs a sustained ramp — not one hot bin — to
    project a capacity crossing.
    """

    bin_s: float = 10.0  # arrival-count bin width
    alpha: float = 0.4  # level weight
    beta: float = 0.2  # trend weight
    gamma: float = 0.15  # seasonal-index weight
    phi: float = 0.9  # trend damping per step (1.0 = undamped)
    period_bins: int = 0  # seasonal cycle length in bins (0 = off)
    min_bins: int = 6  # bins observed before forecasts are served
    lead_s: float = 60.0  # forecast horizon = required reaction lead
    # horizon the emitted drift *provisions* for (0 = lead_s): when the
    # controller's cool-down means the next chance to act is a window
    # away, sizing only lead_s ahead under-provisions the ramp — set
    # this to lead_s + cooldown so one action covers the whole window
    plan_horizon_s: float = 0.0
    margin: float = 1.0  # fire when forecast > capacity * margin
    confirm: int = 2  # consecutive breached polls before firing
    rearm: float = 0.9  # latch releases below capacity*margin*rearm
    headroom: float = 1.2  # default capacity = planned rate * headroom
    # no-chase band: suppress firing once the *measured* level is already
    # past capacity*margin*chase — the ramp has arrived, the reactive
    # detectors own the episode.  > margin so a level marginally past
    # capacity (the normal pre-ramp firing point, where the level trails
    # the forecast by about one poll) does not suppress the early fire.
    chase: float = 1.5


class HoltWinters:
    """Damped-trend Holt-Winters with optional multiplicative season.

    ``update`` ingests one observation per fixed step; ``forecast(k)``
    extrapolates k steps ahead as ``level + Σ_{i=1..k} φ^i · trend``
    (times the seasonal index of the target step), clamped at 0 —
    negative arrival rates are not a thing.
    """

    def __init__(self, alpha: float, beta: float, gamma: float = 0.0,
                 period: int = 0, phi: float = 1.0):
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.period = period
        self.phi = phi
        self.level: Optional[float] = None
        self.trend = 0.0
        self.season: List[float] = [1.0] * period if period > 0 else []
        self.count = 0

    def _sidx(self, ahead: int = 0) -> int:
        return (self.count + ahead) % self.period

    def update(self, x: float) -> None:
        s = self.season[self._sidx()] if self.period > 0 else 1.0
        x_ds = x / max(s, 1e-9)  # deseasonalized observation
        if self.level is None:
            self.level = x_ds
        else:
            prev = self.level
            self.level = (self.alpha * x_ds
                          + (1.0 - self.alpha) * (prev + self.phi * self.trend))
            self.trend = (self.beta * (self.level - prev)
                          + (1.0 - self.beta) * self.phi * self.trend)
        if self.period > 0 and self.level is not None and self.level > 1e-9:
            idx = self._sidx()
            self.season[idx] += self.gamma * (x / max(self.level, 1e-9)
                                              - self.season[idx])
        self.count += 1

    def forecast(self, k: int) -> Optional[float]:
        if self.level is None:
            return None
        damp = sum(self.phi ** i for i in range(1, k + 1))
        f = self.level + damp * self.trend
        if self.period > 0:
            f *= self.season[self._sidx(k - 1)]
        return max(f, 0.0)


class ArrivalForecaster:
    """Bins per-workflow arrivals and serves short-horizon rate forecasts.

    Implements the one-method telemetry protocol
    (:meth:`observe`) that ``DriftMonitor.record_arrival`` forwards to
    when a forecaster is attached.  Bins close lazily: an arrival (or an
    explicit :meth:`advance`, which :class:`ForecastTrigger` issues every
    poll) flushes every completed bin — including empty ones, so a
    traffic *stop* decays the forecast instead of freezing it.
    """

    def __init__(self, workflows: Iterable[str],
                 config: ForecastConfig = ForecastConfig()):
        self.config = config
        c = config
        self._hw: Dict[str, HoltWinters] = {
            w: HoltWinters(c.alpha, c.beta, c.gamma, c.period_bins, c.phi)
            for w in workflows
        }
        self._count: Dict[str, int] = {w: 0 for w in self._hw}
        self._bin_end: Dict[str, Optional[float]] = {w: None for w in self._hw}

    def _flush_until(self, workflow: str, t: float) -> None:
        """Close every bin that ends at or before ``t``."""
        end = self._bin_end[workflow]
        if end is None:
            return
        while t >= end:
            self._hw[workflow].update(self._count[workflow] / self.config.bin_s)
            self._count[workflow] = 0
            end += self.config.bin_s
        self._bin_end[workflow] = end

    def observe(self, workflow: str, t: float) -> None:
        if workflow not in self._hw:
            return
        if self._bin_end[workflow] is None:
            # align the first bin to the global grid for seasonality
            self._bin_end[workflow] = (math.floor(t / self.config.bin_s) + 1) \
                * self.config.bin_s
        self._flush_until(workflow, t)
        self._count[workflow] += 1

    def advance(self, workflow: str, t: float) -> None:
        """Flush completed (possibly empty) bins up to ``t`` without
        recording an arrival."""
        if workflow in self._hw:
            self._flush_until(workflow, t)

    def rate(self, workflow: str) -> Optional[float]:
        """Current smoothed arrival-rate level (None before any bin)."""
        hw = self._hw.get(workflow)
        return hw.level if hw is not None else None

    def bins_seen(self, workflow: str) -> int:
        hw = self._hw.get(workflow)
        return hw.count if hw is not None else 0

    def forecast_rate(self, workflow: str, horizon_s: float) -> Optional[float]:
        """Forecast rate ``horizon_s`` ahead (None until ``min_bins``
        bins have closed — cold forecasters never trigger anything)."""
        hw = self._hw.get(workflow)
        if hw is None or hw.count < self.config.min_bins:
            return None
        k = max(int(math.ceil(horizon_s / self.config.bin_s)), 1)
        return hw.forecast(k)


@dataclass(frozen=True)
class ForecastDrift(RateDrift):
    """Proactive rate drift: the *forecast*, not the live estimate,
    crossed deployed capacity.  ``observed`` carries the forecast rate —
    the target the replan must provision for — and ``expected`` the
    planned rate, so ``recommend_rung`` and ``_drifted_targets`` treat it
    like any rate excursion, just ``lead_s`` early.

    ``horizon_s`` is the *provision* horizon the target was sized for;
    ``lead_s`` is the firing horizon, which is also the event's validity:
    a forecast about ``at + lead_s`` is stale once that moment has
    passed — the live detectors have seen the real thing by then."""

    horizon_s: float = 0.0
    lead_s: float = 0.0
    capacity: float = 0.0

    @property
    def stale_after(self) -> float:
        return self.at + (self.lead_s if self.lead_s > 0 else self.horizon_s)


class ForecastTrigger:
    """Turns forecasts into replan triggers, with hysteresis.

    ``planned_lams`` is what the incumbent plan provisions for;
    ``capacity_lams`` (default ``planned × headroom``) is the rate above
    which that plan is presumed saturated.  A breach must persist for
    ``confirm`` consecutive polls, then the trigger latches per workflow
    until the forecast recedes below the re-arm band — one event per
    ramp, however often the controller polls.
    """

    def __init__(self, forecaster: ArrivalForecaster,
                 planned_lams: Dict[str, float], *,
                 headroom: float = 1.2,
                 capacity_lams: Optional[Dict[str, float]] = None):
        self.forecaster = forecaster
        self.headroom = headroom
        self.planned_lams = dict(planned_lams)
        self.capacity_lams = (dict(capacity_lams) if capacity_lams is not None
                              else {w: lam * headroom
                                    for w, lam in planned_lams.items()})
        self._breach: Dict[str, int] = {w: 0 for w in self.planned_lams}
        self._latched: set = set()
        self.fired: List[ForecastDrift] = []  # full history, for benches

    def poll(self, now: float) -> List[ForecastDrift]:
        cfg = self.forecaster.config
        out: List[ForecastDrift] = []
        for w, cap in self.capacity_lams.items():
            self.forecaster.advance(w, now)
            f = self.forecaster.forecast_rate(w, cfg.lead_s)
            if f is None or cap <= 0:
                continue
            if w in self._latched:
                if f < cap * cfg.margin * cfg.rearm:
                    self._latched.discard(w)
                    self._breach[w] = 0
                continue
            # the trigger leads, it does not chase: once the *measured*
            # level is itself deep past capacity the ramp has arrived,
            # the lead time is spent, and the reactive detectors own the
            # episode — a forecast fired now would only inflate the
            # replan target mid-distress
            level = self.forecaster.rate(w)
            if level is not None and level > cap * cfg.margin * cfg.chase:
                self._breach[w] = 0
                continue
            if f > cap * cfg.margin:
                self._breach[w] = self._breach.get(w, 0) + 1
                if self._breach[w] >= cfg.confirm:
                    self._latched.add(w)
                    planned = self.planned_lams.get(w, cap)
                    # size the replan for the worst forecast over the
                    # plan horizon, not just the firing horizon — the
                    # cool-down means there is no second chance soon
                    ph = max(cfg.plan_horizon_s, cfg.lead_s)
                    fp = self.forecaster.forecast_rate(w, ph)
                    target = max(f, fp if fp is not None else 0.0)
                    mag = abs(target - planned) / max(planned, 1e-9)
                    out.append(ForecastDrift(
                        workflow=w, at=now, magnitude=mag,
                        observed=target, expected=planned,
                        horizon_s=ph, lead_s=cfg.lead_s, capacity=cap))
            else:
                self._breach[w] = 0
        self.fired.extend(out)
        return out

    def rebase(self, planned_lams: Dict[str, float],
               capacity_lams: Optional[Dict[str, float]] = None) -> None:
        """Adopt a new plan's targets (called by ``ReplanController.adopt``):
        capacity moves with the plan and the per-workflow latches clear,
        so the *next* ramp beyond the new capacity can fire again."""
        self.planned_lams = dict(planned_lams)
        self.capacity_lams = (dict(capacity_lams) if capacity_lams is not None
                              else {w: lam * self.headroom
                                    for w, lam in planned_lams.items()})
        self._breach = {w: 0 for w in self.planned_lams}
        self._latched.clear()
