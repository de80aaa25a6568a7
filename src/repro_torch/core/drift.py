"""Online drift detection over live serving telemetry.

The aggregate abstraction assumes per-LLM execution-time shares are stable
across executions (paper §2.4); this module watches that assumption at
runtime.  A :class:`DriftMonitor` ingests per-call telemetry from the
cluster executor (``ClusterDriver`` feeds it arrivals, call completions
and workflow-request completions), maintains sliding EWMA aggregates —
per-workflow arrival rate, per-(workflow, LLM) execution-time share, and
output-token summaries — and tests them against the profiled expectations
the deployment was planned for.  Sustained deviations emit *typed* drift
events, which the re-plan controller (:mod:`repro_torch.core.replan`) maps onto
its escalation ladder.

Detector shape: EWMA + relative-deviation threshold with hysteresis for
shares and token lengths (the share signal is a bounded fraction, so the
EWMA of in-band samples provably stays in band — no false triggers on
share-stable traffic), plus a CUSUM-style accumulator on inter-arrival
times for small-but-sustained rate drift.  Events fire on the rising edge
and re-arm once the metric returns inside the hysteresis band or after
:meth:`DriftMonitor.rebase`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class DriftConfig:
    """Detector knobs (thresholds are *relative* deviations).

    Defaults are sized against Poisson arrival noise: an EWMA with
    weight α has an effective window of ~2/α samples, so the relative
    standard deviation of the rate estimate is roughly sqrt(α / 2) —
    at α = 0.05 that is ~16%, making the 0.5 default threshold a >3σ
    event on share-stable traffic while a 2x ramp (+100%) still clears
    it within a few tens of arrivals.
    """

    ewma_alpha: float = 0.05  # weight of the newest sample (shares)
    slow_alpha: float = 0.02  # inter-arrival/token EWMA weight (~50-sample window)
    share_threshold: float = 0.50  # |share - expected| / max(expected, floor)
    rate_threshold: float = 0.50  # |rate - target| / target
    token_threshold: float = 0.50  # |mean_out - expected| / expected
    min_samples: int = 20  # updates before a metric may fire
    hysteresis: float = 0.5  # re-arm band as a fraction of the threshold
    share_floor: float = 0.02  # relative-deviation denominator floor
    # two-sided CUSUM over raw normalized inter-arrivals (dt·λ is Exp(1)
    # under no drift, so samples are i.i.d. with unit mean/variance):
    # slack 0.4 / limit 18 gives a stable-traffic average run length of
    # ~25k arrivals while catching a sustained 2x ramp within ~200
    cusum_slack: float = 0.4
    cusum_limit: float = 18.0
    # share/token deviations must ALSO exceed z·std(EWMA): a relative
    # threshold alone misfires on high-variance streams (token lengths
    # with CV ≈ 1), while z alone misfires on near-constant ones
    zscore_gate: float = 4.0
    # SLO-violation detector: EWMA of the per-request violation
    # indicator (completed past target, or shed at the front door);
    # fires once the smoothed violation rate crosses the threshold
    slo_violation_threshold: float = 0.2
    slo_alpha: float = 0.05


@dataclass(frozen=True)
class Expectation:
    """What the deployed plan assumed for one workflow."""

    lam: float  # planned arrival rate (requests/s)
    shares: Dict[str, float]  # llm -> profiled mean execution-time share
    out_tokens: Dict[str, float] = field(default_factory=dict)
    # request-level SLO the plan promised (0 = detector disarmed)
    slo_target: float = 0.0
    slo_class: str = ""


def expectation_from(pipeline, lam: float, stats=None, slo=None) -> Expectation:
    """Build an :class:`Expectation` from a profiled pipeline.

    ``stats`` (a :class:`repro_torch.core.aggregate.WorkflowStats`) adds the
    token-length expectations when available; without it the token
    detector stays disarmed for this workflow.  ``slo`` (a *resolved*
    :class:`repro_torch.qos.slo.SLOClass`) arms the SLO-violation detector.
    """
    shares = {m: st.mean_share for m, st in pipeline.stages.items()}
    toks: Dict[str, float] = {}
    if stats is not None:
        toks = {
            m: st.mean_output_tokens
            for m, st in stats.per_llm.items()
            if st.mean_output_tokens > 0
        }
    target, cls = 0.0, ""
    if slo is not None and slo.latency_target_s is not None:
        target, cls = slo.latency_target_s, slo.name
    return Expectation(lam=lam, shares=shares, out_tokens=toks,
                       slo_target=target, slo_class=cls)


# ---------------------------------------------------------------------------
# Typed drift events
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DriftEvent:
    workflow: str
    at: float  # simulation/wall time of the emission
    magnitude: float  # relative deviation that tripped the detector


@dataclass(frozen=True)
class RateDrift(DriftEvent):
    """Arrival rate deviates from the planned target."""

    observed: float = 0.0
    expected: float = 0.0


@dataclass(frozen=True)
class ShareDrift(DriftEvent):
    """One LLM's aggregate execution-time share deviates from profile."""

    llm: str = ""
    observed: float = 0.0
    expected: float = 0.0


@dataclass(frozen=True)
class TokenDrift(DriftEvent):
    """One LLM's output-token distribution shifted."""

    llm: str = ""
    observed: float = 0.0
    expected: float = 0.0


@dataclass(frozen=True)
class SLOViolation(DriftEvent):
    """A workflow's smoothed SLO-violation rate (requests finishing past
    their latency target, plus front-door sheds) crossed the threshold —
    the re-plan controller's fourth trigger: the allocation no longer
    covers the promised service tier."""

    slo_class: str = ""
    violation_rate: float = 0.0
    target_s: float = 0.0


# ---------------------------------------------------------------------------
# Streaming estimators
# ---------------------------------------------------------------------------


class _Ewma:
    """Exponentially-weighted mean + variance; ``value`` is None until
    the first sample so cold starts never read as drift."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value: Optional[float] = None
        self._m2: Optional[float] = None
        self.count = 0

    def update(self, x: float) -> float:
        self.count += 1
        if self.value is None:
            self.value = x
            self._m2 = x * x
        else:
            self.value += self.alpha * (x - self.value)
            self._m2 += self.alpha * (x * x - self._m2)
        return self.value

    @property
    def std_of_mean(self) -> float:
        """Standard deviation of the EWMA itself (what excursions of
        ``value`` look like under a stationary input stream)."""
        if self.value is None or self._m2 is None:
            return 0.0
        var = max(self._m2 - self.value * self.value, 0.0)
        return (var * self.alpha / (2.0 - self.alpha)) ** 0.5


class _Cusum:
    """Two-sided CUSUM over normalized inter-arrival times.

    Fed ``x = dt · λ_expected``, which is i.i.d. Exp(1) under no drift:
    the ``hi`` side accumulates evidence of arrivals coming *faster*
    than planned (``1 - x``), the ``lo`` side of them coming slower.
    """

    def __init__(self, slack: float, limit: float):
        self.slack = slack
        self.limit = limit
        self.hi = 0.0
        self.lo = 0.0

    def update(self, x_norm: float) -> bool:
        self.hi = max(0.0, self.hi + (1.0 - x_norm) - self.slack)
        self.lo = max(0.0, self.lo + (x_norm - 1.0) - self.slack)
        return max(self.hi, self.lo) >= self.limit

    def reset(self) -> None:
        self.hi = self.lo = 0.0


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------


class DriftMonitor:
    """Telemetry sink + detector bank for a fleet of workflows.

    Implements the executor-side telemetry protocol duck-typed by
    ``ClusterDriver``: :meth:`record_arrival`, :meth:`record_call`,
    :meth:`record_request_done`.  Emitted events accumulate until
    :meth:`poll` drains them.
    """

    def __init__(
        self,
        expectations: Dict[str, Expectation],
        config: DriftConfig = DriftConfig(),
        forecaster=None,
    ):
        self.config = config
        self.expectations = dict(expectations)
        # optional arrival forecaster (repro_torch.core.forecast.
        # ArrivalForecaster, duck-typed on observe()): record_arrival
        # forwards every arrival so proactive and reactive detectors see
        # the same telemetry stream
        self.forecaster = forecaster
        a = config.ewma_alpha
        self._ia: Dict[str, _Ewma] = {
            w: _Ewma(config.slow_alpha) for w in expectations
        }
        self._rate_cusum: Dict[str, _Cusum] = {
            w: _Cusum(config.cusum_slack, config.cusum_limit) for w in expectations
        }
        self._last_arrival: Dict[str, Optional[float]] = {
            w: None for w in expectations
        }
        self._share: Dict[str, Dict[str, _Ewma]] = {
            w: {m: _Ewma(a) for m in e.shares} for w, e in expectations.items()
        }
        self._tokens: Dict[str, Dict[str, _Ewma]] = {
            w: {m: _Ewma(config.slow_alpha) for m in e.out_tokens}
            for w, e in expectations.items()
        }
        self._viol: Dict[str, _Ewma] = {
            w: _Ewma(config.slo_alpha) for w in expectations
        }
        # cumulative per-workflow SLO accounting (class from expectation)
        self.slo_counters: Dict[str, Dict[str, int]] = {
            w: {"completed": 0, "violations": 0, "rejected": 0, "degraded": 0}
            for w in expectations
        }
        self._open: Dict[tuple, Dict[str, float]] = {}  # (wf, rid) -> llm busy
        self._pending: List[DriftEvent] = []
        self._active: set = set()
        self.now = 0.0
        # last corroboration verdicts (see :meth:`corroborate`)
        self.corroboration: Dict[str, Dict[str, dict]] = {}

    # -- executor-side telemetry protocol --------------------------------

    def record_arrival(self, workflow: str, t: float) -> None:
        if workflow not in self.expectations:
            return
        self.now = max(self.now, t)
        if self.forecaster is not None:
            self.forecaster.observe(workflow, t)
        last = self._last_arrival[workflow]
        self._last_arrival[workflow] = t
        if last is None:
            return
        dt = max(t - last, 1e-9)
        ia = self._ia[workflow].update(dt)
        exp = self.expectations[workflow]
        if exp.lam <= 0 or ia is None:
            return
        observed = 1.0 / ia
        rel = (observed - exp.lam) / exp.lam
        tripped = self._rate_cusum[workflow].update(dt * exp.lam)
        # arm only after TWO full EWMA windows: at one window the
        # estimate is still half-converged from its cold start and reads
        # as phantom drift (slow workflows take proportionally longer to
        # become monitorable, which is inherent, not a knob)
        if self._ia[workflow].count < self._warmup():
            return
        sev = abs(rel)
        if tripped:  # sustained small drift: force past the threshold
            sev = max(sev, self.config.rate_threshold * 1.01)
        self._edge(
            ("rate", workflow),
            sev,
            self.config.rate_threshold,
            lambda: RateDrift(
                workflow=workflow,
                at=self.now,
                magnitude=abs(rel),
                observed=observed,
                expected=exp.lam,
            ),
        )

    def record_call(self, workflow: str, llm: str, req) -> None:
        if workflow not in self.expectations:
            return
        self.now = max(self.now, req.t_done)
        busy = max(req.t_done - req.t_start_service, 0.0)
        key = (workflow, req.workflow_request)
        self._open.setdefault(key, {})
        self._open[key][llm] = self._open[key].get(llm, 0.0) + busy
        # token EWMAs are tracked for every LLM seen; the detector arms
        # once an expectation exists (from traced stats, or learned by
        # calibrate() from the live baseline)
        toks = self._tokens[workflow].setdefault(
            llm, _Ewma(self.config.slow_alpha)
        )
        observed = toks.update(float(req.output_tokens))
        expected = self.expectations[workflow].out_tokens.get(llm)
        if expected is not None and expected > 0:
            rel = abs(observed - expected) / max(expected, 1.0)
            gate = self.config.zscore_gate * toks.std_of_mean
            if abs(observed - expected) <= gate:
                rel = 0.0
            if toks.count >= self._warmup():
                self._edge(
                    ("tokens", workflow, llm),
                    rel,
                    self.config.token_threshold,
                    lambda: TokenDrift(
                        workflow=workflow,
                        at=self.now,
                        magnitude=rel,
                        llm=llm,
                        observed=observed,
                        expected=expected,
                    ),
                )

    def record_shed(self, workflow: str, slo_class: str, kind: str,
                    t: float) -> None:
        """Front-door shed (reject/degrade) — counts as an SLO loss."""
        if workflow not in self.expectations:
            return
        self.now = max(self.now, t)
        key = "rejected" if kind == "reject" else "degraded"
        self.slo_counters[workflow][key] += 1
        self._update_violation(workflow, 1.0)

    def _update_violation(self, workflow: str, violated: float) -> None:
        exp = self.expectations[workflow]
        if exp.slo_target <= 0:
            return
        ew = self._viol[workflow]
        rate = ew.update(violated)
        if ew.count < self.config.min_samples:
            return
        self._edge(
            ("slo", workflow),
            rate,
            self.config.slo_violation_threshold,
            lambda rate=rate: SLOViolation(
                workflow=workflow,
                at=self.now,
                magnitude=rate,
                slo_class=exp.slo_class,
                violation_rate=rate,
                target_s=exp.slo_target,
            ),
        )

    def record_request_done(self, workflow: str, rec) -> None:
        if workflow not in self.expectations:
            return
        self.now = max(self.now, rec.done)
        exp = self.expectations[workflow]
        if exp.slo_target > 0 and not getattr(rec, "degraded", False):
            violated = rec.latency > exp.slo_target
            self.slo_counters[workflow]["completed"] += 1
            if violated:
                self.slo_counters[workflow]["violations"] += 1
            self._update_violation(workflow, 1.0 if violated else 0.0)
        busy = self._open.pop((workflow, rec.request_id), None)
        if not busy:
            return
        total = sum(busy.values())
        if total <= 0:
            return
        exp = self.expectations[workflow]
        for m, ew in self._share[workflow].items():
            observed = ew.update(busy.get(m, 0.0) / total)
            expected = exp.shares.get(m, 0.0)
            denom = max(expected, self.config.share_floor)
            rel = abs(observed - expected) / denom
            if abs(observed - expected) <= self.config.zscore_gate * ew.std_of_mean:
                rel = 0.0
            if ew.count < self.config.min_samples:
                continue
            self._edge(
                ("share", workflow, m),
                rel,
                self.config.share_threshold,
                lambda m=m, observed=observed, expected=expected, rel=rel: ShareDrift(
                    workflow=workflow,
                    at=self.now,
                    magnitude=rel,
                    llm=m,
                    observed=observed,
                    expected=expected,
                ),
            )

    # -- detector plumbing ------------------------------------------------

    def _warmup(self) -> int:
        return max(
            self.config.min_samples,
            int(round(2.0 / max(self.config.slow_alpha, 1e-6))),
        )

    def _edge(self, key: tuple, severity: float, threshold: float, make) -> None:
        if key in self._active:
            # re-arm only once safely back inside the hysteresis band
            if severity < threshold * self.config.hysteresis:
                self._active.discard(key)
                if key[0] == "rate":
                    self._rate_cusum[key[1]].reset()
        elif severity > threshold:
            self._active.add(key)
            self._pending.append(make())

    def poll(self) -> List[DriftEvent]:
        """Drain events emitted since the last poll."""
        out, self._pending = self._pending, []
        return out

    # -- state the controller reads ---------------------------------------

    def observed_lams(self) -> Dict[str, float]:
        """Current arrival-rate estimates (planned target until the EWMA
        has a sample)."""
        out = {}
        for w, exp in self.expectations.items():
            ia = self._ia[w].value
            out[w] = (1.0 / ia) if ia else exp.lam
        return out

    def observed_shares(self, workflow: str) -> Dict[str, float]:
        return {
            m: (ew.value if ew.value is not None else 0.0)
            for m, ew in self._share[workflow].items()
        }

    def corroborate(
        self, shares: Dict[str, Dict[str, float]], tol: float = 0.25
    ) -> Dict[str, Dict[str, dict]]:
        """Cross-check the monitor's share EWMAs against an independently
        reconstructed estimate (the span-derived shares from
        :meth:`repro_torch.obs.spans.Tracer.observed_shares`).

        Both estimators consume the same busy-time normalization, so on
        a healthy pipeline they must agree; a gap beyond ``tol`` marks
        the EWMA (windowed) and the reconstruction (run-cumulative) as
        diverging — corroborating telemetry a replan decision can audit.
        Verdicts are returned and kept on :attr:`corroboration`.
        """
        floor = self.config.share_floor
        out: Dict[str, Dict[str, dict]] = {}
        for w, ext_row in shares.items():
            own_row = self.observed_shares(w) if w in self._share else {}
            row: Dict[str, dict] = {}
            for m in set(ext_row) | set(own_row):
                own = own_row.get(m, 0.0)
                ext = ext_row.get(m, 0.0)
                gap = abs(own - ext) / max(own, ext, floor)
                row[m] = {
                    "monitor": own,
                    "external": ext,
                    "gap": gap,
                    "agree": gap <= tol,
                }
            out[w] = row
        self.corroboration = out
        return out

    def observed_violation_rate(self, workflow: str) -> float:
        """Smoothed SLO-violation rate (0.0 until a sample arrives)."""
        ew = self._viol.get(workflow)
        return ew.value if ew is not None and ew.value is not None else 0.0

    def observed_tokens(self, workflow: str) -> Dict[str, float]:
        """Live mean-output-token estimates (only LLMs with samples)."""
        return {
            m: ew.value
            for m, ew in self._tokens.get(workflow, {}).items()
            if ew.value is not None
        }

    def calibrate(self) -> None:
        """Rebase expectations onto the *observed* steady state.

        Profiled expectations come from the unloaded tracing deployment;
        the live system adds queueing and cache effects that shift the
        measured shares systematically.  Calling this at the end of a
        known-stable warmup window re-centers the share and token
        detectors on what the deployment actually looks like, so
        subsequent events measure drift rather than trace-vs-runtime
        calibration error.  The *rate* baseline stays at the planned
        target — the plan is the correct reference for rate drift, and
        re-baselining it onto a noisy instantaneous estimate would bake
        sampling error into every later comparison.
        """
        for w, exp in list(self.expectations.items()):
            shares = {
                m: (ew.value if ew.value is not None else exp.shares.get(m, 0.0))
                for m, ew in self._share[w].items()
            }
            toks = {
                m: (ew.value if ew.value is not None else exp.out_tokens.get(m, 0.0))
                for m, ew in self._tokens[w].items()
            }
            self.expectations[w] = Expectation(
                lam=exp.lam, shares=shares, out_tokens=toks,
                slo_target=exp.slo_target, slo_class=exp.slo_class
            )
            self._rate_cusum[w].reset()
            self._viol[w] = _Ewma(self.config.slo_alpha)
        self._active.clear()
        self._pending.clear()

    def rebase(self, expectations: Dict[str, Expectation]) -> None:
        """Adopt new expectations after a re-plan: detectors re-arm and
        CUSUM accumulators reset, so the monitor measures drift relative
        to the *current* plan."""
        for w, exp in expectations.items():
            self.expectations[w] = exp
            if w in self._rate_cusum:
                self._rate_cusum[w].reset()
            if w in self._viol:
                self._viol[w] = _Ewma(self.config.slo_alpha)
        self._active = {k for k in self._active if k[1] not in expectations}
