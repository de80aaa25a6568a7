"""Incremental re-scheduling on drift: the three-rung escalation ladder.

Drift events from :mod:`repro_torch.core.drift` are mapped onto the cheapest
reaction that can absorb them:

1. **Routing rebalance** (pooled fleets only): re-derive the per-workflow
   routing tables from the *observed* rate mix via
   ``MergedPipeline.routing_weights`` — no scheduling search, no
   re-placement, the shared replica set is untouched.
2. **Warm incremental re-plan**: one :func:`schedule_multi` call threaded
   through the fleet's :class:`FleetWarmState` — unchanged workflows'
   (workflow, chips) schedules and option tables are reused verbatim,
   drifted workflows re-search from their previous unit split as a
   branch-and-bound incumbent, and a pooled re-plan is a single seeded
   merged-pipeline ``schedule()`` call.
3. **Full re-plan + re-placement**: a cold ``mode="auto"`` search (the
   same work the original deploy did) plus a fresh placement, emitted as
   a :class:`MigrationDiff` — chips to move, replicas to add/drop —
   rather than a from-scratch manifest.

The controller escalates automatically: a rebalance that leaves some
workflow infeasible falls through to rung 2; a warm re-plan that still
cannot serve every workflow falls through to rung 3.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch import hw
from repro_torch.core.drift import (
    DriftEvent,
    DriftMonitor,
    Expectation,
    RateDrift,
    ShareDrift,
    SLOViolation,
    TokenDrift,
    expectation_from,
)
from repro_torch.core.forecast import ForecastDrift, ForecastTrigger
from repro_torch.core.pipeline import AggregateLLMPipeline, merge_pipelines
from repro_torch.core.placement import (
    MigrationDiff,
    Placement,
    PlacementError,
    migration_diff,
    place,
    place_fleet,
    tenant_routing,
)
from repro_torch.core.scheduler import (
    FleetWarmState,
    MultiScheduleResult,
    SchedulerConfig,
    schedule_multi,
)

RUNG_REBALANCE = 1
RUNG_WARM_REPLAN = 2
RUNG_FULL_REPLAN = 3


def partitioned_fleet_placement(result: MultiScheduleResult,
                                spec: hw.ClusterSpec) -> Optional[Placement]:
    """Global placement of a partitioned fleet schedule: all workflows'
    replicas co-placed in one pass over the real topology
    (:func:`~repro_torch.core.placement.place_fleet`, instances keyed
    ``<workflow>/<llm>``), so partitioned re-plans produce a
    :class:`MigrationDiff` just like pooled ones — and rungs 2-3 deploy
    through the same packing the placement-aware split search probes."""
    if result.alloc_mode != "partitioned" or not result.chip_split:
        return None
    return place_fleet(
        {name: result.per_workflow[name].allocations
         for name in result.chip_split}, spec)


@dataclass
class ReplanAction:
    """One reaction taken (or proposed) by the controller."""

    rung: int
    reason: str
    latency_s: float  # wall-clock cost of computing the reaction
    lam_targets: Dict[str, float]  # targets the reaction plans for
    feasible: bool = True
    routing: Optional[dict] = None  # wf -> llm -> replica idx -> weight
    instance_routing: Optional[dict] = None  # wf -> llm -> instance -> w
    result: Optional[MultiScheduleResult] = None  # rungs 2-3
    placement: Optional[Placement] = None  # pooled re-placements
    migration: Optional[MigrationDiff] = None  # rung 3 (and rung 2 moves)
    welfare: Optional[float] = None
    events: List[DriftEvent] = field(default_factory=list)


def recommend_rung(events: List[DriftEvent], *, rebalance_band: float = 0.5) -> int:
    """Map a batch of drift events to the cheapest plausible rung.

    Rate drift within ``rebalance_band`` (relative deviation) is a mix
    shift the pooled replica set can absorb by re-weighting (rung 1);
    larger rate drift needs capacity to move (rung 2).  Share and token
    drift mean the *pipeline synthesis itself* is stale, which only a
    re-plan (over refreshed pipelines) can answer (rung 2).  An SLO
    violation (the fourth trigger: promised tiers are being missed) is
    a mild-overload signal a routing rebalance may absorb when the
    violation rate is inside the band; past it the tier needs capacity.
    """
    if not events:
        return 0
    rung = 0
    for ev in events:
        if isinstance(ev, (ShareDrift, TokenDrift)):
            rung = max(rung, RUNG_WARM_REPLAN)
        elif isinstance(ev, (RateDrift, SLOViolation)):
            if ev.magnitude <= rebalance_band:
                rung = max(rung, RUNG_REBALANCE)
            else:
                rung = max(rung, RUNG_WARM_REPLAN)
    return rung


class ReplanController:
    """Holds a fleet's planning state and reacts to drift events.

    Constructed by ``deploy_multi(..., online=True)`` (see
    :mod:`repro_torch.core.scepsy`) or directly from a schedule result.  The
    controller owns the :class:`FleetWarmState`, the incumbent
    :class:`MultiScheduleResult` and (for pooled fleets) the incumbent
    :class:`Placement`, so every reaction is incremental with respect to
    what is actually deployed.
    """

    def __init__(
        self,
        pipelines: Dict[str, AggregateLLMPipeline],
        spec: hw.ClusterSpec,
        lam_targets: Dict[str, float],
        config: Optional[SchedulerConfig] = None,
        *,
        result: Optional[MultiScheduleResult] = None,
        placement: Optional[Placement] = None,
        monitor: Optional[DriftMonitor] = None,
        forecast: Optional[ForecastTrigger] = None,
        pipeline_refresh: Optional[Callable[[str], AggregateLLMPipeline]] = None,
        rebalance_band: float = 0.5,
        cooldown_s: float = 0.0,
    ):
        self.pipelines = dict(pipelines)
        self.spec = spec
        self.lam_targets = dict(lam_targets)
        self.config = config or SchedulerConfig(max_tp=spec.hb_domain_size)
        self.result = result
        self.placement = placement
        self.monitor = monitor
        # proactive trigger (repro_torch.core.forecast.ForecastTrigger): polled
        # alongside the monitor in step(), rebased in adopt()
        self.forecast = forecast
        self.pipeline_refresh = pipeline_refresh
        self.rebalance_band = rebalance_band
        # rung hysteresis: after an adopted action, drift events inside
        # the cool-down window are ignored unless they recommend a
        # strictly HIGHER rung — flapping traffic cannot oscillate
        # rebalance -> replan -> rebalance, but genuine escalation is
        # never delayed
        self.cooldown_s = cooldown_s
        self._last_action_at = -math.inf
        self._last_rung = 0
        # events suppressed by the cool-down: the monitor is
        # edge-triggered (a fired detector stays latched until the
        # metric recovers), so a suppressed event would otherwise never
        # re-fire for a *persistent* condition — it is deferred and
        # re-considered on the next react()/step() instead
        self._deferred: List[DriftEvent] = []
        self.warm_state = (
            result.warm_state
            if result is not None and result.warm_state is not None
            else FleetWarmState()
        )
        self.history: List[ReplanAction] = []
        self._refreshed_since_adopt: set = set()
        # observability hook (repro_torch.obs.spans.Tracer); None = untraced
        self.tracer = None

    # -- rungs -------------------------------------------------------------

    def rebalance(self, lam_targets: Dict[str, float]) -> ReplanAction:
        """Rung 1: new routing tables from the observed rate mix; the
        allocation and placement stay exactly as deployed."""
        t0 = time.perf_counter()
        if self.result is None or self.result.pooled is None:
            return ReplanAction(
                rung=RUNG_REBALANCE,
                reason="no pooled incumbent: rebalance unavailable",
                latency_s=time.perf_counter() - t0,
                lam_targets=dict(lam_targets),
                feasible=False,
            )
        pooled = self.result.pooled
        merged = merge_pipelines(self.pipelines, lam_targets)
        missing = [c for c in merged.tenants if c not in pooled.allocations]
        if missing:
            return ReplanAction(
                rung=RUNG_REBALANCE,
                reason=f"tenants {missing} not in deployed allocation",
                latency_s=time.perf_counter() - t0,
                lam_targets=dict(lam_targets),
                feasible=False,
            )
        routing = merged.routing_weights(
            pooled.allocations, policy=self.config.routing_policy
        )
        preds = merged.attribute(pooled.allocations, self.config.percentile)
        feasible = all(p.feasible for p in preds.values())
        inst_routing = None
        if self.placement is not None:
            members = {
                cid: [(t.workflow, t.llm) for t in mem]
                for cid, mem in merged.tenants.items()
            }
            inst_routing = tenant_routing(self.placement, members, routing)
        return ReplanAction(
            rung=RUNG_REBALANCE,
            reason="routing-weight rebalance (no re-placement)",
            latency_s=time.perf_counter() - t0,
            lam_targets=dict(lam_targets),
            feasible=feasible,
            routing=routing,
            instance_routing=inst_routing,
        )

    def replan(
        self, lam_targets: Dict[str, float], *, cold: bool = False
    ) -> ReplanAction:
        """Rung 2 (warm, incremental) or rung 3 (``cold=True``).

        A cold re-plan trusts *nothing* from the incumbent: when the
        deployment provided a ``pipeline_refresh`` it re-traces and
        re-profiles every workflow (the paper's steps 1-4, by far the
        dominant cost), then runs the same ``mode="auto"`` search the
        original deploy ran, from an empty warm state, and re-places.
        The warm rung instead reuses profiled pipelines (except any the
        caller refreshed), cached sub-schedules and incumbents.
        """
        t0 = time.perf_counter()
        if cold:
            state = FleetWarmState()
            mode = "auto"
            if self.pipeline_refresh is not None:
                for n in list(self.pipelines):
                    self.pipelines[n] = self.pipeline_refresh(n)
                    self._refreshed_since_adopt.add(n)
        else:
            state = self.warm_state
            mode = self.result.alloc_mode if self.result is not None else "auto"
        try:
            res = schedule_multi(
                self.pipelines,
                self.spec,
                lam_targets,
                self.config,
                mode=mode,
                warm_state=state,
            )
        except (ValueError, RuntimeError) as e:
            return ReplanAction(
                rung=RUNG_FULL_REPLAN if cold else RUNG_WARM_REPLAN,
                reason=f"re-plan failed: {e}",
                latency_s=time.perf_counter() - t0,
                lam_targets=dict(lam_targets),
                feasible=False,
            )
        placement = None
        migration = None
        routing = None
        placement_failed = False
        if res.alloc_mode == "pooled" and res.pooled is not None:
            routing = res.pooled.routing
            try:
                placement = place(res.pooled.allocations, self.spec)
            except PlacementError:
                placement_failed = True  # plan cannot deploy: escalate
        elif res.placement_ok is False:
            # placement-aware search found NO placeable split and fell
            # back to the blind winner: placing it is guaranteed to
            # fail, and the plan must not be reported deployable
            placement_failed = True
        else:
            try:
                placement = partitioned_fleet_placement(res, self.spec)
            except PlacementError:
                placement_failed = True
        if self.placement is not None and placement is not None:
            migration = migration_diff(self.placement, placement)
        feasible = (all(r.feasible for r in res.per_workflow.values())
                    and not placement_failed)
        reason = (
            "cold full re-plan + re-placement" if cold else "warm incremental re-plan"
        )
        return ReplanAction(
            rung=RUNG_FULL_REPLAN if cold else RUNG_WARM_REPLAN,
            reason=reason,
            latency_s=time.perf_counter() - t0,
            lam_targets=dict(lam_targets),
            feasible=feasible,
            routing=routing,
            result=res,
            placement=placement,
            migration=migration,
            welfare=res.welfare,
        )

    # -- the ladder --------------------------------------------------------

    def react(self, events: List[DriftEvent]) -> Optional[ReplanAction]:
        """Escalate through the ladder until a rung absorbs the drift,
        adopt the resulting action, and return it (None: no reaction
        needed, or suppressed — and deferred — by the cool-down
        hysteresis)."""
        events = self._merge_deferred(events)
        now = max((ev.at for ev in events), default=0.0)
        if self.monitor is not None:
            now = max(now, self.monitor.now)
        # a deferred forecast expires once its firing lead has passed:
        # by then the ramp it predicted is live traffic the reactive
        # detectors see directly, and provisioning for the stale
        # extrapolation would chase a peak that is already over
        events = [ev for ev in events
                  if not (isinstance(ev, ForecastDrift)
                          and now > ev.stale_after)]
        rung = recommend_rung(events, rebalance_band=self.rebalance_band)
        if rung == 0:
            return None
        if (self.cooldown_s > 0
                and now - self._last_action_at < self.cooldown_s
                and rung <= self._last_rung):
            self._deferred = events
            return None
        self._deferred = []
        lam_targets = self._drifted_targets(events)
        self._refresh_pipelines(events)
        action = None
        if rung <= RUNG_REBALANCE:
            action = self.rebalance(lam_targets)
            if not action.feasible:
                action = None
        if action is None and rung <= RUNG_WARM_REPLAN:
            action = self.replan(lam_targets, cold=False)
            if not action.feasible:
                # a forecast is speculative: when the cluster cannot
                # serve the extrapolated target, fall back to the
                # measured demand rather than escalating to a cold
                # re-plan the forecast alone cannot justify
                measured_evs = [ev for ev in events
                                if not isinstance(ev, ForecastDrift)]
                measured = self._drifted_targets(measured_evs)
                if len(measured_evs) < len(events) and measured != lam_targets:
                    retry = self.replan(measured, cold=False)
                    if retry.feasible:
                        action = retry
            if action is not None and not action.feasible:
                action = None
        if action is None:
            action = self.replan(lam_targets, cold=True)
        action.events = list(events)
        # an infeasible plan never deploys, so it must not become the
        # incumbent future reactions are incremental against — the
        # fleet keeps serving (and the monitor keeps measuring) the
        # last adopted plan
        if action.feasible:
            self.adopt(action)
        self._last_action_at = now
        self._last_rung = action.rung
        return action

    def step(self) -> Optional[ReplanAction]:
        """Poll the attached monitor and forecast trigger, and react to
        whatever they saw (or to drift deferred by an earlier cool-down
        suppression).  Forecast events ride the same ladder as reactive
        ones — they just arrive ``lead_s`` before the ramp does."""
        if self.monitor is None and self.forecast is None:
            return None
        events: List[DriftEvent] = []
        if self.monitor is not None:
            events.extend(self.monitor.poll())
        if self.forecast is not None:
            now = self.monitor.now if self.monitor is not None else 0.0
            events.extend(self.forecast.poll(now))
        if not events and not self._deferred:
            return None
        return self.react(events)

    def adopt(self, action: ReplanAction) -> None:
        """Commit an action: it becomes the incumbent the next reaction
        is incremental against, and the monitor is re-based onto the new
        targets so detectors re-arm."""
        self.lam_targets = dict(action.lam_targets)
        if action.result is not None:
            self.result = action.result
            self.warm_state = action.result.warm_state or self.warm_state
        if action.placement is not None:
            self.placement = action.placement
        if (
            action.routing is not None
            and self.result is not None
            and self.result.pooled is not None
        ):
            self.result.pooled.routing = action.routing
        if self.monitor is not None:
            rebased = {}
            for w, lam in self.lam_targets.items():
                old = self.monitor.expectations.get(w)
                if w in self._refreshed_since_adopt and w in self.pipelines:
                    # the re-traced pipeline is the new baseline: keeping
                    # the stale pre-drift shares would re-fire the
                    # detector (and re-trigger an expensive re-trace +
                    # re-plan) on every subsequent request; the token
                    # baseline re-arms on the monitor's live estimates so
                    # future token drift stays detectable
                    exp = expectation_from(self.pipelines[w], lam)
                    rebased[w] = Expectation(
                        lam=lam,
                        shares=exp.shares,
                        out_tokens=self.monitor.observed_tokens(w),
                        slo_target=old.slo_target if old else 0.0,
                        slo_class=old.slo_class if old else "",
                    )
                else:
                    # unchanged pipeline: keep the current (possibly
                    # runtime-calibrated) expectations, only the target
                    # rate moves
                    rebased[w] = Expectation(
                        lam=lam,
                        shares=dict(old.shares) if old else {},
                        out_tokens=dict(old.out_tokens) if old else {},
                        slo_target=old.slo_target if old else 0.0,
                        slo_class=old.slo_class if old else "",
                    )
            self.monitor.rebase(rebased)
        if self.forecast is not None:
            self.forecast.rebase(self.lam_targets)
        self._refreshed_since_adopt.clear()
        self.history.append(action)
        if self.tracer is not None:
            self.tracer.on_replan(action)

    # -- helpers -----------------------------------------------------------

    def _merge_deferred(self, events: List[DriftEvent]) -> List[DriftEvent]:
        """Carry cool-down-suppressed drift into this batch, deduplicated
        by detector identity (newest wins) so the buffer stays bounded."""
        if not self._deferred:
            return list(events)
        merged: Dict[tuple, DriftEvent] = {}
        for ev in self._deferred + list(events):
            merged[(type(ev), ev.workflow, getattr(ev, "llm", ""))] = ev
        return list(merged.values())

    def _drifted_targets(self, events: List[DriftEvent]) -> Dict[str, float]:
        """Planning targets under drift: observed rates for workflows
        that drifted, deployed targets elsewhere."""
        out = dict(self.lam_targets)
        if self.monitor is not None:
            observed = self.monitor.observed_lams()
        else:
            observed = {}
        for ev in events:
            if isinstance(ev, ForecastDrift):
                continue  # applied last: the forecast target must win
            if isinstance(ev, RateDrift):
                out[ev.workflow] = observed.get(ev.workflow, ev.observed)
            elif isinstance(ev, SLOViolation) and ev.workflow in observed:
                # a violated tier under an unchanged plan means the
                # observed load is what the fleet must actually absorb
                out[ev.workflow] = observed[ev.workflow]
        for ev in events:
            # proactive: plan for the FORECAST rate, not the current
            # estimate — the live stream has not ramped yet, which is
            # the entire point of firing early; a reactive event for the
            # same workflow in this batch must not talk the target back
            # down to the pre-ramp rate
            if isinstance(ev, ForecastDrift):
                out[ev.workflow] = max(ev.observed,
                                       observed.get(ev.workflow, 0.0),
                                       out.get(ev.workflow, 0.0))
        return out

    def _refresh_pipelines(self, events: List[DriftEvent]) -> None:
        """Share/token drift means the traced pipeline is stale; pull a
        fresh one when the deployment gave us a refresher."""
        if self.pipeline_refresh is None:
            return
        stale = {
            ev.workflow
            for ev in events
            if isinstance(ev, (ShareDrift, TokenDrift))
        }
        for w in stale:
            self.pipelines[w] = self.pipeline_refresh(w)
            self._refreshed_since_adopt.add(w)


# ``deploy_multi(..., online=True)`` hands callers this alias.
OnlineController = ReplanController
