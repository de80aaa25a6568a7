"""Scepsy facade: trace -> aggregate -> profile -> pipeline -> schedule ->
place (paper Fig. 2 end-to-end flow).

Inputs are :class:`~repro_torch.workflows.runtime.Workflow` programs plus a
:class:`repro_torch.hw.ClusterSpec` and arrival-rate targets; outputs are
deployment objects bundling the chosen allocation, its concrete
placement and (optionally) QoS contexts and an online re-plan
controller.  :func:`deploy` serves one workflow; :func:`deploy_multi`
serves a fleet — partitioned (disjoint chips, co-placed in one pass
over the real topology via :func:`~repro_torch.core.placement.place_fleet`),
pooled (LLMs are tenants, workflows hold routing tables into a shared
replica set — ROADMAP "Cross-workflow LLM sharing"), or auto
(whichever wins on welfare).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import hw
from repro_torch.core.aggregate import WorkflowStats, aggregate
from repro_torch.core.pipeline import AggregateLLMPipeline
from repro_torch.core.placement import Placement, place
from repro_torch.core.profiler import LLMProfile, profile_llm
from repro_torch.core.scheduler import (ScheduleResult, SchedulerConfig,
                                  MultiScheduleResult, schedule,
                                  schedule_multi)
from repro_torch.core.trace import TraceStore
from repro_torch.workflows.runtime import Workflow, trace_workflow


@dataclass
class ScepsyDeployment:
    workflow: str
    stats: WorkflowStats
    pipeline: AggregateLLMPipeline
    schedule: ScheduleResult
    placement: Placement
    # request-level QoS context (repro_torch.qos.slo.WorkflowQoS): the
    # resolved SLO class + the pipeline-derived work model; None when
    # the workflow is unclassified
    qos: Optional[object] = None


def _resolve_qos(wf: Workflow, pipeline: AggregateLLMPipeline,
                 stats: Optional[WorkflowStats], slo=None):
    """Build the runtime QoS context for one workflow: resolve the SLO
    class's relative target against the traced unloaded latency (or the
    work model's critical-path estimate when stats are unavailable)."""
    slo = slo if slo is not None else wf.slo
    if slo is None:
        return None
    from repro_torch.qos.slo import WorkflowQoS, WorkModel

    work = WorkModel.from_pipeline(pipeline, stats)
    base = stats.mean_latency if stats is not None else work.serial_s
    return WorkflowQoS(slo=slo.resolve(base), work=work)


def build_pipeline(wf: Workflow, *, n_trace_requests: int = 60,
                   tp_degrees: Sequence[int] = (1, 2, 4), seed: int = 0,
                   max_profile_groups: int = 60,
                   store: Optional[TraceStore] = None,
                   chip_classes: Sequence[hw.ChipClass] = ()
                   ) -> Tuple[AggregateLLMPipeline, WorkflowStats, TraceStore]:
    """Steps 1-4: trace the workflow, aggregate, profile, synthesize.

    ``chip_classes`` lists every chip class the serving cluster exposes;
    each LLM is profiled per ``(chip_class, tp)`` so the scheduler can
    price allocations on each class.  Empty = default class only.
    """
    if store is None:
        store = trace_workflow(wf, n_trace_requests, seed=seed)
    stats = aggregate(store)
    profiles: Dict[str, LLMProfile] = {}
    for m in stats.per_llm:
        cfg = wf.llms[m]
        tps = [t for t in tp_degrees]
        profiles[m] = profile_llm(cfg, store, m, tp_degrees=tps,
                                  max_groups=max_profile_groups, seed=seed,
                                  chip_classes=chip_classes)
    pipeline = AggregateLLMPipeline.synthesize(stats, profiles, wf.llms)
    return pipeline, stats, store


def _default_tp_degrees(spec: hw.ClusterSpec) -> list:
    """TP degrees to profile: 1/2/4 capped by the hb domain, plus the
    domain size itself (one grid for single-workflow and fleet deploys)."""
    return sorted({1, 2, min(4, spec.hb_domain_size), spec.hb_domain_size})


def _spec_chip_classes(spec: hw.ClusterSpec) -> Tuple[hw.ChipClass, ...]:
    """Chip classes to profile for ``spec`` (empty = default only)."""
    if spec.is_uniform and (
            not spec.classes()
            or spec.classes()[0] == hw.DEFAULT_CHIP_CLASS.name):
        return ()
    return tuple(hw.chip_class(c) for c in spec.classes())


def deploy(wf: Workflow, spec: hw.ClusterSpec, lam_target: float, *,
           n_trace_requests: int = 60, seed: int = 0,
           scheduler_config: Optional[SchedulerConfig] = None,
           pipeline: Optional[AggregateLLMPipeline] = None,
           slo=None) -> ScepsyDeployment:
    """Full flow: returns the chosen allocation + concrete placement.

    ``slo`` (a :class:`repro_torch.qos.slo.SLOClass`) overrides the
    workflow's own tier; relative targets are resolved against the
    traced unloaded latency.
    """
    cfg = scheduler_config or SchedulerConfig(max_tp=spec.hb_domain_size)
    if pipeline is None:
        pipeline, stats, _ = build_pipeline(
            wf, n_trace_requests=n_trace_requests,
            tp_degrees=_default_tp_degrees(spec), seed=seed,
            chip_classes=_spec_chip_classes(spec))
    else:
        stats = None
    result = schedule(pipeline, spec, lam_target, cfg)
    placement = place(result.allocations, spec)
    return ScepsyDeployment(wf.name, stats, pipeline, result, placement,
                            qos=_resolve_qos(wf, pipeline, stats, slo))


@dataclass
class ScepsyFleetDeployment:
    """N workflows sharing one cluster.

    Partitioned mode: the fleet is co-placed in ONE pass over the real
    topology (:func:`~repro_torch.core.placement.place_fleet`) —
    ``fleet_placement`` holds the global ``workflow/llm``-keyed
    placement (the replan ladder's migration-diff incumbent) and each
    per-workflow ``deployments[name].placement`` is its view of that
    placement with chip ids already GLOBAL.  Chip ownership is
    exclusive per workflow but slices are neither contiguous nor
    hb-domain-aligned; ``chip_offsets`` is kept for API compatibility
    and is all zeros.

    Pooled mode: LLMs are tenants — the shared replica set gets ONE
    physical placement (``tenant_placement``, chip ids already global)
    and every workflow receives a routing table (``routing``: local llm
    name -> placed instance -> weight) instead of a private chip offset.
    """

    deployments: Dict[str, ScepsyDeployment]
    chip_split: Dict[str, int]
    welfare: float
    schedule: MultiScheduleResult
    spec: Optional[hw.ClusterSpec] = None
    chip_offsets: Dict[str, int] = None
    mode: str = "partitioned"
    # partitioned mode: the global workflow/llm-keyed co-placement
    fleet_placement: Optional[Placement] = None
    tenant_placement: Optional[Placement] = None
    routing: Optional[Dict[str, Dict[str, Dict[str, float]]]] = None
    # online drift handling (deploy_multi(..., online=True)): a
    # ReplanController wired to a DriftMonitor over this deployment
    controller: Optional[object] = None
    # per-workflow request-level QoS contexts (workflow name ->
    # repro_torch.qos.slo.WorkflowQoS); empty when no workflow carries a tier
    qos: Dict[str, object] = None

    def global_instances(self):
        """Every placed instance in physical cluster coordinates."""
        import dataclasses as dc

        if self.mode == "pooled":
            return list(self.tenant_placement.instances)
        out = []
        for name, dep in self.deployments.items():
            # co-placed views already hold global chip ids (offset 0);
            # the translation is kept for placements built externally
            off = self.chip_offsets[name]
            table = self.spec.chip_table()
            for inst in dep.placement.instances:
                chips = [c + off for c in inst.chips]
                host, domain = (table[chips[0]][:2] if chips[0] < len(table)
                                else (chips[0] // self.spec.chips_per_host,
                                      chips[0] // self.spec.hb_domain_size))
                out.append(dc.replace(inst, chips=chips, host=host,
                                      domain=domain))
        return out

    def to_deployment(self) -> dict:
        """One manifest for the whole fleet (pooled mode only)."""
        if self.mode != "pooled":
            raise ValueError("fleet manifest only exists in pooled mode; "
                             "use per-workflow placements instead")
        return self.tenant_placement.to_deployment(self.routing)


def deploy_multi(wfs: Sequence[Workflow], spec: hw.ClusterSpec,
                 lam_targets: Dict[str, float], *,
                 n_trace_requests: int = 60, seed: int = 0,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 pipelines: Optional[Dict[str, AggregateLLMPipeline]] = None,
                 split_step: int = 1, search: str = "auto",
                 mode: str = "partitioned",
                 welfare: Optional[str] = None,
                 online: bool = False,
                 drift_config=None,
                 forecast=None,
                 replan_cooldown_s: float = 0.0,
                 slos: Optional[Dict[str, object]] = None,
                 max_profile_groups: int = 60) -> ScepsyFleetDeployment:
    """Fleet flow: trace/profile each workflow, allocate the cluster with
    :func:`schedule_multi` (``mode`` selects partitioned slices vs the
    pooled multi-tenant allocation vs auto), and emit placements.

    A partitioned fleet is co-placed in one pass over the real topology
    (:func:`~repro_torch.core.placement.place_fleet`): chips stay exclusive
    per workflow but slices are neither contiguous nor hb-domain-
    aligned, so tail chips and odd-sized leftovers are usable; pass a
    ``scheduler_config`` with ``placement_aware=True`` to also feed
    placement feasibility and fragmentation back into the split search.
    In pooled mode the tenants' shared replica set is placed once over
    the whole cluster and each workflow gets a routing table into it.

    ``welfare`` overrides ``scheduler_config.welfare`` (egalitarian /
    weighted / proportional).

    ``online=True`` attaches an online re-scheduling controller
    (``.controller``): a :class:`repro_torch.core.drift.DriftMonitor` primed
    with this deployment's profiled expectations (feed it to the cluster
    executor as ``telemetry=``) plus a
    :class:`repro_torch.core.replan.ReplanController` whose escalation ladder
    re-plans incrementally against this deployment's warm state.
    ``drift_config`` is an optional :class:`repro_torch.core.drift.DriftConfig`;
    ``replan_cooldown_s`` sets the controller's rung hysteresis (drift
    events inside the window only act if they escalate the rung).
    ``forecast`` (a :class:`repro_torch.core.forecast.ForecastConfig`, or
    ``True`` for defaults) additionally arms the proactive trigger: an
    :class:`~repro_torch.core.forecast.ArrivalForecaster` fed by the monitor's
    arrival telemetry plus a
    :class:`~repro_torch.core.forecast.ForecastTrigger` the controller polls —
    the ladder then reacts ``lead_s`` *before* a forecast capacity
    crossing instead of after it.

    ``slos`` overrides per-workflow SLO classes (default: each
    workflow's own ``Workflow.slo``); resolved classes + pipeline work
    models land in the returned deployment's ``qos`` dict, and each
    class's latency target arms the monitor's SLO-violation detector.
    """
    import dataclasses as dc

    from repro_torch.core.placement import place_fleet, split_fleet, tenant_routing

    cfg = scheduler_config or SchedulerConfig(max_tp=spec.hb_domain_size)
    if welfare is not None:
        cfg = dc.replace(cfg, welfare=welfare)
    stats_by_name: Dict[str, Optional[WorkflowStats]] = {}
    if pipelines is None:
        pipelines = {}
        for wf in wfs:
            pipeline, stats, _ = build_pipeline(
                wf, n_trace_requests=n_trace_requests,
                tp_degrees=_default_tp_degrees(spec), seed=seed,
                max_profile_groups=max_profile_groups,
                chip_classes=_spec_chip_classes(spec))
            pipelines[wf.name] = pipeline
            stats_by_name[wf.name] = stats
    else:
        stats_by_name = {n: None for n in pipelines}
    multi = schedule_multi(pipelines, spec, lam_targets, cfg,
                           split_step=split_step, search=search, mode=mode)

    wf_by_name = {wf.name: wf for wf in wfs}
    qos_by_name = {}
    for name, pipe in pipelines.items():
        q = _resolve_qos(wf_by_name[name], pipe, stats_by_name.get(name),
                         (slos or {}).get(name))
        if q is not None:
            qos_by_name[name] = q

    def _controller(placement=None):
        if not online:
            return None
        from repro_torch.core.drift import DriftConfig, DriftMonitor, \
            expectation_from
        from repro_torch.core.replan import ReplanController

        forecaster = trigger = None
        if forecast:
            from repro_torch.core.forecast import (ArrivalForecaster,
                                             ForecastConfig, ForecastTrigger)
            fc = forecast if isinstance(forecast, ForecastConfig) \
                else ForecastConfig()
            forecaster = ArrivalForecaster(list(pipelines), fc)
            trigger = ForecastTrigger(forecaster, dict(lam_targets),
                                      headroom=fc.headroom)
        monitor = DriftMonitor(
            {n: expectation_from(
                pipelines[n], lam_targets[n], stats_by_name.get(n),
                slo=(qos_by_name[n].slo if n in qos_by_name else None))
             for n in pipelines},
            drift_config or DriftConfig(),
            forecaster=forecaster)

        def refresh(name: str) -> AggregateLLMPipeline:
            # a cold (rung-3) re-plan re-runs trace -> profile ->
            # synthesize at the same fidelity the deployment was built at;
            # warm rungs reuse the deployed pipelines
            pipe, _, _ = build_pipeline(
                wf_by_name[name], n_trace_requests=n_trace_requests,
                tp_degrees=_default_tp_degrees(spec), seed=seed,
                max_profile_groups=max_profile_groups)
            return pipe

        return ReplanController(pipelines, spec, lam_targets, cfg,
                                result=multi, placement=placement,
                                monitor=monitor, forecast=trigger,
                                pipeline_refresh=refresh,
                                cooldown_s=replan_cooldown_s)

    if multi.alloc_mode == "pooled":
        pooled = multi.pooled
        placement = place(pooled.allocations, spec)
        routing = tenant_routing(placement, pooled.members, pooled.routing)
        deployments = {
            name: ScepsyDeployment(
                name, stats_by_name.get(name), pipelines[name], result,
                placement, qos=qos_by_name.get(name))
            for name, result in multi.per_workflow.items()
        }
        return ScepsyFleetDeployment(deployments, {}, multi.welfare, multi,
                                     spec=spec, chip_offsets=None,
                                     mode="pooled",
                                     tenant_placement=placement,
                                     routing=routing,
                                     controller=_controller(placement),
                                     qos=qos_by_name)

    # a placement-aware search that found NO placeable split returns
    # the blind winner flagged placement_ok=False: placing it below is
    # guaranteed to fail, so surface the scheduler's diagnosis instead
    # of a low-level per-instance packing error
    if multi.placement_ok is False:
        from repro_torch.core.placement import PlacementError

        raise PlacementError(
            f"placement-aware search found no placeable split: all "
            f"{multi.placement_rejected_splits} probed candidate(s) were "
            f"rejected (search mode {multi.search_mode!r}; a greedy "
            f"search only probes its welfare-driven trajectory, so an "
            f"off-trajectory placeable split may still exist)",
            hint="try search='enumerate' for exhaustive coverage, grant "
                 "the fleet more chips, relax TP (max_tp), or use "
                 "mode='auto' so a placeable pooled plan can win")
    # true co-placement: every workflow's replicas packed in one pass
    # over the real topology (tail chips included), chip ownership
    # exclusive per workflow but with no contiguity or hb-domain
    # alignment waste; the global workflow/llm-keyed placement is the
    # controller's migration-diff incumbent
    incumbent = place_fleet(
        {n: r.allocations for n, r in multi.per_workflow.items()}, spec)
    views = split_fleet(incumbent)
    deployments = {
        name: ScepsyDeployment(
            name, stats_by_name.get(name), pipelines[name], result,
            views[name], qos=qos_by_name.get(name))
        for name, result in multi.per_workflow.items()
    }
    return ScepsyFleetDeployment(deployments, multi.chip_split,
                                 multi.welfare, multi, spec=spec,
                                 chip_offsets={n: 0 for n in deployments},
                                 fleet_placement=incumbent,
                                 controller=_controller(incumbent),
                                 qos=qos_by_name)
