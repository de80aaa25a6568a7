"""Cluster-front admission control and load shedding.

The controller sits in front of the routed replica set: each workflow-
level arrival asks :meth:`AdmissionController.admit` before its first
LLM call is dispatched.  The delay estimate is the aggregate pipeline's
— the same predictor the scheduler searched with — evaluated two ways
and combined pessimistically:

* **model**: the pipeline's predicted workflow latency at the *observed*
  arrival rate (EWMA over inter-arrivals), which prices sustained
  overload the way the scheduler would;
* **live**: the critical-path service time plus the current queued work
  ahead of this request — each stage's best replica's backlog in tokens,
  converted to seconds with the work model's per-token service-time
  proxy — which prices bursts the rate EWMA has not caught up with.

When the combined estimate blows the workflow's SLO target (times
``headroom``), the request is shed per its class's policy: ``reject``
drops it at the door, ``degrade`` admits it as best-effort (it runs but
yields to every deadline class), ``never`` always admits.

Just-in-time model substitution sits between "admit" and "shed": a
workflow registered with ``substitutes`` (workflow-local LLM name ->
the substitute tier's Router, per ``ArchConfig.substitute``) re-prices
an over-deadline arrival against the substitute replicas' live backlog
and — when the cheaper tier still makes the deadline — admits it as
``SUBSTITUTE`` instead of shedding.  A substituted request keeps its
own SLO class and deadline (substitution never upgrades a request);
the driver reroutes its calls to the substitute's replicas.  Observed
per-workflow substitution rates (:meth:`substitution_rates`) feed back
into :meth:`repro_torch.core.pipeline.MergedPipeline.with_substitution` so
the pooled share attribution follows the traffic that actually moved.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.qos.slo import SLOClass, WorkModel, WorkflowQoS

ADMIT = "admit"
REJECT = "reject"
DEGRADE = "degrade"
SUBSTITUTE = "substitute"


@dataclass
class AdmissionStats:
    arrived: int = 0
    admitted: int = 0
    rejected: int = 0
    degraded: int = 0
    substituted: int = 0

    def as_dict(self) -> dict:
        return {
            "arrived": self.arrived,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "degraded": self.degraded,
            "substituted": self.substituted,
        }


@dataclass
class _Entry:
    slo: SLOClass
    work: WorkModel
    routers: Dict[str, object] = field(default_factory=dict)
    predictor: Optional[Callable[[float], float]] = None
    stats: AdmissionStats = field(default_factory=AdmissionStats)
    # JIT substitution: workflow-local llm name -> the substitute tier's
    # Router (empty = this workflow never substitutes)
    substitutes: Dict[str, object] = field(default_factory=dict)
    # observed-rate EWMA state
    last_arrival: Optional[float] = None
    ia_ewma: Optional[float] = None
    n_samples: int = 0


class AdmissionController:
    """Per-fleet admission control keyed by workflow name.

    ``register`` wires one workflow: its (resolved) SLO class, work
    model, the live routers its calls will be submitted to (for the
    backlog estimate; optional), and optionally a ``predictor`` mapping
    an observed arrival rate to the pipeline's predicted workflow
    latency (for the model estimate).  A workflow that never registered
    is always admitted.
    """

    def __init__(self, *, headroom: float = 1.0, ia_alpha: float = 0.1,
                 min_rate_samples: int = 8):
        self.headroom = headroom
        self.ia_alpha = ia_alpha
        self.min_rate_samples = min_rate_samples
        self._entries: Dict[str, _Entry] = {}
        # observability hook (repro_torch.obs.spans.Tracer); None = untraced
        self.tracer = None

    def register(self, workflow: str, slo: SLOClass, work: WorkModel, *,
                 routers: Optional[Dict[str, object]] = None,
                 predictor: Optional[Callable[[float], float]] = None,
                 substitutes: Optional[Dict[str, object]] = None) -> None:
        self._entries[workflow] = _Entry(
            slo=slo, work=work, routers=dict(routers or {}),
            predictor=predictor, substitutes=dict(substitutes or {}))

    def stats(self) -> Dict[str, dict]:
        return {w: e.stats.as_dict() for w, e in self._entries.items()}

    def substitution_rates(self) -> Dict[str, float]:
        """Observed substituted/arrived fraction per workflow — the rates
        :meth:`MergedPipeline.with_substitution` re-attributes shares
        with."""
        return {w: (e.stats.substituted / e.stats.arrived
                    if e.stats.arrived else 0.0)
                for w, e in self._entries.items()}

    # -- delay estimation --------------------------------------------------

    def _observed_rate(self, e: _Entry, now: float) -> Optional[float]:
        last, e.last_arrival = e.last_arrival, now
        if last is not None:
            dt = max(now - last, 1e-9)
            if e.ia_ewma is None:
                e.ia_ewma = dt
            else:
                e.ia_ewma += self.ia_alpha * (dt - e.ia_ewma)
            e.n_samples += 1
        if (e.ia_ewma is None or e.ia_ewma <= 0
                or e.n_samples < self.min_rate_samples):
            return None
        return 1.0 / e.ia_ewma

    @staticmethod
    def _queue_delay(e: _Entry, llm: str,
                     router: Optional[object] = None) -> float:
        """Queued-work seconds ahead of a new call to ``llm``: the least
        backlog across that stage's live replicas, in tokens, priced at
        the work model's per-token service time.  Only replicas the
        workflow can actually route to count — a weighted Router view
        never submits to zero-weight replicas, so an idle replica in
        another tenant's block must not mask this workflow's backlog.
        ``router`` overrides the registered one (the substitution path
        prices the substitute tier's replicas instead)."""
        router = router if router is not None else e.routers.get(llm)
        if router is None:
            return 0.0
        replicas = getattr(router, "replicas", None)
        if not replicas:
            return 0.0
        weights = getattr(router, "weights", None)
        loads: List[float] = [
            r.load
            for i, r in enumerate(replicas)
            if not getattr(r, "failed", False)
            and (weights is None or weights.get(i, 0.0) > 0)
        ]
        if not loads:
            return math.inf
        spt = e.work.sec_per_token.get(llm, 0.0)
        return min(loads) * spt

    def predicted_delay(self, workflow: str, now: float, *,
                        update_rate: bool = False) -> float:
        """Predicted latency of a request arriving now (inf = hopeless)."""
        e = self._entries.get(workflow)
        if e is None:
            return 0.0
        rate = self._observed_rate(e, now) if update_rate else (
            1.0 / e.ia_ewma if e.ia_ewma else None)
        model_est = 0.0
        if e.predictor is not None and rate is not None:
            try:
                model_est = e.predictor(rate)
            except (ValueError, KeyError):
                model_est = 0.0
            if not math.isfinite(model_est):
                model_est = math.inf
        live_est = e.work.serial_s + sum(
            self._queue_delay(e, m) for m in e.work.per_call_s
        )
        return max(model_est, live_est)

    def _substituted_delay(self, e: _Entry) -> float:
        """Live delay estimate with substitutable stages re-priced
        against their substitute tier's replicas.  Model (rate-EWMA)
        pricing is skipped: the pipeline predictor knows nothing about
        the substitute's capacity, and substitution exists precisely for
        bursts where the substitute tier has live headroom."""
        return e.work.serial_s + sum(
            self._queue_delay(e, m, router=e.substitutes.get(m))
            for m in e.work.per_call_s
        )

    # -- the front door ----------------------------------------------------

    def admit(self, workflow: str, now: float) -> str:
        """Decide one arrival:
        ``admit`` | ``substitute`` | ``reject`` | ``degrade``."""
        decision = self._decide(workflow, now)
        if self.tracer is not None:
            self.tracer.on_admission_decision(workflow, decision, now)
        return decision

    def _decide(self, workflow: str, now: float) -> str:
        e = self._entries.get(workflow)
        if e is None:
            return ADMIT
        e.stats.arrived += 1
        predicted = self.predicted_delay(workflow, now, update_rate=True)
        target = e.slo.deadline_s
        if (e.slo.shed_policy == "never" or not math.isfinite(target)
                or predicted <= target * self.headroom):
            e.stats.admitted += 1
            return ADMIT
        # JIT substitution: before shedding, re-price against the
        # substitute tier — admit there when it still makes the deadline
        # (at the request's OWN class; substitution never upgrades it)
        if e.substitutes and \
                self._substituted_delay(e) <= target * self.headroom:
            e.stats.substituted += 1
            return SUBSTITUTE
        if e.slo.shed_policy == "reject":
            e.stats.rejected += 1
            return REJECT
        e.stats.degraded += 1
        return DEGRADE


def fleet_admission(qos: Dict[str, WorkflowQoS],
                    routers: Dict[str, Dict[str, object]], *,
                    predictors: Optional[Dict[str, Callable[[float], float]]] = None,
                    substitutes: Optional[Dict[str, Dict[str, object]]] = None,
                    headroom: float = 1.0) -> AdmissionController:
    """One controller for a deployed fleet.

    ``qos`` is per-workflow (slo + work model), ``routers`` is each
    workflow's router dict (workflow -> local llm name -> Router, the
    same object handed to its ClusterDriver), ``predictors`` optionally
    maps a workflow to a rate -> predicted-latency callable (e.g.
    ``lambda lam: pipeline.predict(alloc, lam).latency``).
    ``substitutes`` maps workflow -> local llm name -> the substitute
    tier's Router (mirror the driver's ``substitute_map``); workflows
    with an entry get the JIT-substitution degrade path.  The
    controller is also installed on each ``WorkflowQoS.admission``.
    """
    ctrl = AdmissionController(headroom=headroom)
    for w, q in qos.items():
        ctrl.register(
            w, q.slo, q.work,
            routers=routers.get(w, {}),
            predictor=(predictors or {}).get(w),
            substitutes=(substitutes or {}).get(w))
        q.admission = ctrl
    return ctrl
