"""Per-workflow SLO classes and the pipeline-derived work model.

An :class:`SLOClass` states what a workflow's operator promised its
users: a latency target for each workflow-level request, a priority
weight (which doubles as the fair-share weight in ``wfq`` mode), and a
shed policy for overload.  Classes are attached to
:class:`repro_torch.workflows.runtime.Workflow` objects and threaded through
``deploy`` / ``deploy_multi``.

A class can carry a *relative* target (``target_factor`` x the
workflow's unloaded mean latency) so the registry can assign meaningful
classes before anything has been traced; :meth:`SLOClass.resolve` pins
the absolute target once the traced baseline is known.

The :class:`WorkModel` is the piece Scepsy uniquely contributes to
request-level scheduling: the aggregate pipeline's per-stage call counts
and unloaded latencies give an *expected remaining work* estimate for
every in-flight workflow request, which the priority discipline uses as
deadline slack minus remaining work (so a request one call from
completion jumps a fresh fan-out burst).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

SHED_POLICIES = ("never", "reject", "degrade")


@dataclass(frozen=True)
class SLOClass:
    """One service tier.

    ``latency_target_s`` is the absolute per-request latency target
    (None = unresolved or best-effort); ``target_factor`` expresses the
    target as a multiple of the workflow's unloaded mean latency and is
    resolved against traced stats by :meth:`resolve`.  ``weight`` is the
    priority / fair-share weight; ``shed_policy`` says what admission
    control may do under overload: ``never`` (always admit), ``reject``
    (drop the request at the front door), or ``degrade`` (admit it as
    best-effort — it keeps running but yields to every deadline class).
    """

    name: str
    latency_target_s: Optional[float] = None
    target_factor: Optional[float] = None
    weight: float = 1.0
    shed_policy: str = "never"

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed_policy!r}; "
                f"known: {SHED_POLICIES}"
            )
        if self.weight <= 0:
            raise ValueError(f"SLO weight must be positive, got {self.weight}")

    @property
    def best_effort(self) -> bool:
        return self.latency_target_s is None and self.target_factor is None

    def resolve(self, base_latency_s: float) -> "SLOClass":
        """Pin a relative (``target_factor``) target to an absolute one
        using the workflow's unloaded mean latency."""
        if self.latency_target_s is not None or self.target_factor is None:
            return self
        return dataclasses.replace(
            self,
            latency_target_s=base_latency_s * self.target_factor,
            target_factor=None,
        )

    @property
    def deadline_s(self) -> float:
        """Relative deadline (inf for best-effort / unresolved)."""
        if self.latency_target_s is None:
            return math.inf
        return self.latency_target_s


# Standard tiers; targets are relative so they mean something for any
# workflow (2x unloaded latency is tight once queueing appears).
GOLD = SLOClass("gold", target_factor=2.0, weight=4.0, shed_policy="never")
SILVER = SLOClass("silver", target_factor=4.0, weight=2.0, shed_policy="degrade")
BRONZE = SLOClass("bronze", target_factor=8.0, weight=1.0, shed_policy="reject")
BEST_EFFORT = SLOClass("best_effort", weight=0.5, shed_policy="reject")


@dataclass(frozen=True)
class RequestQoS:
    """Per-engine-request QoS metadata the queue disciplines read.

    ``deadline`` is absolute simulation time (inf = best-effort);
    ``remaining_s`` is the estimated LLM work still ahead of this
    request's *workflow*-level request once this call finishes, from the
    :class:`WorkModel`.  ``tenant`` is the fair-queueing identity (the
    workflow name).
    """

    tenant: str
    slo: str = ""
    weight: float = 1.0
    deadline: float = math.inf
    remaining_s: float = 0.0
    degraded: bool = False

    def slack(self, now: float) -> float:
        """Deadline slack minus estimated remaining work — the priority
        discipline's urgency key (smaller = more urgent)."""
        return (self.deadline - now) - self.remaining_s


@dataclass(frozen=True)
class WorkModel:
    """Expected per-request work of one workflow, from its aggregate
    pipeline (per-stage n_m, p_m and unloaded latency).

    ``per_call_s[m]`` — expected unloaded seconds of one call to stage m;
    ``total_s`` — expected total LLM-busy seconds per workflow request
    (Σ n_m · per_call_s[m], the remaining-work budget);
    ``serial_s`` — expected critical-path seconds (Σ n_m/p_m · ...), the
    service-time part of the admission delay estimate;
    ``sec_per_token[m]`` — per-token service-time proxy used to convert
    a replica's queued tokens into queueing seconds.
    """

    per_call_s: Dict[str, float]
    total_s: float
    serial_s: float
    sec_per_token: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_pipeline(cls, pipeline, stats=None,
                      percentile: str = "mean") -> "WorkModel":
        """Build from an :class:`AggregateLLMPipeline` (optionally with
        the traced :class:`WorkflowStats` for token-level calibration)."""
        per_call: Dict[str, float] = {}
        spt: Dict[str, float] = {}
        total = 0.0
        serial = 0.0
        for m, st in pipeline.stages.items():
            tp0 = st.profile.tps()[0]
            cap = st.profile.max_throughput(tp0)
            rate = 0.05 * cap if math.isfinite(cap) and cap > 0 else 0.0
            lm = st.profile.latency(rate, tp0, percentile=percentile)
            if not math.isfinite(lm):
                lm = 0.0
            per_call[m] = lm
            total += lm * st.n
            serial += lm * st.n / max(st.p, 1.0)
            tokens = 0.0
            if stats is not None and m in stats.per_llm:
                s = stats.per_llm[m]
                tokens = s.mean_prompt_tokens + s.mean_output_tokens
            if tokens <= 0:
                tokens = 1024.0
            spt[m] = lm / tokens
        return cls(per_call_s=per_call, total_s=total, serial_s=serial,
                   sec_per_token=spt)

    def remaining_after(self, issued_s: float) -> float:
        """Remaining-work estimate once ``issued_s`` seconds of expected
        call work have been dispatched."""
        return max(self.total_s - issued_s, 0.0)


@dataclass
class WorkflowQoS:
    """Everything the runtime needs to enforce one workflow's QoS:
    the (resolved) SLO class, the work model, and optionally a
    cluster-front admission controller."""

    slo: SLOClass
    work: WorkModel
    admission: Optional[object] = None  # AdmissionController, duck-typed
