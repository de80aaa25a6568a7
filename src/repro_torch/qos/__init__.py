"""Request-level QoS: SLO classes, queue disciplines, admission control.

The allocation layer (scheduler + placement) decides *where replicas
live*; this package decides *which request a replica serves next* and
*whether the cluster front door accepts a request at all*:

* :mod:`repro_torch.qos.slo` — per-workflow SLO classes (latency target,
  priority weight, shed policy) plus the aggregate-pipeline-derived
  :class:`~repro_torch.qos.slo.WorkModel` that estimates a workflow request's
  remaining work;
* :mod:`repro_torch.qos.policy` — pluggable :class:`EngineSim` queue
  disciplines (``fifo`` | ``priority`` | ``wfq``);
* :mod:`repro_torch.qos.admission` — cluster-front admission control and load
  shedding driven by the pipeline predictor's delay estimate.
"""

from repro_torch.qos.admission import AdmissionController, fleet_admission
from repro_torch.qos.policy import (
    DRRDiscipline,
    FifoDiscipline,
    PriorityDiscipline,
    QueueDiscipline,
    make_policy,
)
from repro_torch.qos.slo import (
    BEST_EFFORT,
    BRONZE,
    GOLD,
    SILVER,
    RequestQoS,
    SLOClass,
    WorkModel,
    WorkflowQoS,
)

__all__ = [
    "AdmissionController",
    "fleet_admission",
    "QueueDiscipline",
    "FifoDiscipline",
    "PriorityDiscipline",
    "DRRDiscipline",
    "make_policy",
    "SLOClass",
    "RequestQoS",
    "WorkModel",
    "WorkflowQoS",
    "GOLD",
    "SILVER",
    "BRONZE",
    "BEST_EFFORT",
]
