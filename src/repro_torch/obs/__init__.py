"""Observability: tracing, metrics exposition, predictor accuracy.

Three layers over the serving stack (see ``docs/observability.md``):

* :mod:`repro_torch.obs.spans` — a :class:`Tracer` hook installed on the
  driver / engine / router / admission / replan layers; per-workflow
  reservoir-sampled span records exportable as Chrome ``trace_event``
  JSON.  Every hook site is guarded by ``tracer is None``, so the
  un-instrumented hot path is untouched (zero cost when disabled).
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  Prometheus-style text exposition, fed by the same hooks.
* :mod:`repro_torch.obs.accuracy` — observed-vs-predicted reconciliation:
  per-(workflow, LLM) execution shares against the deployed pipeline's
  ``mean_share``, per-stage serial latency against ``Prediction``
  contributions, and a critical-path breakdown per workflow.
"""
from repro_torch.obs.metrics import MetricsRegistry, parse_exposition
from repro_torch.obs.spans import Tracer, chrome_trace, install_tracer
from repro_torch.obs.accuracy import (accuracy_report, critical_path_report,
                                expected_shares, predictor_report,
                                share_report)

__all__ = [
    "MetricsRegistry",
    "parse_exposition",
    "Tracer",
    "chrome_trace",
    "install_tracer",
    "accuracy_report",
    "critical_path_report",
    "expected_shares",
    "predictor_report",
    "share_report",
]
