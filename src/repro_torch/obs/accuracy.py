"""Observed-vs-predicted reconciliation — the paper-closing analyzer.

Scepsy's aggregate abstraction stands on two empirical claims: per-LLM
*execution-time shares* are stable across executions (so a workflow can
be summarized by its aggregate pipeline), and the pipeline's
:class:`~repro_torch.core.pipeline.Prediction` prices latency well enough to
drive allocation.  This module audits both against a live run:

* :func:`expected_shares` — what the deployed plan *assumed*: profiled
  ``mean_share`` from a :class:`~repro_torch.core.aggregate.WorkflowStats`,
  an :class:`~repro_torch.core.pipeline.AggregateLLMPipeline`'s stages, or a
  :class:`~repro_torch.core.pipeline.MergedPipeline`'s per-workflow members;
* :func:`share_report` — observed shares (the tracer's busy-seconds
  totals over every completed call — the same weighting
  :func:`expected_shares` applies to the planned pipeline) against
  expected, with per-LLM and max relative error;
* :func:`critical_path_report` — which stage dominates each workflow's
  end-to-end time, from sampled span phases (each group phase is
  attributed to its last-finishing call's LLM; tool phases to
  ``tool``), with the exact-tiling residual check;
* :func:`predictor_report` — measured request latency against the
  deployed allocation's ``Prediction`` (total and per-LLM serial
  contributions);
* :func:`accuracy_report` — all of the above in one JSON-safe dict,
  optionally feeding :meth:`DriftMonitor.corroborate
  <repro_torch.core.drift.DriftMonitor.corroborate>`.
"""
from __future__ import annotations

from typing import Dict, Optional

SHARE_FLOOR = 0.02  # relative-error denominator floor (matches DriftConfig)


def _normalize(row: Dict[str, float]) -> Dict[str, float]:
    total = sum(row.values())
    if total <= 0:
        return dict(row)
    return {m: v / total for m, v in row.items()}


def expected_shares(source, workflow: Optional[str] = None
                    ) -> Dict[str, float]:
    """Planned per-LLM execution-time shares, duck-dispatched:

    * ``WorkflowStats`` — profiled ``per_llm[m].mean_share``;
    * ``MergedPipeline`` + ``workflow`` — that workflow's members, each
      weighted by calls/request times the member profile's low-load
      latency (the tenant decomposition of the profiled shares);
    * any other ``AggregateLLMPipeline`` — its stages' ``mean_share``.

    Always normalized to sum to 1 over the LLMs present.
    """
    per_llm = getattr(source, "per_llm", None)
    if per_llm is not None:  # WorkflowStats
        return _normalize({m: st.mean_share for m, st in per_llm.items()})
    members_of = getattr(source, "members_of", None)
    if members_of is not None and workflow is not None:  # MergedPipeline
        # keyed by the member's workflow-local stage name (``t.llm``) —
        # the name the driver dispatches (and the tracer observes) under
        row: Dict[str, float] = {}
        for _cid, members in members_of(workflow).items():
            for t in members:
                tp0 = 1
                cap = t.profile.max_throughput(tp0)
                lat = t.profile.latency(0.05 * cap if cap > 0 else 0.0, tp0)
                row[t.llm] = row.get(t.llm, 0.0) + t.n * lat
        return _normalize(row)
    stages = getattr(source, "stages", None)
    if stages is not None:  # AggregateLLMPipeline
        return _normalize({m: st.mean_share for m, st in stages.items()})
    raise TypeError(f"cannot derive expected shares from {type(source)!r}")


def share_report(observed: Dict[str, Dict[str, float]],
                 expected: Dict[str, Dict[str, float]]) -> dict:
    """Per-(workflow, LLM) observed-vs-expected share errors.

    ``rel_err`` divides by ``max(expected, SHARE_FLOOR)`` so a tiny
    planned share cannot manufacture a huge relative error; ``max_rel_
    err`` over all pairs is the value ``bench_obs`` gates at 15%.
    """
    per_workflow: Dict[str, dict] = {}
    worst = 0.0
    for w in sorted(set(observed) & set(expected)):
        obs_row, exp_row = observed[w], expected[w]
        rows: Dict[str, dict] = {}
        w_worst = 0.0
        for m in sorted(set(obs_row) | set(exp_row)):
            o = obs_row.get(m, 0.0)
            e = exp_row.get(m, 0.0)
            rel = abs(o - e) / max(e, SHARE_FLOOR)
            rows[m] = {"observed": o, "expected": e, "rel_err": rel}
            w_worst = max(w_worst, rel)
        per_workflow[w] = {"per_llm": rows, "max_rel_err": w_worst}
        worst = max(worst, w_worst)
    return {"per_workflow": per_workflow, "max_rel_err": worst}


def critical_path_report(tracer) -> dict:
    """Where each workflow's end-to-end time goes, from sampled spans.

    Each finished sampled request's phases are attributed: a group phase
    to the LLM of its last-finishing call, a tool phase to ``tool``.
    Phases tile ``[arrival, done]`` by construction, so per workflow the
    attributed seconds sum to the sampled total latency — ``residual``
    (relative) reports how exactly, and ``dominant`` names the stage
    with the largest attributed fraction.
    """
    out: Dict[str, dict] = {}
    acc: Dict[str, Dict[str, float]] = {}
    lat: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for tr in tracer.traces(finished_only=True):
        if tr["outcome"] == "rejected":
            continue
        w = tr["workflow"]
        row = acc.setdefault(w, {})
        for ph in tr["phases"]:
            dur = ph["t1"] - ph["t0"]
            key = (ph.get("critical_llm") or "unattributed"
                   if ph["kind"] == "group" else "tool")
            row[key] = row.get(key, 0.0) + dur
        lat[w] = lat.get(w, 0.0) + (tr["done"] - tr["arrival"])
        cnt[w] = cnt.get(w, 0) + 1
    for w, row in acc.items():
        total = lat[w]
        attributed = sum(row.values())
        residual = abs(total - attributed) / total if total > 0 else 0.0
        breakdown = {k: {"seconds": v,
                         "fraction": v / total if total > 0 else 0.0}
                     for k, v in sorted(row.items(), key=lambda kv: -kv[1])}
        dominant = max(row, key=row.get) if row else ""
        out[w] = {"sampled_requests": cnt[w],
                  "mean_latency": total / cnt[w] if cnt[w] else 0.0,
                  "breakdown": breakdown,
                  "dominant": dominant,
                  "residual_rel": residual}
    return out


def predictor_report(tracer, predictions: Dict[str, object]) -> dict:
    """Measured request latency vs the deployed ``Prediction``.

    ``predictions`` maps workflow -> :class:`repro_torch.core.pipeline.
    Prediction` (e.g. from ``MergedPipeline.attribute`` or a plain
    pipeline's ``predict``).  Reports mean/p50/p99 measured latency,
    the predicted latency, their ratio, and the prediction's per-LLM
    serial contributions for side-by-side reading with the critical-
    path breakdown.
    """
    out: Dict[str, dict] = {}
    for w, pred in sorted(predictions.items()):
        meas = tracer.request_latency(w)
        if not meas.get("count"):
            continue
        predicted = pred.latency
        out[w] = {
            "measured": meas,
            "predicted_latency": predicted,
            "ratio_mean_over_predicted": (
                meas["mean"] / predicted if predicted > 0 else float("inf")),
            "feasible": pred.feasible,
            "bottleneck_llm": pred.bottleneck_llm,
            "per_llm_predicted": dict(pred.per_llm_latency),
        }
    return out


def accuracy_report(tracer, expected: Dict[str, Dict[str, float]], *,
                    predictions: Optional[Dict[str, object]] = None,
                    monitor=None, tol: float = 0.25) -> dict:
    """One JSON-safe reconciliation document for a finished run.

    ``expected`` maps workflow -> planned shares (see
    :func:`expected_shares`); ``predictions`` optionally adds the
    predictor-error section; ``monitor`` (a :class:`repro_torch.core.drift.
    DriftMonitor`) additionally cross-checks the tracer's shares
    against the monitor's EWMAs (:meth:`DriftMonitor.corroborate
    <repro_torch.core.drift.DriftMonitor.corroborate>`).
    """
    observed = tracer.observed_shares()
    report = {
        "shares": share_report(observed, expected),
        "critical_path": critical_path_report(tracer),
    }
    if predictions is not None:
        report["predictor"] = predictor_report(tracer, predictions)
    if monitor is not None:
        report["corroboration"] = monitor.corroborate(observed, tol=tol)
    return report
