"""Scepsy's planning core, the port's copy of ``repro.core``.

The modules chain into the paper's Fig. 2 flow:

* :mod:`repro_torch.core.trace` — LLM-level execution traces (§4 step 1);
* :mod:`repro_torch.core.aggregate` — per-LLM invocation counts,
  parallelism and execution-time shares (§4 step 2);
* :mod:`repro_torch.core.profiler` — per-LLM throughput/latency profiles
  by TP degree and chip fraction, with the flash kernel's Hopper tile plan
  on a GPU class (§4 step 3);
* :mod:`repro_torch.core.pipeline` — the Aggregate LLM Pipeline predictor
  and ``merge_pipelines`` for pooled multi-tenant fleets (§4 steps 4-5);
* :mod:`repro_torch.core.scheduler` — allocation search for one workflow
  or a fleet (§5);
* :mod:`repro_torch.core.placement` — hierarchical topology-aware
  placement over hosts and NVLink (or ICI) domains (§6);
* :mod:`repro_torch.core.telemetry` / :mod:`repro_torch.core.drift` /
  :mod:`repro_torch.core.forecast` / :mod:`repro_torch.core.replan` —
  online drift detection and arrival forecasts driving the three-rung
  re-plan ladder;
* :mod:`repro_torch.core.scepsy` — the ``deploy`` / ``deploy_multi``
  facade.

It is host code: it imports nothing of torch.  Sibling subpackages supply
the substrates: :mod:`repro_torch.serving` (the discrete-event runtime and
cost model), :mod:`repro_torch.workflows` (the servable workflows),
:mod:`repro_torch.qos` (SLO classes, queue disciplines and admission
control) and :mod:`repro_torch.obs` (spans, metrics and accuracy
reports).
"""
