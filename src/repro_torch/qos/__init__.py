"""Request-level QoS, the port's copy of what the planner reads of
``repro.qos``: :mod:`repro_torch.qos.slo` (SLO classes and the
pipeline-derived work model) and :mod:`repro_torch.qos.policy` (the
simulated engines' queue disciplines).  Admission control is not ported
yet."""
