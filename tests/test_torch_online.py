"""The port's online planner (``core/{telemetry,drift,forecast,replan}.py``,
``qos/admission.py`` and ``obs/``) against the JAX package's.

These modules are host code, copied byte for byte after the ``repro.`` ->
``repro_torch.`` rewrite (``tests/test_torch_planner.py`` holds the
bytes).  Here the same inputs go through both packages and must give the
same results: ``deploy_multi(online=True)``'s re-plans and adopted
allocations, a traced ``ClusterDriver`` run's export and metrics
exposition, the admission controller's decisions, and the drift and
forecast detectors on the three counterexamples the reference's own
hypothesis properties fail on (``tests/test_drift.py``; the copies keep
those faults, so the outputs are compared, not the properties).

The runs time calls on the reference's default class (v5e) in both
packages: the port's default is the H100.
"""
import dataclasses
import importlib
import itertools
import json
import math
import random
from types import SimpleNamespace

import pytest

import repro.hw as ref_hw
from repro_torch import hw
from torch_threads import one_thread  # noqa: F401  (autouse)

MODULES = {"hw": "hw", "base": "configs.base", "drift": "core.drift",
           "forecast": "core.forecast", "pipeline": "core.pipeline",
           "profiler": "core.profiler", "replan": "core.replan",
           "scheduler": "core.scheduler", "scepsy": "core.scepsy",
           "telemetry": "core.telemetry", "admission": "qos.admission",
           "slo": "qos.slo", "obs": "obs", "accuracy": "obs.accuracy",
           "deploy": "serving.deploy", "simulator": "serving.simulator",
           "registry": "workflows.registry", "runtime": "workflows.runtime"}


def _pkg(root):
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in MODULES.items()})


PORT, REF = _pkg("repro_torch"), _pkg("repro")


@pytest.fixture(autouse=True)
def v5e_default(monkeypatch):
    monkeypatch.setattr(hw, "DEFAULT_CHIP_CLASS", hw.V5E)
    monkeypatch.setattr(hw, "ICI_LINK_BW", hw.V5E.ici_link_bw)
    assert ref_hw.DEFAULT_CHIP_CLASS.name == "v5e"
    for p in (PORT, REF):
        p.profiler.clear_profile_cache()


def _plain(x):
    """A package-free value: dataclasses become (class name, fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# deploy_multi(online=True): re-plans and adopted allocations
# ---------------------------------------------------------------------------


def _spec(p):
    """``PAPER_CLUSTER_16`` (4 hosts of 4 chips, NVLink pairs) of v5e."""
    return p.hw.ClusterSpec(host_groups=(p.hw.HostGroup(4, 4, "v5e"),))


def _sharing_fleet(p):
    """``tests/test_drift.py``'s ``sharing_fleet``: two workflows over one
    shared dense config, with analytic profiles."""
    cfg = p.base.ArchConfig(name="shared-small", family="dense",
                            num_layers=16, d_model=2048, num_heads=16,
                            num_kv_heads=8, d_ff=8192, vocab_size=32_000)

    def stage(llm, size_gb, n, par=2.0):
        base_lat, t_max = 0.05 * size_gb, 40.0 / size_gb
        by_tp = {}
        for tp in (1, 2):
            tmax = t_max * (tp ** 0.85)
            rates = [f * tmax for f in (0.1, 0.3, 0.5, 0.7, 0.9)]
            lat = [base_lat / tp / max(1 - r / tmax, 0.05) for r in rates]
            by_tp[tp] = p.profiler.TPProfile(
                tp=tp, rates=rates,
                latency={"mean": lat, "p50": lat, "p90": [2 * x for x in lat],
                         "p99": [4 * x for x in lat]},
                max_throughput=tmax)
        prof = p.profiler.LLMProfile(llm=llm, arch=cfg.name,
                                     calls_per_group=n, by_tp=by_tp)
        return p.pipeline.PipelineStage(llm=llm, cfg=cfg, n=n, p=par,
                                        profile=prof, mean_share=1.0)

    pipes = {"wf_a": p.pipeline.AggregateLLMPipeline(
                 "wf_a", [stage("gen", 2.0, 2.0)]),
             "wf_b": p.pipeline.AggregateLLMPipeline(
                 "wf_b", [stage("draft", 2.0, 1.0)])}
    wfs = [p.runtime.Workflow("wf_a", lambda rng: iter(()), {"gen": cfg}),
           p.runtime.Workflow("wf_b", lambda rng: iter(()), {"draft": cfg})]
    return wfs, pipes


def _allocations(result):
    if result is None:
        return None
    per_wf = {n: {m: (a.replicas, a.tp, a.fraction, a.chip_class)
                  for m, a in r.allocations.items()}
              for n, r in result.per_workflow.items()}
    pooled = None
    if result.pooled is not None:
        pooled = {m: (a.replicas, a.tp, a.fraction, a.chip_class)
                  for m, a in result.pooled.allocations.items()}
    return result.alloc_mode, per_wf, pooled, result.welfare


def _action(act):
    if act is None:
        return None
    return (act.rung, act.reason, act.feasible, act.lam_targets,
            _plain(act.routing), _plain(act.instance_routing), act.welfare,
            _allocations(act.result), _plain(act.migration),
            [_plain(e) for e in act.events])


def _online_run(p, mode, cooldown_s):
    """Deploy the sharing fleet online, then drift it: the monitor sees
    wf_a's arrivals at the planned rate, then at 1.3x, then at 2.5x; the
    controller is stepped after each phase.  Then wf_b's rate events are
    handed to it directly: one inside the rebalance band, one past it."""
    wfs, pipes = _sharing_fleet(p)
    lams = {"wf_a": 0.4, "wf_b": 0.6}
    dep = p.scepsy.deploy_multi(
        wfs, _spec(p), lams, pipelines=pipes,
        scheduler_config=p.scheduler.SchedulerConfig(max_tp=2), mode=mode,
        online=True, replan_cooldown_s=cooldown_s)
    ctrl = dep.controller
    out = [_allocations(dep.schedule), ctrl.step()]
    t = 0.0
    for factor, n in ((1.0, 120), (1.3, 300), (2.5, 600)):
        for _ in range(n):
            ctrl.monitor.record_arrival("wf_a", t)
            t += 1.0 / (lams["wf_a"] * factor)
        out.append(_action(ctrl.step()))
    for k, (magnitude, observed) in enumerate(((0.3, 0.78), (0.9, 1.14))):
        ev = p.drift.RateDrift(workflow="wf_b", at=t + k, magnitude=magnitude,
                               observed=observed, expected=0.6)
        out.append(_action(ctrl.react([ev])))
    out += [_allocations(ctrl.result), ctrl.lam_targets,
            [h.rung for h in ctrl.history],
            {w: _plain(e) for w, e in ctrl.monitor.expectations.items()}]
    return out


@pytest.mark.parametrize("mode,cooldown_s", [("pooled", 0.0),
                                             ("partitioned", 0.0),
                                             ("pooled", 1e6)])
def test_online_deploy_replans_as_the_reference(mode, cooldown_s):
    port, ref = _online_run(PORT, mode, cooldown_s), _online_run(
        REF, mode, cooldown_s)
    assert port == ref
    assert port[1] is None  # no telemetry yet: no reaction
    rungs = {a[0] for a in port[2:7] if a is not None}
    # a partitioned fleet has no shared replicas to re-weight
    assert rungs == ({1, 2} if (mode, cooldown_s) == ("pooled", 0.0) else {2})


def test_online_share_drift_refreshes_as_the_reference():
    """The reference's rung-2 path on a real deployment: a share drift
    re-traces the drifted workflow, warm re-plans and re-bases the
    monitor onto the refreshed pipeline."""
    outs = []
    for p in (PORT, REF):
        wfs = [p.registry.get_workflow(n) for n in ("map_reduce",
                                                   "react_agent")]
        dep = p.scepsy.deploy_multi(
            wfs, _spec(p), {"map_reduce": 0.3, "react_agent": 0.3},
            mode="pooled", online=True, n_trace_requests=6,
            max_profile_groups=4)
        ctrl = dep.controller
        llm = next(iter(ctrl.pipelines["map_reduce"].stages))
        ev = p.drift.ShareDrift(workflow="map_reduce", at=1.0, magnitude=0.8,
                                llm=llm, observed=0.9, expected=0.5)
        act = ctrl.react([ev])
        outs.append((_action(act),
                     {w: _plain(e)
                      for w, e in ctrl.monitor.expectations.items()}))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == 2 and outs[0][0][2]  # rung 2, feasible


# ---------------------------------------------------------------------------
# a traced ClusterDriver run
# ---------------------------------------------------------------------------


def _traced_run(p, name, telemetry):
    wf = p.registry.get_workflow(name)
    monitor = None
    if telemetry:
        pipe, _, _ = p.scepsy.build_pipeline(
            wf, n_trace_requests=6, tp_degrees=(1,), max_profile_groups=4,
            seed=0)
        monitor = p.drift.DriftMonitor({name: p.drift.expectation_from(
            pipe, 1.0)})
    tracer = p.obs.Tracer(sample_per_workflow=16, seed=2)
    loop = p.simulator.EventLoop()
    allocs = {m: p.scheduler.Allocation(replicas=2, tp=1, fraction=1.0)
              for m in wf.llms}
    routers = p.deploy.routers_from_allocations(wf, allocs, loop)
    drv = p.runtime.ClusterDriver(wf, routers, loop, telemetry=monitor)
    p.obs.install_tracer(tracer, drivers=[drv])
    drv.schedule_open_loop(1.5, 40, seed=1, arrival_seed=101)
    loop.run(math.inf)
    export = tracer.export()
    out = {"export": json.loads(json.dumps(export)),
           "exposition": p.obs.parse_exposition(export["exposition"]),
           "chrome": tracer.to_chrome_trace(),
           "records": [(r.request_id, r.arrival, r.done)
                       for r in drv.records]}
    if monitor is not None:
        out["accuracy"] = p.accuracy.accuracy_report(
            tracer, {name: p.accuracy.expected_shares(pipe)},
            monitor=monitor)
        out["events"] = [_plain(e) for e in monitor.poll()]
    return out, export["exposition"]


@pytest.mark.parametrize("name,telemetry", [("react_agent", True),
                                            ("map_reduce", False)])
def test_traced_run_exports_as_the_reference(name, telemetry, monkeypatch):
    # the engine calls' handles come from one counter a process
    # (``ClusterDriver._uid``): both packages' start from 1 here
    for p in (PORT, REF):
        monkeypatch.setattr(p.runtime.ClusterDriver, "_uid", itertools.count(1))
    (port, port_text), (ref, ref_text) = (_traced_run(PORT, name, telemetry),
                                          _traced_run(REF, name, telemetry))
    assert port_text == ref_text
    assert port == ref
    assert port["export"]["traces"] and port["exposition"]


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _work(p, total=2.0, serial=1.0, spt=0.001):
    return p.slo.WorkModel(per_call_s={"m": 0.5}, total_s=total,
                           serial_s=serial, sec_per_token={"m": spt})


def _router(load, weights=None, failed=False):
    loads = load if isinstance(load, list) else [load]
    return SimpleNamespace(
        replicas=[SimpleNamespace(load=x, failed=failed) for x in loads],
        weights=weights)


def _admission_cases(p):
    """``tests/test_qos.py``'s admission cases, with every decision and the
    controller's stats and predicted delays kept."""
    out = []
    ctrl = p.admission.AdmissionController()
    for name, policy in (("wf_r", "reject"), ("wf_d", "degrade"),
                         ("wf_n", "never")):
        ctrl.register(name, p.slo.SLOClass(name, latency_target_s=2.0,
                                           shed_policy=policy),
                      _work(p), routers={"m": _router(50_000)})
    out.append([ctrl.admit(w, 0.0) for w in ("wf_r", "wf_d", "wf_n",
                                             "unknown")])
    out.append(ctrl.stats())
    # only routable replicas count
    ctrl = p.admission.AdmissionController()
    slo = p.slo.SLOClass("bronze", latency_target_s=2.0, shed_policy="reject")
    ctrl.register("wf", slo, _work(p), routers={
        "m": _router([50_000, 0], weights={0: 1.0, 1: 0.0})})
    ctrl.register("wf2", slo, _work(p), routers={"m": _router([50_000, 0])})
    out.append([ctrl.admit("wf", 0.0), ctrl.admit("wf2", 0.0)])
    # the predictor kicks in once the rate EWMA has samples
    ctrl = p.admission.AdmissionController()
    ctrl.register("wf", slo, _work(p), routers={"m": _router(0)},
                  predictor=lambda lam: 100.0)
    out.append([ctrl.admit("wf", 0.1 * k) for k in range(14)]
               + [ctrl.admit("wf", 2.0)])
    out.append(ctrl.predicted_delay("wf", 2.0))
    # a seeded stream over loads that rise and fall, with a substitute tier
    rng = random.Random(7)
    ctrl = p.admission.AdmissionController(headroom=1.2)
    prim, sub = _router(0), _router(0)
    ctrl.register("wf", p.slo.SLOClass("silver", latency_target_s=3.0,
                                       shed_policy="degrade"),
                  _work(p, spt=0.002), routers={"m": prim},
                  substitutes={"m": sub})
    t = 0.0
    for _ in range(200):
        t += rng.expovariate(4.0)
        prim.replicas[0].load = rng.randint(0, 4000)
        sub.replicas[0].load = rng.randint(0, 1500)
        out.append((ctrl.admit("wf", t), ctrl.predicted_delay("wf", t)))
    out += [ctrl.stats(), ctrl.substitution_rates()]
    return out


def test_admission_decides_as_the_reference():
    port, ref = _admission_cases(PORT), _admission_cases(REF)
    assert port == ref
    assert port[0] == ["reject", "degrade", "admit", "admit"]
    assert port[2] == ["reject", "admit"]


def _fleet_admission_run(p):
    """``fleet_admission`` over two workflows and a substitute tier, then a
    ``ClusterDriver`` that rejects and tags its records."""
    rej = p.slo.SLOClass("bronze", latency_target_s=0.5, shed_policy="reject")
    deg = p.slo.SLOClass("silver", latency_target_s=0.5,
                         shed_policy="degrade")
    qos = {"wf": p.slo.WorkflowQoS(slo=rej, work=_work(p, spt=0.01)),
           "wf_s": p.slo.WorkflowQoS(slo=deg, work=_work(p, spt=0.01))}
    routers = {"wf": {"m": _router(10_000)}, "wf_s": {"m": _router(10_000)}}
    ctrl = p.admission.fleet_admission(
        qos, routers, predictors={"wf": lambda lam: 0.1 + lam},
        substitutes={"wf_s": {"m": _router(0)}}, headroom=1.1)
    assert all(q.admission is ctrl for q in qos.values())
    decisions = [(w, ctrl.admit(w, 0.05 * k)) for k in range(30)
                 for w in ("wf", "wf_s")]
    loop = p.simulator.EventLoop()
    wf = p.runtime.Workflow("wf", lambda rng: iter(()), {})
    drv = p.runtime.ClusterDriver(wf, {}, loop, qos=qos["wf"])
    drv.start_request(0)
    rec = drv.records[0]
    return decisions, ctrl.stats(), ctrl.substitution_rates(), (
        rec.rejected, rec.done)


def test_fleet_admission_decides_as_the_reference():
    port, ref = _fleet_admission_run(PORT), _fleet_admission_run(REF)
    assert port == ref
    assert port[3][0] and port[3][1] < 0


# ---------------------------------------------------------------------------
# the reference properties' counterexamples
# ---------------------------------------------------------------------------


def _share_events(p, expected, values, t0=0.0, monitor=None):
    cfg = p.drift.DriftConfig(min_samples=10, share_threshold=0.4)
    mon = monitor or p.drift.DriftMonitor(
        {"wf": p.drift.Expectation(lam=1.0, shares={
            "a": expected, "b": 1.0 - expected})}, cfg)
    for i, v in enumerate(values):
        t = t0 + float(i)
        for llm, busy in (("a", v), ("b", 1.0 - v)):
            mon.record_call("wf", llm, SimpleNamespace(
                workflow_request=i, t_start_service=t,
                t_done=t + max(busy, 1e-9), output_tokens=100))
        mon.record_request_done("wf", SimpleNamespace(request_id=i,
                                                      done=t + 1.0))
    return mon, [_plain(e) for e in mon.poll()
                 if isinstance(e, p.drift.ShareDrift)]


def _no_false_trigger(p, expected=0.75, seed=0, amp=0.75):
    rng = random.Random(seed)
    band = 0.4 * max(expected, p.drift.DriftConfig().share_floor)
    values = [min(max(expected + rng.uniform(-amp, amp) * band, 0.0), 1.0)
              for _ in range(200)]
    return _share_events(p, expected, values)[1]


def _step_triggers(p, expected=0.5625, factor=2.0):
    step = min(expected * (1.0 + factor * 0.4), 0.99)
    mon, first = _share_events(p, expected, [expected] * 40)
    assert first == []
    return _share_events(p, expected, [step] * 400, t0=40.0,
                         monitor=mon)[1]


def _stationary_trigger(p, rate=1.5, headroom=1.125):
    cfg = p.forecast.ForecastConfig(bin_s=1.0, min_bins=4, lead_s=10.0,
                                    confirm=2)
    fc = p.forecast.ArrivalForecaster(["w"], cfg)
    trig = p.forecast.ForecastTrigger(fc, {"w": rate}, headroom=headroom)
    arrivals, t = [], 0.5 / rate
    while t < 80.0:
        arrivals.append(t)
        t += 1.0 / rate
    fired, i, poll = [], 0, 1.0
    while poll <= 80.0:
        while i < len(arrivals) and arrivals[i] <= poll:
            fc.observe("w", arrivals[i])
            i += 1
        fired += [(poll, _plain(ev), fc.rate("w")) for ev in trig.poll(poll)]
        poll += 1.0
    return fired, [_plain(e) for e in trig.fired]


@pytest.mark.parametrize("case", [_no_false_trigger, _step_triggers,
                                  _stationary_trigger],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_counterexamples_give_the_reference_outputs(case):
    port, ref = case(PORT), case(REF)
    assert port == ref
    assert port and all(port)  # each shows the reference's fault
