"""The port's Scepsy planner (``repro_torch``: hw, configs, serving cost
model and simulator, core, qos, workflows, launch.serve) against the JAX
package's, and the flash kernel's Hopper tile plan.

The planner is host code with no JAX in either package, so the same
workflow, cluster and seed must give the same traces, aggregate shares,
profile curves, allocations and placements, and predictions within 1e-9
relative.  Most cases use the small pipeline arguments (10 traced
requests, TP 1 and 2, 8 profile groups); one full ``deploy`` per workflow
runs on the 8-GPU H100 host.
"""
import ast
import dataclasses
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs.registry as ref_registry
import repro.core.profiler as ref_profiler
import repro.core.scepsy as ref_scepsy
import repro.hw as ref_hw
import repro.serving.simulator as ref_simulator
import repro.workflows.baselines as ref_baselines
import repro.workflows.beam_search as ref_beam
import repro.workflows.debate as ref_debate
import repro.workflows.map_reduce as ref_map_reduce
import repro.workflows.rag_reranker as ref_rag
import repro.workflows.react_agent as ref_react
import repro.workflows.registry as ref_registry_wf
import repro.workflows.runtime as ref_runtime
import repro.workflows.session as ref_session
from repro_torch import hw
from repro_torch.configs.registry import REGISTRY
from repro_torch.core import profiler as scepsy_profiler
from repro_torch.core import scepsy
from repro_torch.core.profiler import extract_groups
from repro_torch.kernels.tile_plan import SMEM_PER_BLOCK, tile_plan
from repro_torch.distributed.fault_tolerance import FaultToleranceController
from repro_torch.serving import costmodel as cm
from repro_torch.serving import simulator
from repro_torch.workflows import baselines, registry, runtime
from repro_torch.workflows.beam_search import BEAM_SEARCH
from repro_torch.workflows.debate import DEBATE
from repro_torch.workflows.map_reduce import MAP_REDUCE
from repro_torch.workflows.rag_reranker import RAG_RERANKER
from repro_torch.workflows.react_agent import REACT_AGENT
from repro_torch.workflows.session import RECURSIVE_AGENT, SESSION_CHAT

REPO = Path(__file__).resolve().parent.parent
REL = 1e-9
SMALL = dict(n_trace_requests=10, tp_degrees=(1, 2), max_profile_groups=8)
WORKFLOWS = {"beam_search": (BEAM_SEARCH, ref_beam.BEAM_SEARCH),
             "rag_reranker": (RAG_RERANKER, ref_rag.RAG_RERANKER),
             "react_agent": (REACT_AGENT, ref_react.REACT_AGENT),
             "debate": (DEBATE, ref_debate.DEBATE),
             "map_reduce": (MAP_REDUCE, ref_map_reduce.MAP_REDUCE),
             "session_chat": (SESSION_CHAT, ref_session.SESSION_CHAT),
             "recursive_agent": (RECURSIVE_AGENT, ref_session.RECURSIVE_AGENT)}

# the modules copied verbatim: their source is the reference's with
# ``repro.`` rewritten to ``repro_torch.``
VERBATIM = ("serving/eventloop.py", "serving/radix.py", "serving/simulator.py",
            "serving/deploy.py", "core/trace.py", "core/aggregate.py",
            "core/pipeline.py", "core/placement.py", "core/scheduler.py",
            "qos/slo.py", "qos/policy.py", "workflows/runtime.py",
            "workflows/beam_search.py", "workflows/rag_reranker.py",
            "workflows/react_agent.py", "workflows/debate.py",
            "workflows/map_reduce.py", "workflows/session.py",
            "workflows/registry.py", "workflows/traffic.py",
            "workflows/baselines.py", "distributed/fault_tolerance.py")
# the copies that are edited for the port, and why
EDITED = {
    "hw.py": "the h100 class is the default; H100 host layouts",
    "configs/base.py": "the trimmed ArchConfig (no dry-run shapes)",
    "serving/costmodel.py": "docstring names the classes it prices",
    "core/profiler.py": "the Hopper tile plan replaces the TPU autotuner",
    "core/scepsy.py": "deploy_multi(online=True) is not ported",
    "core/__init__.py": "lists only what the port has",
    "launch/serve.py": "--gpus builds 8-GPU NVLink hosts",
}


def _rewrite(text: str) -> str:
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    return text.replace("from repro import", "from repro_torch import")


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_equal_the_reference(rel):
    ref = (REPO / "src" / "repro" / rel).read_text()
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    assert port == _rewrite(ref), f"{rel} differs from its reference"


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copies_exist_and_differ_from_the_reference(rel):
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    ref = REPO / "src" / "repro" / rel
    assert not ref.exists() or port != _rewrite(ref.read_text())


@pytest.mark.parametrize("rel", VERBATIM + tuple(sorted(EDITED)) + (
    "kernels/tile_plan.py", "qos/__init__.py", "workflows/__init__.py"))
def test_planner_is_host_code(rel):
    """The planner and the tile plan import nothing of torch (the JAX side
    is checked for every port file in test_torch_isolation.py)."""
    tree = ast.parse((REPO / "src" / "repro_torch" / rel).read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "torch" not in roots


# ---------------------------------------------------------------------------
# hardware and configs
# ---------------------------------------------------------------------------


REF_FIELDS = [f.name for f in dataclasses.fields(ref_hw.ChipClass)]


@pytest.mark.parametrize("name", ["v5e", "v5p", "v4i"])
def test_tpu_classes_equal_the_reference(name):
    port, ref = hw.chip_class(name), ref_hw.chip_class(name)
    assert {f: getattr(port, f) for f in REF_FIELDS} == dataclasses.asdict(ref)
    assert port.sms == 0


def test_h100_is_the_default_class_with_data_sheet_values():
    h = hw.H100
    assert hw.DEFAULT_CHIP_CLASS is h and hw.chip_class("h100") is h
    assert (h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12,
                                                          80 * 10**9)
    assert (h.ici_link_bw, h.ici_links_per_chip, h.dci_bw) == (450e9, 18, 50e9)
    assert (h.vmem_bytes, h.host_to_hbm_bw, h.sms) == (232448, 64e9, 132)
    # uncalibrated: the class defaults
    default = hw.ChipClass("x", 1.0, 1.0, 1)
    assert (h.mxu_efficiency, h.hbm_efficiency, h.collective_latency) == (
        default.mxu_efficiency, default.hbm_efficiency,
        default.collective_latency)
    assert (hw.HBM_BYTES, hw.PEAK_FLOPS_BF16, hw.ICI_LINK_BW) == (
        h.hbm_bytes, h.peak_flops_bf16, h.ici_link_bw)
    assert hw.HostGroup(1, 8).chip_class == "h100"


def test_h100_host_layouts():
    for spec, n in ((hw.H100_HOST_8, 8), (hw.H100_CLUSTER_32, 32)):
        assert spec.num_chips == n and spec.hb_domain_size == 8
        table = spec.chip_table()
        assert {row[2] for row in table} == {"h100"}
        # one NVLink domain per host
        assert all(host == domain for host, domain, _ in table)
    # ClusterSpec keeps the reference's own defaults
    assert dataclasses.asdict(hw.ClusterSpec()) == dataclasses.asdict(
        ref_hw.ClusterSpec())


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_param_counts_equal_the_reference(name):
    port, ref = REGISTRY[name], ref_registry.get_config(name)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.is_encdec == ref.is_encdec


# ---------------------------------------------------------------------------
# the planner against the reference
# ---------------------------------------------------------------------------


def _close(a: float, b: float) -> bool:
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _curves(pipeline):
    out = {}
    for m, st in pipeline.stages.items():
        out[m] = (st.n, st.p, {
            cls: {tp: (p.rates, p.latency, p.max_throughput, p.chip_class)
                  for tp, p in table.items()}
            for cls, table in st.profile.by_class.items()})
    return out


def _allocations(schedule, default_as=None):
    # the port binds no class on its default (h100) class, as the
    # reference binds none on its own default; ``default_as`` names the
    # binding the reference gives the same class when it is not its default
    return {m: (a.replicas, a.tp, a.fraction, a.chip_class or default_as)
            for m, a in schedule.allocations.items()}


def _placement(placement, default_as=None):
    return [(i.llm, i.replica, i.tp, i.chips, i.units_per_chip, i.host,
             i.domain, i.chip_class or default_as)
            for i in placement.instances]


def _assert_same_plan(port, ref):
    pp, rp = port.schedule.prediction, ref.schedule.prediction
    assert pp.feasible == rp.feasible
    assert _close(pp.latency, rp.latency)
    assert _close(pp.max_throughput, rp.max_throughput)
    assert pp.per_llm_latency.keys() == rp.per_llm_latency.keys()
    assert all(_close(pp.per_llm_latency[m], rp.per_llm_latency[m])
               for m in pp.per_llm_latency)
    assert _allocations(port.schedule) == _allocations(ref.schedule)
    assert _placement(port.placement) == _placement(ref.placement)
    port.placement.validate()


def _pipelines(name, port_spec, ref_spec):
    """Small pipelines of both packages for one workflow and spec."""
    wf, ref_wf = WORKFLOWS[name]
    pipe, stats, store = scepsy.build_pipeline(
        wf, chip_classes=scepsy._spec_chip_classes(port_spec),
        **SMALL)
    rpipe, rstats, rstore = ref_scepsy.build_pipeline(
        ref_wf, chip_classes=ref_scepsy._spec_chip_classes(ref_spec),
        **SMALL)
    assert dataclasses.asdict(store) == dataclasses.asdict(rstore)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    return pipe, rpipe


@pytest.fixture(autouse=True)
def fresh_profile_caches():
    """Each test profiles from scratch in both packages: the sweep memo is
    keyed by the trace's shape, not by the class its calls were timed on,
    and the tests below time traces on more than one class."""
    scepsy_profiler.clear_profile_cache()
    ref_profiler.clear_profile_cache()
    yield
    scepsy_profiler.clear_profile_cache()
    ref_profiler.clear_profile_cache()


def _v5p_specs():
    groups = (hw.HostGroup(2, 4, "v5p"),)
    ref_groups = (ref_hw.HostGroup(2, 4, "v5p"),)
    return (hw.hetero_cluster(groups, hb_domain_size=4),
            ref_hw.hetero_cluster(ref_groups, hb_domain_size=4))


@pytest.mark.parametrize("name", sorted(WORKFLOWS))
def test_deploy_on_v5p_equals_the_reference(name, monkeypatch):
    """v5p is a non-default class in both packages.  The tracer times each
    call on the default class, so the port runs with the reference's
    default (v5e) here, and every step must then agree."""
    monkeypatch.setattr(hw, "DEFAULT_CHIP_CLASS", hw.V5E)
    spec, ref_spec = _v5p_specs()
    pipe, rpipe = _pipelines(name, spec, ref_spec)
    curves = _curves(pipe)
    assert curves == _curves(rpipe)
    assert all(set(c[2]) == {"v5p"} for c in curves.values())
    wf, ref_wf = WORKFLOWS[name]
    port = scepsy.deploy(wf, spec, 0.4, pipeline=pipe)
    ref = ref_scepsy.deploy(ref_wf, ref_spec, 0.4, pipeline=rpipe)
    _assert_same_plan(port, ref)
    # a TPU class gets no Hopper tile plan
    assert all(p.block_plan is None for st in pipe.stages.values()
               for p in st.profile.by_class["v5p"].values())


@pytest.fixture
def ref_h100():
    """The port's H100 class registered in the reference, for one test."""
    cls = ref_hw.register_chip_class(ref_hw.ChipClass(
        **{f: getattr(hw.H100, f) for f in REF_FIELDS}))
    try:
        yield cls
    finally:
        del ref_hw.CHIP_CLASSES[cls.name]


def _h100_specs(hosts=1):
    return (hw.hetero_cluster((hw.HostGroup(hosts, 8, "h100"),),
                              hb_domain_size=8),
            ref_hw.hetero_cluster((ref_hw.HostGroup(hosts, 8, "h100"),),
                                  hb_domain_size=8))


@pytest.mark.parametrize("name", sorted(WORKFLOWS))
def test_small_deploy_on_h100_equals_the_reference(name, ref_h100,
                                                   monkeypatch):
    """On one 8-GPU host, with the port's H100 as the reference's default
    class too (so that both time their traces on it), every step agrees."""
    monkeypatch.setattr(ref_hw, "DEFAULT_CHIP_CLASS", ref_h100)
    spec, ref_spec = _h100_specs()
    pipe, rpipe = _pipelines(name, spec, ref_spec)
    assert _curves(pipe) == _curves(rpipe)
    wf, ref_wf = WORKFLOWS[name]
    port = scepsy.deploy(wf, spec, 0.4, pipeline=pipe)
    ref = ref_scepsy.deploy(ref_wf, ref_spec, 0.4, pipeline=rpipe)
    _assert_same_plan(port, ref)


# allocations (replicas, tp, fraction) of the full deploy on one 8-GPU
# H100 host at 0.4 req/s (n_trace_requests=30, seed 0)
H100_HOST_8_PLANS = {
    "beam_search": {"gen": (1, 4, 1.0), "ver": (1, 4, 1.0)},
    "rag_reranker": {"gen": (1, 4, 1.0), "rer": (2, 1, 1.0),
                     "emb": (1, 1, 1.0)},
}


@pytest.mark.parametrize("name", sorted(H100_HOST_8_PLANS))
def test_full_deploy_on_an_h100_host_matches_the_reference(name, ref_h100):
    """The port's own full deploy on one 8-GPU host against the reference
    with the H100 registered beside its v5e default (it binds the plan to
    class "h100" and times its traces on v5e, so predictions differ in the
    fourth digit): the same allocations and placements."""
    spec, ref_spec = _h100_specs()
    wf, ref_wf = WORKFLOWS[name]
    port = scepsy.deploy(wf, spec, 0.4, n_trace_requests=30, seed=0)
    ref = ref_scepsy.deploy(ref_wf, ref_spec, 0.4, n_trace_requests=30,
                            seed=0)
    assert port.schedule.prediction.feasible and ref.schedule.prediction.feasible
    assert _allocations(port.schedule, "h100") == _allocations(ref.schedule)
    assert _placement(port.placement, "h100") == _placement(ref.placement)
    assert {m: a[:3] for m, a in _allocations(port.schedule).items()} == \
        H100_HOST_8_PLANS[name]
    port.placement.validate()
    # every TP group inside one NVLink domain, every model within HBM
    table = spec.chip_table()
    for inst in port.placement.instances:
        assert len({table[c][1] for c in inst.chips}) == 1
    for m, a in port.schedule.allocations.items():
        assert cm.max_batch_size(wf.llms[m], 2048, tp=a.tp,
                                 fraction=a.fraction, chip=hw.H100) >= 1


def test_uniform_default_spec_profiles_and_plans_on_h100():
    spec = hw.ClusterSpec()
    pipe, _, store = scepsy.build_pipeline(RAG_RERANKER, **SMALL)
    for m, st in pipe.stages.items():
        assert set(st.profile.by_class) == {"h100"}
        assert st.profile.by_tp is st.profile.by_class["h100"]
        # the traced context the profiler plans the prefill at
        groups = extract_groups(store, m)[:SMALL["max_profile_groups"]]
        calls = [c for g in groups for c in g.calls]
        context = int(sum(c.prompt_tokens for c in calls) / len(calls)
                      + sum(c.output_tokens for c in calls) / len(calls))
        cfg = RAG_RERANKER.llms[m]
        for tp, prof in st.profile.by_tp.items():
            assert prof.chip_class == "h100"
            assert prof.block_plan == tile_plan(
                1, cfg.num_heads // tp, context, cfg.head_dim, hw.H100.sms)
    dep = scepsy.deploy(RAG_RERANKER, spec, 0.4, pipeline=pipe)
    assert dep.schedule.prediction.feasible
    assert all(a.chip_class is None for a in dep.schedule.allocations.values())
    dep.placement.validate()


def test_deploy_multi_online_is_not_ported():
    spec = hw.H100_CLUSTER_32
    with pytest.raises(NotImplementedError, match="A6"):
        scepsy.deploy_multi([BEAM_SEARCH, RAG_RERANKER], spec,
                            {"beam_search": 0.4, "rag_reranker": 0.4},
                            online=True)


def test_serve_launcher_plans_and_serves_on_8_gpus():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workflow",
         "beam_search", "--gpus", "8", "--rate", "0.4", "--requests", "20"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "on 8 h100 GPUs" in out.stdout
    assert re.search(r"gen: replicas=1 tp=4 fraction=1\.00", out.stdout)
    assert re.search(r"ver: replicas=1 tp=4 fraction=1\.00", out.stdout)
    assert "== served 20 requests" in out.stdout


# ---------------------------------------------------------------------------
# the workflow registry, the paper's baselines and fault tolerance
# ---------------------------------------------------------------------------


def test_registry_lists_every_workflow_with_the_reference_slo():
    assert registry.workflow_names() == ref_registry_wf.workflow_names()
    assert set(WORKFLOWS) == set(registry.workflow_names())
    for name in registry.workflow_names():
        port, ref = registry.get_workflow(name), ref_registry_wf.get_workflow(name)
        assert dataclasses.asdict(port.slo) == dataclasses.asdict(ref.slo)
        assert sorted(port.llms) == sorted(ref.llms)
    with pytest.raises(KeyError, match="unknown workflow"):
        registry.get_workflow("nope")


# (system, its options, workflow, cluster, rate in req/s): the three
# systems the paper compares Scepsy against, and the autoscaler without
# prefix caching
BASELINES = {
    "k8s-hpa": ("KubernetesHPA", {}, "react_agent", "PAPER_CLUSTER_4", 1.0),
    "k8s-hpa-no-prefix": ("KubernetesHPA", {"prefix_caching": False},
                          "session_chat", "PAPER_CLUSTER_4", 1.0),
    "aegaeon": ("AegaeonLike", {}, "map_reduce", "PAPER_CLUSTER_8", 0.4),
    "ayo": ("AyoLike", {}, "debate", "PAPER_CLUSTER_4", 0.5),
}


def _baseline_run(hw_mod, sim_mod, base_mod, runtime_mod, wf, case):
    """(throughput, mean latency, completed) of 20 seeded open-loop
    requests, as ``tests/test_integration.py`` measures them."""
    system, options, _, cluster, rate = case
    loop = sim_mod.EventLoop()
    sysm = getattr(base_mod, system)(wf, getattr(hw_mod, cluster), loop, **options)
    recs = runtime_mod.ClusterDriver(wf, sysm.routers, loop).run_open_loop(
        rate, 20, seed=11, until=1e5)
    recs = [r for r in recs if r.done >= 0]
    span = max(r.done for r in recs) - min(r.arrival for r in recs)
    return len(recs) / span, sum(r.latency for r in recs) / len(recs), len(recs)


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_run_equals_the_reference(name, monkeypatch):
    """Each baseline serves the same seeded traffic as the reference's,
    with the reference's default class (v5e) as the port's default here:
    the same throughput, mean latency and completed count."""
    monkeypatch.setattr(hw, "DEFAULT_CHIP_CLASS", hw.V5E)
    monkeypatch.setattr(hw, "ICI_LINK_BW", hw.V5E.ici_link_bw)
    assert ref_hw.DEFAULT_CHIP_CLASS.name == "v5e"
    assert ref_hw.ICI_LINK_BW == hw.V5E.ici_link_bw
    case = BASELINES[name]
    wf, ref_wf = WORKFLOWS[case[2]]
    port = _baseline_run(hw, simulator, baselines, runtime, wf, case)
    ref = _baseline_run(ref_hw, ref_simulator, ref_baselines, ref_runtime, ref_wf, case)
    assert port[2] == ref[2] == 20
    assert all(math.isfinite(x) for x in port)
    assert _close(port[0], ref[0]) and _close(port[1], ref[1])


def test_failure_detection_and_remesh():
    """The reference's ``test_failure_detection_and_remesh`` on the copy."""
    ftc = FaultToleranceController(8, grace=10.0, model_ways=16)
    for w in range(8):
        ftc.heartbeat(w, 0.0)
    assert ftc.check(5.0) is None
    for w in range(7):  # worker 7 goes silent
        ftc.heartbeat(w, 20.0)
    plan = ftc.check(28.0)  # 7 last seen at t=0 (>grace); others at t=20
    assert plan is not None
    assert plan.dropped_workers == (7,)
    assert plan.data_ways == 4  # largest pow2 <= 7
    assert plan.restart_from_checkpoint
    assert 7 not in ftc.alive_workers()


def test_straggler_detection():
    """The reference's ``test_straggler_detection`` on the copy."""
    ftc = FaultToleranceController(4, straggler_factor=2.0, patience=2)
    for t in range(5):
        for w in range(4):
            ftc.heartbeat(w, float(t))
            ftc.report_step(w, 1.0 if w != 2 else 5.0)
        plan = ftc.check(float(t))
        if plan:
            assert 2 in plan.dropped_workers
            return
    pytest.fail("straggler never detected")


# ---------------------------------------------------------------------------
# the Hopper tile plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args, want", [
    # llama-3.1-8b prefill
    ((1, 32, 1000, 128, 132), (2, 128, 128, 3, 230528, 256)),
    # reranker-minilm
    ((1, 12, 286, 32, 132), (1, 64, 128, 3, 107648, 60)),
    # gemma-7b, D = 256
    ((1, 16, 1000, 256, 132), (1, 64, 64, 3, 230528, 256)),
    # e5-base-v2
    ((1, 12, 512, 64, 132), (1, 64, 128, 3, 107648, 96)),
    # S = 256, H = 32: 64 blocks of 128 rows would leave SMs idle
    ((1, 32, 256, 128, 132), (1, 64, 128, 3, 214144, 128)),
    # at the edge: 132 tiles of 128 rows fill 132 SMs, not 133
    ((1, 33, 512, 128, 132), (2, 128, 128, 3, 230528, 132)),
    ((1, 33, 512, 128, 133), (1, 64, 128, 3, 214144, 264)),
])
def test_tile_plan_worked_values(args, want):
    p = tile_plan(*args)
    assert p.kernel_numbers() + (p.blocks,) == want
    assert p.waves == -(-p.blocks // args[-1])


# shared memory in floats: Q and K tiles at a pitch of D + 4, V at D, the
# score tile at BKV + 1
@pytest.mark.parametrize("D, rows, smem", [
    (32, 64, 4 * (64 * 36 + 32 * 36 + 32 * 32 + 64 * 33)),
    (64, 64, 4 * (64 * 68 + 32 * 68 + 32 * 64 + 64 * 33)),
    (128, 64, 4 * (64 * 132 + 32 * 132 + 32 * 128 + 64 * 33)),
    (256, 32, 4 * (32 * 260 + 32 * 260 + 32 * 256 + 32 * 33))])
def test_tile_plan_f32_is_the_cuda_core_kernel(D, rows, smem):
    p = tile_plan(2, 8, 77, D, 132, dtype="float32")
    assert p.kernel_numbers() == (0, rows, 32, 1, smem)
    assert p.blocks == -(-77 // rows) * 8 * 2


def test_every_tile_plan_fits_shared_memory():
    for dtype in ("bfloat16", "float32"):
        for D in (32, 64, 128, 256):
            for B, H, S in ((1, 1, 1), (1, 32, 1000), (8, 64, 4096),
                            (1, 12, 77), (64, 32, 2048)):
                for sms in (1, 78, 132):
                    p = tile_plan(B, H, S, D, sms, dtype=dtype)
                    assert p.smem_bytes <= SMEM_PER_BLOCK
                    assert p.stages >= (2 if dtype == "bfloat16" else 1)


def test_tile_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        tile_plan(1, 8, 100, 96, 132)
    with pytest.raises(ValueError, match="dtype"):
        tile_plan(1, 8, 100, 64, 132, dtype="float16")
    with pytest.raises(ValueError):
        tile_plan(1, 8, 0, 64, 132)
