"""Workflow registry: every servable workload by name.

The fleet scheduler (:func:`repro_torch.core.scheduler.schedule_multi`) and the
benchmarks look workloads up here, so adding a scenario is one module +
one entry.

Each registered workflow carries a default SLO class
(:mod:`repro_torch.qos.slo`): interactive agent loops are gold (tight latency
target, never shed), throughput-oriented pipelines are silver (degrade
under overload), batch-style search/debate workloads are bronze (reject
under overload).  Targets are relative (a multiple of the workflow's
unloaded latency) and get resolved against traced stats at deploy time;
callers that want different tiers pass ``slos=`` to ``deploy_multi`` or
re-wrap with :func:`repro_torch.workflows.runtime.with_slo`.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.qos.slo import BRONZE, GOLD, SILVER, SLOClass
from repro_torch.workflows.beam_search import BEAM_SEARCH
from repro_torch.workflows.debate import DEBATE
from repro_torch.workflows.map_reduce import MAP_REDUCE
from repro_torch.workflows.rag_reranker import RAG_RERANKER
from repro_torch.workflows.react_agent import REACT_AGENT
from repro_torch.workflows.runtime import Workflow, with_slo
from repro_torch.workflows.session import RECURSIVE_AGENT, SESSION_CHAT

DEFAULT_SLOS: Dict[str, SLOClass] = {
    "react_agent": GOLD,  # interactive tool agent: a user is waiting
    "rag_reranker": GOLD,  # interactive retrieval front-end
    "session_chat": GOLD,  # live conversation: a user is typing back
    "map_reduce": SILVER,  # throughput pipeline: degrade before reject
    "beam_search": SILVER,
    "recursive_agent": SILVER,  # background task decomposition
    "debate": BRONZE,  # batch-style deliberation: sheddable
}

# a workflow without a DEFAULT_SLOS entry registers unclassified
# (best-effort, no admission control) rather than failing at import
WORKFLOWS: Dict[str, Workflow] = {
    wf.name: (with_slo(wf, DEFAULT_SLOS[wf.name])
              if wf.name in DEFAULT_SLOS else wf)
    for wf in (BEAM_SEARCH, RAG_RERANKER, REACT_AGENT, MAP_REDUCE, DEBATE,
               SESSION_CHAT, RECURSIVE_AGENT)
}


def get_workflow(name: str) -> Workflow:
    if name not in WORKFLOWS:
        raise KeyError(f"unknown workflow {name!r}; known: {sorted(WORKFLOWS)}")
    return WORKFLOWS[name]


def workflow_names() -> List[str]:
    return sorted(WORKFLOWS)
