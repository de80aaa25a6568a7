"""Execution traces of agentic workflows (paper §4 step 1).

Scepsy is framework-agnostic: it never sees the workflow program, only the
LLM-level requests captured by a proxy in front of each engine's
completions API.  Here the proxy is :class:`TracingProxy`, which the
workflow runtime routes every LLM call through; each call records request
content sizes, start/end timestamps and the workflow-request id — exactly
the telemetry the paper's HTTP proxy captures.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List


@dataclass
class LLMCall:
    workflow_request: int
    llm: str
    t_start: float
    t_end: float
    prompt_tokens: int
    output_tokens: int
    cached_prefix_tokens: int = 0

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclass
class WorkflowTrace:
    """All LLM-level calls of one workflow-level request."""

    request_id: int
    workflow: str
    t_start: float
    t_end: float
    calls: List[LLMCall] = field(default_factory=list)

    @property
    def latency(self) -> float:
        return self.t_end - self.t_start

    def calls_for(self, llm: str) -> List[LLMCall]:
        return [c for c in self.calls if c.llm == llm]

    def llms(self) -> List[str]:
        seen: Dict[str, None] = {}
        for c in self.calls:
            seen.setdefault(c.llm, None)
        return list(seen)


@dataclass
class TraceStore:
    workflow: str
    traces: List[WorkflowTrace] = field(default_factory=list)

    def llms(self) -> List[str]:
        seen: Dict[str, None] = {}
        for t in self.traces:
            for name in t.llms():
                seen.setdefault(name, None)
        return list(seen)

    def all_calls(self, llm: str) -> List[LLMCall]:
        return [c for t in self.traces for c in t.calls if c.llm == llm]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"workflow": self.workflow,
                       "traces": [asdict(t) for t in self.traces]}, f)

    @classmethod
    def load(cls, path: str) -> "TraceStore":
        with open(path) as f:
            raw = json.load(f)
        traces = []
        for t in raw["traces"]:
            calls = [LLMCall(**c) for c in t.pop("calls")]
            traces.append(WorkflowTrace(calls=calls, **t))
        return cls(workflow=raw["workflow"], traces=traces)


class TracingProxy:
    """Engine-front proxy: records every LLM-level request.

    The workflow runtime calls :meth:`record` with simulated-clock
    timestamps; the proxy neither sees nor needs the workflow definition
    (unrestricted programming model, Tab. 1).
    """

    def __init__(self, workflow: str):
        self.store = TraceStore(workflow=workflow)
        self._open: Dict[int, WorkflowTrace] = {}

    def begin_request(self, request_id: int, t: float) -> None:
        self._open[request_id] = WorkflowTrace(
            request_id=request_id, workflow=self.store.workflow,
            t_start=t, t_end=t)

    def record(self, call: LLMCall) -> None:
        tr = self._open[call.workflow_request]
        tr.calls.append(call)
        tr.t_end = max(tr.t_end, call.t_end)

    def end_request(self, request_id: int, t: float) -> None:
        tr = self._open.pop(request_id)
        tr.t_end = max(tr.t_end, t)
        self.store.traces.append(tr)
