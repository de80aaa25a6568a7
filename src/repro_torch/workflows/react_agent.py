"""ReAct-style tool-agent loop workload.

An agent LLM alternates thought/action steps with external tool calls
(search, code execution, ...), feeding each observation back into its
growing context; a small summarizer LLM compresses long tool outputs
before they enter the context.  Execution is data-dependent: the number
of loop iterations, the tool latencies, and the observation lengths are
all drawn per request.  Every agent step extends the agent's own prior
context — the dominant prefix-cache pattern of tool agents.
"""
from __future__ import annotations

import random

from repro_torch.configs.paper_workloads import LLAMA_3_2_1B, QWEN_2_5_3B_AGENT
from repro_torch.workflows.runtime import Call, Tool, Workflow

MAX_STEPS = 12
SUMMARIZE_THRESHOLD = 300  # tool outputs longer than this get compressed


def react_agent_program(rng: random.Random):
    context = 120 + int(rng.lognormvariate(5.0, 0.5))  # task + tool schemas
    steps = min(2 + int(rng.expovariate(1 / 3.0)), MAX_STEPS)
    agent_handle = None

    for _ in range(steps):
        # think + act: the agent emits a thought and a tool invocation,
        # continuing its own transcript (prefix hit on all prior turns)
        action_tokens = 30 + int(rng.expovariate(1 / 40.0))
        (act,) = yield [Call("agent", context, action_tokens,
                             parent=agent_handle)]
        agent_handle = act.handle
        context += action_tokens

        # external tool execution (search / code / API round-trip)
        yield Tool(0.01 + rng.expovariate(1 / 0.05))

        # observation: long tool outputs are compressed by the summarizer
        obs = int(rng.expovariate(1 / 250.0)) + 20
        if obs > SUMMARIZE_THRESHOLD:
            summary_tokens = 40 + int(rng.expovariate(1 / 40.0))
            yield [Call("summ", obs, summary_tokens)]
            obs = summary_tokens
        context += obs

    # final answer over the full trajectory
    yield [Call("agent", context, 80 + int(rng.expovariate(1 / 80.0)),
                parent=agent_handle)]


REACT_AGENT = Workflow(
    name="react_agent",
    program=react_agent_program,
    llms={"agent": QWEN_2_5_3B_AGENT, "summ": LLAMA_3_2_1B},
)
