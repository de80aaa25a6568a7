"""Stateful multi-turn session workloads.

The registry's original fleet is memoryless: every workflow request is
one shot and its calls share prefixes only *within* the request.  Real
agentic traffic is dominated by *sessions* — a user holds a conversation
whose context grows turn over turn, which is exactly the access pattern
the radix/affinity serving path (PR 6) is built for.  Both workloads
here model a session as ONE workflow-level request spanning several
turns: each assistant call extends the previous turn's transcript via
``parent=`` handles (process-unique, so pooled replicas key prefix reuse
correctly), turns are separated by :class:`Tool` think-time gaps, and
the driver's ``Router.forget()`` prunes sticky state when the session
generator finally returns.

``session_chat`` is a plain chat session (linear transcript growth);
``recursive_agent`` is a recursive tool-use agent that decomposes tasks
into subtasks with data-dependent depth and branching — its prefix tree
branches where the plan does, the DAG shape the aggregate abstraction
claims to absorb without inspecting.
"""
from __future__ import annotations

import random

from repro_torch.configs.paper_workloads import LLAMA_3_2_1B, QWEN_2_5_3B_AGENT
from repro_torch.workflows.runtime import Call, Tool, Workflow

MAX_TURNS = 10  # chat session length cap
MAX_DEPTH = 3  # recursion cap for the task-decomposition agent
SUMMARIZE_THRESHOLD = 200  # leaf tool outputs longer than this compress


def session_chat_program(rng: random.Random):
    # system prompt + user profile, resent (cached) on every turn
    context = 80 + int(rng.lognormvariate(4.5, 0.4))
    turns = min(2 + int(rng.expovariate(1 / 3.0)), MAX_TURNS)
    last = None

    for turn in range(turns):
        user = 15 + int(rng.expovariate(1 / 35.0))
        context += user
        reply = 40 + int(rng.expovariate(1 / 90.0))
        (res,) = yield [Call("chat", context, reply, parent=last)]
        last = res.handle
        context += reply
        if turn + 1 < turns:
            # user reads the reply and types the next message
            yield Tool(0.2 + rng.expovariate(1 / 1.0))


def _solve(rng: random.Random, context: int, parent, depth: int):
    """One task node, driven via ``yield from``: plan, recurse or
    execute, then synthesize — every call continuing the node's own
    transcript.  Returns ``(handle, context)`` for the caller to chain."""
    plan_tokens = 25 + int(rng.expovariate(1 / 30.0))
    (plan,) = yield [Call("agent", context, plan_tokens, parent=parent)]
    context += plan_tokens
    last = plan.handle

    branch_p = 0.5 if depth == 0 else 0.25
    if depth < MAX_DEPTH and rng.random() < branch_p:
        subtasks = 1 + (rng.random() < 0.4)
        for _ in range(subtasks):
            last, context = yield from _solve(rng, context, last, depth + 1)
    else:
        # leaf: run the tool and fold its (possibly summarized) output in
        yield Tool(0.01 + rng.expovariate(1 / 0.04))
        obs = 20 + int(rng.expovariate(1 / 150.0))
        if obs > SUMMARIZE_THRESHOLD:
            summary = 30 + int(rng.expovariate(1 / 30.0))
            yield [Call("summ", obs, summary)]
            obs = summary
        context += obs

    synth_tokens = 30 + int(rng.expovariate(1 / 50.0))
    (res,) = yield [Call("agent", context, synth_tokens, parent=last)]
    return res.handle, context + synth_tokens


def recursive_agent_program(rng: random.Random):
    context = 100 + int(rng.lognormvariate(4.8, 0.5))  # task statement
    yield from _solve(rng, context, None, 0)


SESSION_CHAT = Workflow(
    name="session_chat",
    program=session_chat_program,
    llms={"chat": QWEN_2_5_3B_AGENT},
)

RECURSIVE_AGENT = Workflow(
    name="recursive_agent",
    program=recursive_agent_program,
    llms={"agent": QWEN_2_5_3B_AGENT, "summ": LLAMA_3_2_1B},
)
