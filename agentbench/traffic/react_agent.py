"""ReAct tool agent, frozen from the workflow of the same name.

A session starts from a task context; each step the agent reads its whole
transcript and writes an action, a tool runs, and its observation joins
the transcript (an observation over ``summarize_over`` tokens is first
summarised by a call of its own, and the summary joins instead).  The
final answer reads the whole transcript.  Each agent prompt is the
previous agent prompt, then the tokens that call served, then the new
observation's tokens: what a real agent re-sends, and what a prefix cache
can reuse.
"""
from __future__ import annotations

import numpy as np

from agentbench.traffic import Send, Tool, draw, idraw


def program(p: dict, rng, tokens):
    context = tokens(idraw(p["context_tokens"], rng))
    steps = min(idraw(p["steps"], rng), p["max_steps"])
    for _ in range(steps):
        (action,) = yield [Send(context, idraw(p["action_out"], rng))]
        context = np.concatenate([context, np.asarray(action, np.int64)])
        yield Tool(draw(p["tool_s"], rng))
        obs = idraw(p["observation_tokens"], rng)
        if obs > p["summarize_over"]:
            (summary,) = yield [Send(tokens(obs), idraw(p["summary_out"], rng))]
            observation = np.asarray(summary, np.int64)
        else:
            observation = tokens(obs)
        context = np.concatenate([context, observation])
    yield [Send(context, idraw(p["answer_out"], rng))]
