"""Multi-agent debate workload (K agents x R rounds).

K debater instances of one LLM argue for R rounds: each round every
agent speaks once, in parallel, conditioned on *all* agents' prior
statements.  An agent's prompt extends its own transcript (parent =
its previous statement, cross-round prefix reuse) while the other
agents' latest statements are newly appended — the cross-agent prefix
structure that distinguishes debate from independent sampling.  A final
judge LLM reads the whole debate and issues the verdict.  The round
count is data-dependent (hard questions debate longer).
"""
from __future__ import annotations

import random

from repro_torch.configs.paper_workloads import LLAMA_3_1_8B, LLAMA_3_2_1B
from repro_torch.workflows.runtime import Call, Tool, Workflow

NUM_AGENTS = 3
MAX_ROUNDS = 5
STATEMENT_TOKENS = 80  # statement length scale


def debate_program(rng: random.Random):
    question = 60 + int(rng.lognormvariate(5.0, 0.4))
    rounds = min(2 + int(rng.expovariate(1 / 1.5)), MAX_ROUNDS)
    handles = [None] * NUM_AGENTS  # per-agent own-transcript lineage
    context = question  # tokens visible to every agent this round
    statements = []  # per-round statement lengths (for the judge)

    for _ in range(rounds):
        lens = [STATEMENT_TOKENS // 2 + int(rng.expovariate(1 / 40.0))
                for _ in range(NUM_AGENTS)]
        results = yield [Call("debater", context, lens[a], parent=handles[a])
                         for a in range(NUM_AGENTS)]
        handles = [r.handle for r in results]
        statements.extend(lens)
        context += sum(lens)  # everyone sees everyone's new statements

    # non-LLM: collate transcripts for the judge
    yield Tool(0.002)
    yield [Call("judge", question + sum(statements),
                40 + int(rng.expovariate(1 / 40.0)))]


DEBATE = Workflow(
    name="debate",
    program=debate_program,
    llms={"debater": LLAMA_3_2_1B, "judge": LLAMA_3_1_8B},
)
