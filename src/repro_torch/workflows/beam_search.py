"""Beam-search workflow (paper Fig. 1 / §7 workload).

A generator LLM (GEN) expands candidate reasoning steps; a verifier LLM
(VER) scores them; the top beams survive.  Execution is data-dependent:
the number of rounds and the per-step token counts are drawn per request
(the paper's trace spans 24–844 GEN invocations and 9–264 s latency).
Beam expansions share their parent's prefix — the prefix-cache hit that
the Aegaeon baseline lacks.
"""
from __future__ import annotations

import random

from repro_torch.configs.paper_workloads import LLAMA_3_1_8B_PRM, LLAMA_3_2_1B
from repro_torch.workflows.runtime import Call, Tool, Workflow

BEAM_WIDTH = 4
EXPANSIONS_PER_BEAM = 2


def beam_search_program(rng: random.Random):
    prompt = int(rng.lognormvariate(5.5, 0.4))  # ~250 token question
    rounds = min(3 + int(rng.expovariate(1 / 10.0)), 50)
    context = prompt
    beam_handles = [None] * BEAM_WIDTH  # gen-side prefix lineage
    ver_handles = [None] * BEAM_WIDTH  # ver-side prefix lineage (the
    # verifier's KV prefix is its *own* previous scoring of this beam)

    for _ in range(rounds):
        # expand: GEN continues each beam (children share the beam prefix)
        expansions = []
        parents = []
        for b in range(BEAM_WIDTH):
            for _ in range(EXPANSIONS_PER_BEAM):
                step = 20 + int(rng.expovariate(1 / 40.0))
                expansions.append(Call("gen", context, step,
                                       parent=beam_handles[b]))
                parents.append(b)
        gen_results = yield expansions

        # verify: VER scores each expansion, extending its own prior
        # scoring context for that beam (radix-cache hit)
        step_ctx = context + 40
        ver_calls = [Call("ver", step_ctx, 2, parent=ver_handles[parents[i]])
                     for i, _ in enumerate(gen_results)]
        ver_results = yield ver_calls

        # non-LLM: select top beams
        yield Tool(0.002)
        order = list(range(len(gen_results)))
        rng.shuffle(order)
        keep = order[:BEAM_WIDTH]
        beam_handles = [gen_results[i].handle for i in keep]
        ver_handles = [ver_results[i].handle for i in keep]
        context += 40

    # final answer from the best beam
    yield [Call("gen", context, 100 + int(rng.expovariate(1 / 80.0)),
                parent=beam_handles[0])]


BEAM_SEARCH = Workflow(
    name="beam_search",
    program=beam_search_program,
    llms={"gen": LLAMA_3_2_1B, "ver": LLAMA_3_1_8B_PRM},
)
