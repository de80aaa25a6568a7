"""Map-reduce summarization fan-out workload.

A long document is chunked; a small mapper LLM summarizes every chunk in
parallel (the fan-out — high request-level parallelism p_m), then an 8B
reducer folds the partial summaries hierarchically (fan-in trees of
``REDUCE_FANOUT``) down to one final summary.  The fan-out width is
data-dependent (drawn from the document length), so n_map varies per
request while the map/reduce execution-share stays stable — the paper's
§2.4 observation in a workload whose structure is width- rather than
depth-dependent.
"""
from __future__ import annotations

import math
import random

from repro_torch.configs.paper_workloads import LLAMA_3_1_8B, LLAMA_3_2_1B
from repro_torch.workflows.runtime import Call, Tool, Workflow

CHUNK_TOKENS = 800
MAX_CHUNKS = 24
REDUCE_FANOUT = 4
PARTIAL_TOKENS = 90  # per-chunk summary length scale


def map_reduce_program(rng: random.Random):
    doc = int(rng.lognormvariate(8.3, 0.6))  # ~4k-token documents
    chunks = min(max(math.ceil(doc / CHUNK_TOKENS), 2), MAX_CHUNKS)

    # chunking / dispatch (non-LLM)
    yield Tool(0.002)

    # map: summarize all chunks in parallel
    map_calls = [Call("map", CHUNK_TOKENS + int(rng.expovariate(1 / 60.0)),
                      PARTIAL_TOKENS + int(rng.expovariate(1 / 30.0)))
                 for _ in range(chunks)]
    partials = yield map_calls

    # reduce: fold partial summaries in trees of REDUCE_FANOUT
    width = len(partials)
    while width > 1:
        groups = math.ceil(width / REDUCE_FANOUT)
        out_tokens = (PARTIAL_TOKENS if groups > 1
                      else 160 + int(rng.expovariate(1 / 60.0)))
        reduce_calls = [
            Call("reduce",
                 min(width - g * REDUCE_FANOUT, REDUCE_FANOUT)
                 * PARTIAL_TOKENS + 40,
                 out_tokens)
            for g in range(groups)
        ]
        yield reduce_calls
        width = groups


MAP_REDUCE = Workflow(
    name="map_reduce",
    program=map_reduce_program,
    llms={"map": LLAMA_3_2_1B, "reduce": LLAMA_3_1_8B},
)
