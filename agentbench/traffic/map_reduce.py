"""Map-reduce summarisation, frozen from the workflow of the same name.

A document of lognormal length is cut into chunks; every chunk is
summarised by one call, all sent as one group (the fan-out); the partial
summaries are then folded in groups of ``reduce_fanout`` until one is
left, the last fold writing the final summary.  Every prompt is fresh
tokens: the calls share no prefix.
"""
from __future__ import annotations

import math

from agentbench.traffic import Send, Tool, draw, idraw


def program(p: dict, rng, tokens):
    doc = idraw(p["doc_tokens"], rng)
    chunks = min(max(math.ceil(doc / p["chunk_tokens"]), p["min_chunks"]),
                 p["max_chunks"])
    yield Tool(draw(p["dispatch_s"], rng))
    # the sizes of every call first, so that they never depend on the
    # tokens served
    maps = [(p["chunk_tokens"] + idraw(p["chunk_extra"], rng), idraw(p["map_out"], rng))
            for _ in range(chunks)]
    partials = yield [Send(tokens(n), out) for n, out in maps]
    width = len(partials)
    fan = p["reduce_fanout"]
    while width > 1:
        groups = math.ceil(width / fan)
        out = p["partial_tokens"] if groups > 1 else idraw(p["root_out"], rng)
        calls = [Send(tokens(min(width - g * fan, fan) * p["partial_tokens"]
                             + p["reduce_extra"]), out) for g in range(groups)]
        yield calls
        width = groups
