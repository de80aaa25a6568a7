"""RAG + reranker workflow (paper §7 workload).

embed query -> retrieve (tool) -> rerank k docs in parallel (cross-encoder)
-> generate with top docs.  Heterogeneous LLMs: a tiny embedder, a tiny
reranker and an 8B generator — the case where fractional GPU allocation
matters most (§5's 1/13-GPU example).
"""
from __future__ import annotations

import random

from repro_torch.configs.paper_workloads import (E5_BASE_V2, LLAMA_3_1_8B,
                                           RERANKER_MINILM)
from repro_torch.workflows.runtime import Call, Tool, Workflow

RERANK_K = 8


def rag_reranker_program(rng: random.Random):
    query = 16 + int(rng.expovariate(1 / 30.0))
    # 1) embed the query
    yield [Call("emb", query, 1)]
    # 2) vector-store retrieval (non-LLM tool)
    yield Tool(0.004)
    # 3) rerank candidates in parallel
    doc_len = lambda: 120 + int(rng.expovariate(1 / 120.0))
    yield [Call("rer", query + doc_len(), 1) for _ in range(RERANK_K)]
    # 4) generate from the top documents
    ctx = query + 3 * 250
    out = 80 + int(rng.expovariate(1 / 120.0))
    yield [Call("gen", ctx, out)]


RAG_RERANKER = Workflow(
    name="rag_reranker",
    program=rag_reranker_program,
    llms={"emb": E5_BASE_V2, "rer": RERANKER_MINILM, "gen": LLAMA_3_1_8B},
)
