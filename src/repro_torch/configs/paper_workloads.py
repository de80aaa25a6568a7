"""Workload LLMs of the paper (§7.1) and the agentic fleet.

RAG+reranker: e5-base-v2 (embedder) + a MiniLM cross-encoder (reranker) +
Llama-3-8B (generator).  Beam search: Llama-3.2-1B (generator) +
Llama-3.1-8B-PRM (verifier).  Fleet workloads (ReAct agent / map-reduce /
debate) use a mid-size Qwen2.5-3B-shaped agent model.  The port serves all
of them: the decoders through ``DenseLM``, the two encoders through
``EncoderLM``.
"""
from repro_torch.configs.base import ArchConfig

LLAMA_3_2_1B = ArchConfig(
    name="llama-3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

LLAMA_3_1_8B = ArchConfig(
    name="llama-3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
    substitute="qwen2.5-3b-agent",  # quality tier below (JIT substitution)
    source="hf:meta-llama/Llama-3.1-8B",
)

# Verifier / process-reward model: same backbone as 8B (PRM head is tiny).
LLAMA_3_1_8B_PRM = ArchConfig(
    name="llama-3.1-8b-prm",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
    source="hf:RLHFlow/Llama3.1-8B-PRM-Mistral-Data",
)

# Embedder (encoder-only, BERT-base shape).
E5_BASE_V2 = ArchConfig(
    name="e5-base-v2",
    family="encoder",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=30_522,
    activation="gelu",
    source="hf:intfloat/e5-base-v2",
)

# Cross-encoder reranker (MiniLM shape).
RERANKER_MINILM = ArchConfig(
    name="reranker-minilm",
    family="encoder",
    num_layers=6,
    d_model=384,
    num_heads=12,
    num_kv_heads=12,
    d_ff=1536,
    vocab_size=30_522,
    activation="gelu",
    source="hf:cross-encoder/ms-marco-MiniLM-L-6-v2",
)

# Mid-size tool-calling agent (Qwen2.5-3B shape) for the agentic-fleet
# workloads — sits between the 1B drafters and the 8B generators so the
# scheduler has three distinct model sizes to pack.
QWEN_2_5_3B_AGENT = ArchConfig(
    name="qwen2.5-3b-agent",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    activation="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    substitute="llama-3.2-1b",  # quality tier below (JIT substitution)
    source="hf:Qwen/Qwen2.5-3B-Instruct",
)

PAPER_LLMS = {
    c.name: c
    for c in (LLAMA_3_2_1B, LLAMA_3_1_8B, LLAMA_3_1_8B_PRM, E5_BASE_V2,
              RERANKER_MINILM, QWEN_2_5_3B_AGENT)
}
