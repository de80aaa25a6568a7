"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, GQA kv=8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,  # per-expert
    vocab_size=49_155,
    activation="swiglu",
    num_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
