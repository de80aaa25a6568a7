"""olmoe-1b-7b — MoE, 64 experts top-8, MHA kv=16. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,  # per-expert
    vocab_size=50_304,
    activation="swiglu",
    num_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
    source="arXiv:2409.02060; hf",
)
