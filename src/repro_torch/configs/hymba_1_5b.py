"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer.

Sliding-window attention on most layers; 3 global-attention layers
(first/middle/last) per the Hymba paper — which is what makes long_500k
decode feasible (SWA KV is bounded; SSM state is O(1)).
[arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    activation="swiglu",
    ssm_state=16,
    sliding_window=1024,
    full_attn_layers=(0, 15, 31),
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
)
