"""qwen2.5-3b — dense, GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
