"""glm4-9b — dense, RoPE, extreme GQA (kv=2). [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151_552,
    activation="swiglu",
    rope_theta=10_000.0,
    substitute="qwen2-7b",  # quality tier below (JIT substitution)
    source="hf:THUDM/glm-4-9b; hf",
)
