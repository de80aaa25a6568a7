"""qwen2-7b — dense, GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    substitute="qwen2.5-3b",  # quality tier below (JIT substitution)
    source="arXiv:2407.10671; hf",
)
