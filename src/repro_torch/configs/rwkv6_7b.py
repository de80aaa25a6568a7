"""rwkv6-7b "Finch" — attention-free, data-dependent decay linear recurrence.

Decode state is O(1) per layer (heads × head_dim × head_dim matrix-valued
WKV state + token-shift states).  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # head_size 64 => 4096/64 heads
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    activation="relu_sq",  # rwkv channel-mix uses squared relu
    ssm_state=64,
    attn_free=True,
    source="arXiv:2404.05892; hf",
)
