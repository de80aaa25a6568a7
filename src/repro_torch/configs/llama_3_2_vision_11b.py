"""llama-3.2-vision-11b — decoder backbone w/ cross-attention image layers.

Modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings; only the transformer backbone is modeled.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
    cross_attn_every=5,  # a cross-attn layer after every 5th self-attn layer
    num_image_tokens=1601,  # 1 tile of 448x448 @ patch 14 + cls
    vision_d_model=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
