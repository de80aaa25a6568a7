"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend STUB).

``input_specs()`` supplies precomputed frame embeddings for the encoder;
the enc-dec transformer backbone is what we model. [arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    activation="gelu",
    num_audio_frames=1024,  # precomputed speech-frontend frames per request
    rope_theta=10_000.0,
    source="arXiv:2308.11596; hf",
)
