"""Registry of the architectures the port serves (``--arch <id>``).

The port registers every architecture of the reference registry: the dense
decoders, the MoE decoders olmoe-1b-7b and granite-moe-3b-a800m, rwkv6-7b,
the hybrid hymba-1.5b, the cross-attention decoders llama-3.2-vision-11b
and seamless-m4t-large-v2, and the two encoders of rag_reranker.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as LLAMA_VISION
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
from repro_torch.configs.paper_workloads import PAPER_LLMS
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.qwen2_7b import CONFIG as QWEN2_7B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as SEAMLESS

ASSIGNED: Dict[str, ArchConfig] = {
    c.name: c for c in (GEMMA_7B, GLM4_9B, QWEN2_7B, QWEN2_5_3B, GRANITE_MOE,
                        OLMOE, LLAMA_VISION, SEAMLESS, HYMBA, RWKV6)
}

REGISTRY: Dict[str, ArchConfig] = {**ASSIGNED, **PAPER_LLMS}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced_config(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
                   vocab: int = 256) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps family, activation, attention ratios and MoE/SSM structure;
    shrinks width, depth and embedding tables (same rules as the
    reference's ``reduced_config``).
    """
    heads = max(2, min(cfg.num_heads, 4))
    ratio = (max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
             if not cfg.attn_free else 1)
    kv = max(1, heads // min(ratio, heads))
    head_dim = max(8, d_model // heads)
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=heads if cfg.attn_free else kv,
        head_dim=head_dim,
        d_ff=d_model * 2 if not cfg.is_moe else 32,
        vocab_size=vocab,
    )
    if cfg.is_moe:
        updates["num_experts"] = min(cfg.num_experts, 8)
        updates["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.cross_attn_every:
        updates["cross_attn_every"] = 2
        updates["num_image_tokens"] = 16
        updates["vision_d_model"] = 32
    if cfg.encoder_layers:
        updates["encoder_layers"] = layers
        updates["num_audio_frames"] = 16
    if cfg.sliding_window:
        updates["sliding_window"] = 8
        updates["full_attn_layers"] = (0,)
    if cfg.ssm_state:
        updates["ssm_state"] = 4 if not cfg.attn_free else head_dim
    return dataclasses.replace(cfg, **updates)
