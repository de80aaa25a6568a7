"""Model zoo dispatcher: ArchConfig -> model, counterpart of ``repro.models.zoo``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import DenseLM, EncoderLM
from repro_torch.models.vision import VisionLM

_FAMILIES = {"dense": DenseLM, "moe": DenseLM, "ssm": RWKVLM,
             "hybrid": HymbaLM, "encoder": EncoderLM, "vlm": VisionLM,
             "audio": EncDecLM}


def build_model(cfg: ArchConfig, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device, dtype=dtype)
