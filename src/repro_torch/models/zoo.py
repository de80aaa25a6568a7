"""Model zoo dispatcher: ArchConfig -> model, counterpart of ``repro.models.zoo``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import DenseLM, EncoderLM

# family -> the ROADMAP.md queue-A item that ports it
_LATER = {
    "vlm": "A11 (models/vision.py)",
    "audio": "A11 (models/encdec.py)",
}


def build_model(cfg: ArchConfig, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    if cfg.family in ("dense", "moe"):
        return DenseLM(cfg, device=device, dtype=dtype)
    if cfg.family == "ssm":
        return RWKVLM(cfg, device=device, dtype=dtype)
    if cfg.family == "hybrid":
        return HymbaLM(cfg, device=device, dtype=dtype)
    if cfg.family == "encoder":
        return EncoderLM(cfg, device=device, dtype=dtype)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md item {_LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
