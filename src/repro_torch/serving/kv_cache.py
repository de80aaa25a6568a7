"""Slot KV cache of the serving engine (PyTorch), counterpart of
``repro.serving.kv_cache.SlotKVCache``.

The tensors live on the engine's device and are updated in place.  Only
what the engine uses is kept (the prefix copy); the paged cache of the
reference is not on the engine's path and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SlotKVCache:
    """Contiguous (L, slots, KV, Smax, D) cache with per-slot lengths."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: np.ndarray  # host-side (slots,) int32

    def copy_prefix(self, src_slot: int, dst_slot: int, length: int) -> None:
        """Prefix-cache hit: duplicate the first ``length`` tokens."""
        self.k[:, dst_slot, :, :length] = self.k[:, src_slot, :, :length]
        self.v[:, dst_slot, :, :length] = self.v[:, src_slot, :, :length]
        self.lengths[dst_slot] = length
