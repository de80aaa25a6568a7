"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KV, S, D). Causal softmax attention.

    Computed in f32; the output is in q's dtype.
    """
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, S, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)
