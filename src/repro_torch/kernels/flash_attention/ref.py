"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D).  Softmax attention, causal
    (Sq == Sk, optionally within a sliding window) or, with
    ``causal=False``, every query over all Sk keys with no mask.

    Computed in f32; the output is in q's dtype.
    """
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and {Sk}")
    if not causal and window > 0:
        raise ValueError("a sliding window needs causal attention")
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, Sq, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        pos = torch.arange(Sq, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window > 0:
            mask &= pos[None, :] > pos[:, None] - window
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)
