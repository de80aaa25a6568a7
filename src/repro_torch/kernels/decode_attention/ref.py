"""Plain PyTorch version of the decode attention kernel."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths) -> torch.Tensor:
    """q: (B, KV, G, D); caches: (B, KV, Smax, D); lengths: scalar or (B,).

    Position s of row b is valid when s < lengths[b].  A row with no valid
    position returns zeros.  Computed in f32; the output is in q's dtype.
    """
    B, KV, G, D = q.shape
    Smax = k_cache.shape[2]
    scale = 1.0 / math.sqrt(D)
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(),
                          k_cache.float()) * scale
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)
