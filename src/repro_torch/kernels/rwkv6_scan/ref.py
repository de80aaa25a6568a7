"""Plain PyTorch version of the WKV6 scan kernel."""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token WKV6 recurrence in f32, for any S >= 1.

    r/k/v/logw: (B, H, S, D); u: (H, D); state: (B, H, D, D) (k-dim x
    v-dim).  Per token t:

        o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
        S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t

    Returns (out (B, H, S, D) in r's dtype, final state (B, H, D, D) f32).
    """
    r32, k32, v32 = r.float(), k.float(), v.float()
    decay = torch.exp(logw.float())
    s = state.float().clone()
    bonus = (r32 * u.float()[None, :, None, :] * k32).sum(-1, keepdim=True)
    outs = []
    for t in range(r.shape[2]):
        outs.append(torch.einsum("bhk,bhkv->bhv", r32[:, :, t], s))
        s = (s * decay[:, :, t, :, None]
             + k32[:, :, t, :, None] * v32[:, :, t, None, :])
    out = torch.stack(outs, dim=2) + bonus * v32
    return out.to(r.dtype), s
