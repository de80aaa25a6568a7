"""Plain PyTorch version of the decode attention kernel."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths, *,
                         return_lse: bool = False):
    """q: (B, KV, G, D); caches: (B, KV, Smax, D); lengths: scalar or (B,).

    Position s of row b is valid when s < lengths[b].  A row with no valid
    position returns zeros.  Computed in f32; the output is in q's dtype.
    With ``return_lse`` it returns (out in f32, lse (B, KV, G) f32): the
    log-sum-exp of each query's scaled scores over its valid positions,
    in natural-log units, -inf for a row with none.
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
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out.to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths,
                               chunk: int, *, return_lse: bool = False):
    """The split-K kernel pair's arithmetic, step by step in f32.

    Same arguments and result as ``decode_attention_ref``.  Positions
    [s*chunk, (s+1)*chunk) of each row form partial s: its running max m
    (in log2 units), sum l and unnormalised output O.  The merge takes the
    ceil(len/chunk) partials of the row and returns
    sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s, M = max_s m_s; a row
    with no partial returns zeros.  With ``return_lse`` the merge also
    gives (M + log2 L) ln 2, L = sum_s 2^(m_s - M) l_s, as the kernel's
    merge writes it.  Only tests use it.
    """
    B, KV, G, D = q.shape
    Smax = k_cache.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
    lengths = lengths.clamp(0, Smax)
    splits = max(1, -(-Smax // chunk))
    pos = torch.arange(splits * chunk, device=q.device).reshape(splits, chunk)
    k = torch.nn.functional.pad(k_cache.float(),
                                (0, 0, 0, splits * chunk - Smax))
    v = torch.nn.functional.pad(v_cache.float(),
                                (0, 0, 0, splits * chunk - Smax))
    k = k.reshape(B, KV, splits, chunk, D)
    v = v.reshape(B, KV, splits, chunk, D)
    s = torch.einsum("bkgd,bkscd->bkgsc", q.float(), k) * scale_log2
    valid = pos[None] < lengths[:, None, None]  # (B, splits, chunk)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1)  # (B, KV, G, splits); -inf for an empty partial
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgsc,bkscd->bkgsd", p, v)
    used = pos[:, 0][None] < lengths[:, None]  # (B, splits)
    m = m.masked_fill(~used[:, None, None], float("-inf"))
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.exp2(m - torch.where(torch.isfinite(mx), mx, 0.0))
    w = w.masked_fill(~used[:, None, None], 0.0)
    num = (w[..., None] * o).sum(dim=-2)
    den = (w * l).sum(dim=-1, keepdim=True)
    out = num / torch.where(den > 0, den, torch.ones_like(den))
    if return_lse:
        return out, ((mx + torch.log2(den)) * math.log(2.0))[..., 0]
    return out.to(q.dtype)
