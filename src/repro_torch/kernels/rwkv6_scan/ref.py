"""Plain PyTorch versions of the WKV6 kernels.

``wkv6_scan_ref`` is the token-by-token recurrence: the plain version of
both kernels, which the wrapper runs on the CPU and ``chip_smoke.py``
holds them to on the card.  ``wkv6_chunk_ref`` computes the same function
through the chunked kernel's own factorisation, in f32; the tests hold
its arithmetic to the recurrence and to the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634
CHUNK = 64  # tokens per chunk of the chunked kernel
SUB = 16    # tokens per sub-chunk: the mma tile's rows


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


def wkv6_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   *, chunk: int = CHUNK, sub: int = SUB
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence as ``csrc/wkv6_chunk.cu`` factors it, in f32.

    Same arguments and result as ``wkv6_scan_ref``, for any S >= 1.  The
    sequence is cut into chunks of ``chunk`` tokens, the last padded with
    r = k = v = 0 and logw = 0 (no decay), so the state at S is exact.  In
    a chunk, with ``cum`` the inclusive prefix sum of logw (in log2 units)
    and ``excl[t] = cum[t - 1]`` (0 at t = 0):

    * inter-chunk: ``o = (r * 2^excl) S0``;
    * intra-chunk, in sub-chunks of ``sub`` tokens: on the diagonal,
      ``A[t, s] = sum_c r[t,c] k[s,c] 2^(excl[t,c] - cum[s,c])`` for s < t;
      below it, through the boundary ``Bi = cum`` at the last token of
      sub-chunk i - 1, ``A_ij = (r_i 2^(excl_i - Bi)) (k_j 2^(Bi - cum_j))^T``;
      then ``o += A v + (r . (u * k)) v``;
    * state: ``S = diag(2^cum_last) S0 + (k 2^(cum_last - cum))^T v``.

    Every exponent is <= 0 (cum does not increase, in floating point too),
    and nothing is divided by a decay.
    """
    B, H, S, D = r.shape
    n = -(-S // chunk)
    pad = (0, 0, 0, n * chunk - S)
    r32, k32, v32 = (F.pad(x.float(), pad) for x in (r, k, v))
    lw2 = F.pad(logw.float(), pad) * LOG2E
    s = state.float().clone()
    bonus = (r32 * u.float()[None, :, None, :] * k32).sum(-1, keepdim=True)
    idx = torch.arange(sub, device=r.device)
    below = (idx[:, None] > idx[None, :])[:, :, None]  # s < t
    outs = []
    for c0 in range(0, n * chunk, chunk):
        rc, kc, vc = (x[:, :, c0:c0 + chunk] for x in (r32, k32, v32))
        cum = torch.cumsum(lw2[:, :, c0:c0 + chunk], dim=2)
        excl = F.pad(cum[:, :, :-1], (0, 0, 1, 0))
        last = cum[:, :, -1:]
        o = (rc * torch.exp2(excl)) @ s
        A = rc.new_zeros(B, H, chunk, chunk)
        for i in range(0, chunk, sub):
            ti = slice(i, i + sub)
            diff = excl[:, :, ti, None, :] - cum[:, :, None, ti, :]
            dec = torch.exp2(torch.where(below, diff, float("-inf")))
            A[:, :, ti, ti] = torch.einsum("bhtc,bhsc,bhtsc->bhts",
                                           rc[:, :, ti], kc[:, :, ti], dec)
            if i:
                bnd = cum[:, :, i - 1:i]
                rq = rc[:, :, ti] * torch.exp2(excl[:, :, ti] - bnd)
                kq = kc[:, :, :i] * torch.exp2(bnd - cum[:, :, :i])
                A[:, :, ti, :i] = rq @ kq.transpose(-1, -2)
        outs.append(o + A @ vc + bonus[:, :, c0:c0 + chunk] * vc)
        kdec = kc * torch.exp2(last - cum)
        s = s * torch.exp2(last).transpose(-1, -2) + kdec.transpose(-1, -2) @ vc
    out = torch.cat(outs, dim=2)[:, :, :S]
    return out.to(r.dtype), s
