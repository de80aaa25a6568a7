"""Plain PyTorch versions of the WKV6 kernels.

``wkv6_scan_ref`` is the token-by-token recurrence: the plain version of
both forward kernels, which the wrapper runs on the CPU and
``chip_smoke.py`` holds them to on the card.  ``wkv6_chunk_ref`` computes
the same function through the chunked kernel's own factorisation, in f32;
the tests hold its arithmetic to the recurrence and to the JAX package.
``wkv6_bwd_ref`` is the plain version of the backward kernel
(``csrc/wkv6_bwd.cu``): the recurrence's gradients in the kernel's two
passes, token by token; the tests hold it to autograd of
``wkv6_scan_ref``.

The recurrence and the backward run in f32, or in f64 where their
inputs are f64 (the tests' exact checks); ``wkv6_chunk_ref`` in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634
CHUNK = 64  # tokens per chunk of the chunked kernel
SUB = 16    # tokens per sub-chunk: the mma tile's rows


def _acc(x: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in: f64 for f64 inputs, else f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token WKV6 recurrence in f32 (f64 for f64 inputs), for any
    S >= 1.

    r/k/v/logw: (B, H, S, D); u: (H, D); state: (B, H, D, D) (k-dim x
    v-dim).  Per token t:

        o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
        S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t

    Returns (out (B, H, S, D) in r's dtype, final state (B, H, D, D) in
    the dtype it is computed in).
    """
    acc = _acc(r)
    r32, k32, v32 = r.to(acc), k.to(acc), v.to(acc)
    decay = torch.exp(logw.to(acc))
    s = state.to(acc).clone()
    bonus = (r32 * u.to(acc)[None, :, None, :] * k32).sum(-1, keepdim=True)
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


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 dout: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``wkv6_scan_ref``'s output against ``dout`` (B, H, S,
    D), the final state's gradient taken as zero, in the backward kernel's
    two passes, token by token.  Same arguments as ``wkv6_scan_ref``.

    With S_t the state after token t (S_{-1} = ``state``), dS_t the
    gradient of the loss with respect to it (dS_{S-1} = 0) and
    c_t = v_t . dout_t:

    * forward pass, rebuilding S from ``state``:
      dr~_t = S_{t-1} dout_t^T and dr_t = dr~_t + u * k_t c_t;
    * backward pass, carrying dS: dk~_t = dS_t v_t^T,
      dk_t = dk~_t + r_t * u c_t, dv_t = k_t dS_t + (r_t . (u * k_t)) dout_t,
      then dS_{t-1} = diag(exp(logw_t)) dS_t + r_t^T dout_t;
    * dlogw_t = P_t - k_t * dk~_t with P_t = sum_{t' > t} (r_t' * dr~_t' -
      k_t' * dk~_t'), the same as exp(logw_t) * sum_j S_{t-1}[:, j]
      dS_t[:, j] but never needing S and dS at once, and never dividing by a
      decay.  P_t is sum_j S_t[:, j] dS_t[:, j], so the one reverse sum of
      the difference stays that small; the two sums taken apart would each
      grow with the sequence and cancel (at strong decays, to ~1e-3 of
      their size);
    * du = sum over rows and tokens of r_t * k_t c_t; dstate = dS_{-1}.

    Returns (dr, dk, dv) in r's dtype, then dlogw (B, H, S, D), du (H, D)
    and dstate (B, H, D, D), computed in f32 (f64 for f64 inputs) and
    returned in that dtype.
    """
    acc = _acc(r)
    r32, k32, v32, do = (x.to(acc) for x in (r, k, v, dout))
    u32 = u.to(acc)[None, :, :]
    decay = torch.exp(logw.to(acc))
    S = r.shape[2]
    c = (v32 * do).sum(-1)                                   # (B, H, S)
    s = state.to(acc).clone()
    drt = []
    for t in range(S):
        drt.append(torch.einsum("bhkv,bhv->bhk", s, do[:, :, t]))
        s = (s * decay[:, :, t, :, None]
             + k32[:, :, t, :, None] * v32[:, :, t, None, :])
    drt = torch.stack(drt, dim=2)
    ds = torch.zeros_like(s)
    dkt, dvs = [None] * S, [None] * S
    for t in reversed(range(S)):
        dkt[t] = torch.einsum("bhkv,bhv->bhk", ds, v32[:, :, t])
        dvs[t] = torch.einsum("bhk,bhkv->bhv", k32[:, :, t], ds)
        ds = (ds * decay[:, :, t, :, None]
              + r32[:, :, t, :, None] * do[:, :, t, None, :])
    dkt = torch.stack(dkt, dim=2)
    bonus = (r32 * u32[:, :, None] * k32).sum(-1, keepdim=True)
    dr = drt + u32[:, :, None] * k32 * c[..., None]
    dk = dkt + r32 * u32[:, :, None] * c[..., None]
    dv = torch.stack(dvs, dim=2) + bonus * do
    kdk = k32 * dkt
    inc = r32 * drt - kdk
    # P_t: the reverse cumulative sum of inc over t' > t
    after = F.pad(inc.flip(2).cumsum(2).flip(2)[:, :, 1:], (0, 0, 0, 1))
    dlogw = after - kdk
    du = (r32 * k32 * c[..., None]).sum((0, 2))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlogw, du, ds)
