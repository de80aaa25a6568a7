"""Plain PyTorch versions of the WKV6 kernels.

``wkv6_scan_ref`` is the token-by-token recurrence: the plain version of
both forward kernels, which the wrapper runs on the CPU and
``chip_smoke.py`` holds them to on the card.  ``wkv6_chunk_ref`` computes
the same function through the chunked kernel's own factorisation, in f32;
the tests hold its arithmetic to the recurrence and to the JAX package.
``wkv6_bwd_ref`` is the plain version of the backward kernel
(``csrc/wkv6_bwd.cu``), which the wrapper runs on the CPU and
``chip_smoke.py`` holds the kernel to: the recurrence's gradients token by
token; the tests hold it to autograd of ``wkv6_scan_ref``.
``wkv6_bwd_chunk_ref`` computes the same gradients through the kernel's
chunked factorisation (``wkv6_bwd_chunk_states`` its two walks over the
chunks); the tests hold its arithmetic to autograd and to the JAX package.

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


def _matmul(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _excl_cumsum(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """Sum of the entries before each along ``dim`` (after it, reversed)."""
    if reverse:
        return _excl_cumsum(x.flip(dim), dim).flip(dim)
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)),
                      torch.cumsum(x, dim).narrow(dim, 0, x.shape[dim] - 1)], dim)


def _chunked(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """(B, H, S, D) as (B, H, n, chunk, D), zero-padded past S."""
    B, H, S, D = x.shape
    return F.pad(x, (0, 0, 0, n * chunk - S)).reshape(B, H, n, chunk, D)


class _Decays:
    """logw of each chunk (log2 units; padded tokens 0) as sums over
    sub-chunks of ``sub`` tokens, so that every exponent is a sum over its
    own span of tokens and never the difference of two long prefix sums:

    * ``lw`` (B, H, n, chunk, D) and, per sub-chunk, ``before`` / ``after``,
      the sum over its tokens before / after each token, and ``tot``
      (B, H, n, chunk / sub, D), its sum;
    * ``excl`` = cum[t - 1] and ``to_end`` = last - cum[t] (B, H, n, chunk,
      D), ``last`` (B, H, n, 1, D)."""

    def __init__(self, logw, n, chunk, sub, acc):
        B, H, _, D = logw.shape
        self.sub = sub
        self.lw = _chunked(logw.to(acc), n, chunk) * LOG2E
        lws = self.lw.reshape(B, H, n, chunk // sub, sub, D)
        self.tot = torch.cumsum(lws, 4)[..., -1, :]
        self.before = _excl_cumsum(lws, 4).reshape(self.lw.shape)
        self.after = _excl_cumsum(lws, 4, reverse=True).reshape(self.lw.shape)
        grow = lambda x: x.repeat_interleave(sub, 3)  # noqa: E731
        self.excl = grow(_excl_cumsum(self.tot, 3)) + self.before
        self.to_end = self.after + grow(_excl_cumsum(self.tot, 3, reverse=True))
        self.last = torch.cumsum(self.tot, 3)[..., -1:, :]

    def span(self, i: int, j: int) -> torch.Tensor:
        """The sum over sub-chunks i..j-1 (zero where j <= i)."""
        out = torch.zeros_like(self.tot[..., :1, :])
        for m in range(i, j):
            out = out + self.tot[..., m:m + 1, :]
        return out

    def pair_decays(self, m: int) -> torch.Tensor:
        """(.., t, s, D): the product of the decays 2^lw over s < tau < t in
        sub-chunk m, 0 at s >= t; multiplied from tau = t - 1 down, as the
        kernel's pair loop."""
        sub = self.sub
        w = torch.exp2(self.lw[..., m * sub:(m + 1) * sub, :])
        idx = torch.arange(sub, device=w.device)
        upto = (idx[None, :] < idx[:, None])[..., None]  # tau < t
        x = torch.where(upto, w[..., None, :, :], 1.0).flip(-2)
        prod = torch.cat([torch.ones_like(x[..., :1, :]), torch.cumprod(x, -2)[..., :-1, :]],
                         -2).flip(-2)  # [t, s]: the product over tau > s
        return torch.where(upto, prod, 0.0)


def wkv6_bwd_chunk_states(r, k, v, logw, state, dout, *, chunk: int = CHUNK,
                          sub: int = SUB, mm=_matmul):
    """Phases 1 and 2 of ``csrc/wkv6_bwd.cu``: the state at the start of
    each chunk, S_n (B, H, n, D, D), and the gradient of the loss with
    respect to the state at its end, dS_n (the last chunk's zero), walking
    the chunks forward and backward:

        S_(n+1) = diag(2^last) S_n + (k 2^(last - cum))^T v
        dS_(n-1) = diag(2^last) dS_n + (r 2^excl)^T dout

    and dstate, the gradient at the first chunk's start.  In f32 (f64 for
    f64 inputs); ``mm(name, a, b)`` takes each product (``a @ b``)."""
    acc = _acc(r)
    n = -(-r.shape[2] // chunk)
    rc, kc, vc, dc = (_chunked(x.to(acc), n, chunk) for x in (r, k, v, dout))
    dec = _Decays(logw, n, chunk, sub, acc)
    s, ds = state.to(acc), torch.zeros_like(state, dtype=acc)
    states, dstates = [], [None] * n
    for i in range(n):
        states.append(s)
        kdec = kc[:, :, i] * torch.exp2(dec.to_end[:, :, i])
        s = (s * torch.exp2(dec.last[:, :, i]).transpose(-1, -2)
             + mm("state", kdec.transpose(-1, -2), vc[:, :, i]))
    for i in reversed(range(n)):
        dstates[i] = ds
        rdec = rc[:, :, i] * torch.exp2(dec.excl[:, :, i])
        ds = (ds * torch.exp2(dec.last[:, :, i]).transpose(-1, -2)
              + mm("dstate", rdec.transpose(-1, -2), dc[:, :, i]))
    return torch.stack(states, 2), torch.stack(dstates, 2), ds


def wkv6_bwd_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                       dout: torch.Tensor, *, chunk: int = CHUNK, sub: int = SUB,
                       mm=_matmul) -> Tuple[torch.Tensor, ...]:
    """``wkv6_bwd_ref``'s gradients as ``csrc/wkv6_bwd.cu`` factors them, in
    f32 (f64 for f64 inputs).  Same arguments and results.

    Phases 1 and 2 (``wkv6_bwd_chunk_states``) give each chunk of
    ``chunk`` tokens (the last zero-padded, as ``wkv6_chunk_ref`` pads) the
    state S0 at its start and the gradient dSe at its end.  Phase 3 takes
    every chunk on its own, with ``cum``, ``excl``, ``last`` as
    ``wkv6_chunk_ref`` defines them, ``c_t = v_t . dout_t`` and
    dA[t, s] = dout_t . v_s for s < t:

    * dr = 2^excl (dout S0^T) + sum_s dA[t, s] k_s 2^(excl_t - cum_s)
      + u k c;
    * dk = 2^(last - cum) (v dSe^T) + sum_t dA[t, s] r_t 2^(excl_t - cum_s)
      + r u c;
    * dv = (k 2^(last - cum)) dSe + A^T dout + (r . (u * k)) dout.

    The pair sums run as the forward builds A, in sub-chunks of ``sub``
    tokens: pairwise on the diagonal blocks; below them dr's through the
    boundary B_m = cum before sub-chunk m (rows t in m against the tokens
    before m), dk's and A^T's through E_m = cum at the end of sub-chunk m
    (rows s in m against the tokens after it).  Every exponent is <= 0
    and is summed over its own span (``_Decays``): a difference of two
    prefix sums ~450 deep at strong decays would carry ~2e-5 of relative
    error into each decay, as much as the running sum leaves in dlogw.  A
    diagonal block's pair takes the product of its tokens' decays.

    dlogw_t = exp(logw_t) sum_j S_(t-1)[:, j] dS_t[:, j], with no sum
    carried across chunks and no difference of growing sums.  Expanded
    in the chunk, per channel, it is the sum of

    * (a) 2^last (S0 dSe^T)[i, i], the same for every t;
    * (b) sum over t' > t of r_t' * (2^excl (dout S0^T))_t';
    * (c) sum over s < t of k_s * (2^(last - cum) (v dSe^T))_s;
    * (d) sum over s < t < t' of Z[t', s] = k_s r_t' 2^(excl_t' - cum_s)
      dA[t', s], the pairs that straddle t, by where s and t' lie against
      t's sub-chunk m: both before and after it (the block sums of Z
      from dk's products), s before and t' in m (r times dr's part below
      the diagonal), s in m and t' after (k times dk's part above it),
      both in m (pairwise).

    ``mm(name, a, b)`` takes each product (``a @ b``); a caller may read
    its operands as the kernel's bf16 parts.
    """
    acc = _acc(r)
    B, H, S, D = r.shape
    n = -(-S // chunk)
    S0, dSe, dstate = wkv6_bwd_chunk_states(r, k, v, logw, state, dout,
                                            chunk=chunk, sub=sub, mm=mm)
    rc, kc, vc, dc = (_chunked(x.to(acc), n, chunk) for x in (r, k, v, dout))
    dec = _Decays(logw, n, chunk, sub, acc)
    u32 = u.to(acc)[None, :, None, None, :]
    c = (vc * dc).sum(-1, keepdim=True)
    bonus = (rc * u32 * kc).sum(-1, keepdim=True)

    dr = torch.exp2(dec.excl) * mm("inter_r", dc, S0.transpose(-1, -2))
    dk = torch.exp2(dec.to_end) * mm("inter_k", vc, dSe.transpose(-1, -2))
    dv = mm("inter_v", kc * torch.exp2(dec.to_end), dSe) + bonus * dc
    # (a), (b), (c)
    dlogw = (torch.exp2(dec.last) * (S0 * dSe).sum(-1).unsqueeze(-2)
             + _excl_cumsum(rc * dr, 3, reverse=True) + _excl_cumsum(kc * dk, 3))

    dA = mm("dA", dc, vc.transpose(-1, -2))  # [t, s]; only s < t is used
    idx = torch.arange(sub, device=r.device)
    below = idx[:, None] > idx[None, :]  # [t, s]: s < t
    nsub = chunk // sub
    zb = {}  # the sum of Z over t' in sub-chunk l and s in j < l
    for m in range(nsub):
        tm = slice(m * sub, (m + 1) * sub)
        r_m, k_m = rc[..., tm, :], kc[..., tm, :]
        # the diagonal block, pair by pair
        f = dec.pair_decays(m)
        dA_m = torch.where(below, dA[..., tm, tm], 0.0)[..., None]
        rkf = r_m[..., :, None, :] * k_m[..., None, :, :] * f
        dr[..., tm, :] += (dA_m * k_m[..., None, :, :] * f).sum(-2)
        dk[..., tm, :] += (dA_m * r_m[..., :, None, :] * f).sum(-3)
        dv[..., tm, :] += mm("dv_intra", rkf.sum(-1).transpose(-1, -2), dc[..., tm, :])
        # (d), both in m: over t' > t, the sum of Z[t', s] over s < t
        before = _excl_cumsum(rkf * dA_m, -2)  # [t', t]
        dlogw[..., tm, :] += (before * below[..., None]).sum(-3)
        if m:  # t' in m, s before it: through B_m
            kq = kc[..., :m * sub, :] * torch.exp2(torch.cat(
                [dec.after[..., j * sub:(j + 1) * sub, :] + dec.span(j + 1, m)
                 for j in range(m)], -2))
            dr_b = (torch.exp2(dec.before[..., tm, :])
                    * mm("dr_intra", dA[..., tm, :m * sub], kq))
            dr[..., tm, :] += dr_b
            dlogw[..., tm, :] += _excl_cumsum(r_m * dr_b, 3, reverse=True)
        if m < nsub - 1:  # s in m, t' after it: through E_m
            k_e = k_m * torch.exp2(dec.after[..., tm, :])
            dk_b = torch.zeros_like(k_m)
            for l in range(m + 1, nsub):
                tl = slice(l * sub, (l + 1) * sub)
                r_e = rc[..., tl, :] * torch.exp2(dec.before[..., tl, :] + dec.span(m + 1, l))
                p = mm("dk_intra", dA[..., tl, tm].transpose(-1, -2), r_e)
                dk_b += p
                zb[l, m] = (k_e * p).sum(-2, keepdim=True)
                a_t = mm("A", k_e, r_e.transpose(-1, -2))
                dv[..., tm, :] += mm("dv_intra", a_t, dc[..., tl, :])
            dk_b = torch.exp2(dec.after[..., tm, :]) * dk_b
            dk[..., tm, :] += dk_b
            dlogw[..., tm, :] += _excl_cumsum(k_m * dk_b, 3)
        # (d), s before m and t' after it
        for (l, j), z in zb.items():
            if j < m < l:
                dlogw[..., tm, :] += z
    dr = dr + u32 * kc * c
    dk = dk + rc * u32 * c
    du = (rc * kc * c).sum((0, 2, 3))
    out = [x.reshape(B, H, n * chunk, D)[:, :, :S] for x in (dr, dk, dv, dlogw)]
    return (out[0].to(r.dtype), out[1].to(r.dtype), out[2].to(r.dtype), out[3],
            du, dstate)
