"""Plain PyTorch versions of the flash attention kernels: the forward, the
forward that also returns each row's log-sum-exp, and the backward; and,
for the tests, the backward split and merged as its kernel schedules it."""
from __future__ import annotations

import math

import torch


def _masked_scores(q: torch.Tensor, k: torch.Tensor, window: int,
                   causal: bool) -> torch.Tensor:
    """The scaled scores (B, KV, G, Sq, Sk) of q (B, H, Sq, D) against k
    (B, KV, Sk, D), masked positions at -1e30; in f32, or f64 for f64
    inputs."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and {Sk}")
    if not causal and window > 0:
        raise ValueError("a sliding window needs causal attention")
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, H // KV, Sq, D).to(acc)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(acc)) * scale
    if causal:
        pos = torch.arange(Sq, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window > 0:
            mask &= pos[None, :] > pos[:, None] - window
        scores = scores.masked_fill(~mask, -1e30)
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D).  Softmax attention, causal
    (Sq == Sk, optionally within a sliding window) or, with
    ``causal=False``, every query over all Sk keys with no mask.

    Computed in f32 (f64 for f64 inputs); the output is in q's dtype.
    """
    B, H, Sq, D = q.shape
    scores = _masked_scores(q, k, window, causal)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(scores.dtype))
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, window: int = 0,
                                causal: bool = True):
    """``flash_attention_ref`` and the log-sum-exp of each row's scaled,
    masked scores (natural log), which the backward recomputes the
    probabilities from.  Returns (out (B, H, Sq, D) in q's dtype,
    lse (B, H, Sq) in f32, f64 for f64 inputs)."""
    B, H, Sq, D = q.shape
    scores = _masked_scores(q, k, window, causal)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(scores.dtype))
    return out.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, *, window: int = 0,
                            causal: bool = True):
    """The backward of ``flash_attention_ref`` by its explicit formula:
    P = exp(scale Q K^T - lse) under the forward's mask, dP = dO V^T,
    dS = P (dP - D_i) with D_i = rowsum(dO * O), dQ = scale dS K,
    dK = scale dS^T Q and dV = P^T dO, dK and dV summed over the G query
    heads of each KV head.

    q/out/dout: (B, H, Sq, D); k/v: (B, KV, Sk, D); lse: (B, H, Sq), the
    forward's.  Computed in f32 (f64 for f64 inputs).  Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    scores = _masked_scores(q, k, window, causal)
    acc = scores.dtype
    p = torch.exp(scores - lse.reshape(B, KV, G, Sq, 1).to(acc))
    qg = q.reshape(B, KV, G, Sq, D).to(acc)
    dog = dout.reshape(B, KV, G, Sq, D).to(acc)
    delta = (dog * out.reshape(B, KV, G, Sq, D).to(acc)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.to(acc))
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_split_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  dout: torch.Tensor, lse: torch.Tensor, plan,
                                  *, window: int = 0, causal: bool = True):
    """``flash_attention_bwd_ref`` computed as the backward kernel
    schedules dK and dV (tests only): each unit of ``plan`` (an
    ``ops.BwdPlan`` of these shapes) sums, over its (query head, query
    tile) iterations, the 64-key blocks of dS^T Q and P^T dO of its key
    tile; a tile with one unit takes that sum, and a split tile the sum of
    its units' partials in unit order; dK is scaled last.

    Same layouts, precision and dtypes as ``flash_attention_bwd_ref``."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    tile = 64
    scale = 1.0 / math.sqrt(D)
    scores = _masked_scores(q, k, window, causal)
    acc = scores.dtype
    p = torch.exp(scores - lse.reshape(B, KV, G, Sq, 1).to(acc))
    qg = q.reshape(B, KV, G, Sq, D).to(acc)
    dog = dout.reshape(B, KV, G, Sq, D).to(acc)
    delta = (dog * out.reshape(B, KV, G, Sq, D).to(acc)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, v.to(acc)) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.to(acc)) * scale
    dk = torch.zeros(B, KV, Sk, D, dtype=acc)
    dv = torch.zeros(B, KV, Sk, D, dtype=acc)
    partials = {}
    for t, it0, it1, slot in plan.units:
        qt0, nq = plan.walks[t]
        keys = slice(t * tile, min(Sk, (t + 1) * tile))
        pk = torch.zeros(B, KV, keys.stop - keys.start, D, dtype=acc)
        pv = torch.zeros_like(pk)
        for it in range(it0, it1):
            g, qi = it // nq, qt0 + it % nq
            rows = slice(qi * tile, min(Sq, (qi + 1) * tile))
            pk = pk + torch.einsum("bkqs,bkqd->bksd", ds[:, :, g, rows, keys],
                                   qg[:, :, g, rows])
            pv = pv + torch.einsum("bkqs,bkqd->bksd", p[:, :, g, rows, keys],
                                   dog[:, :, g, rows])
        if slot < 0:
            dk[:, :, keys], dv[:, :, keys] = pk * scale, pv
        else:
            partials[slot] = (pk, pv)
    for t, slot0, count in plan.merges:
        keys = slice(t * tile, min(Sk, (t + 1) * tile))
        sk = torch.zeros_like(partials[slot0][0])
        sv = torch.zeros_like(sk)
        for slot in range(slot0, slot0 + count):
            sk, sv = sk + partials[slot][0], sv + partials[slot][1]
        dk[:, :, keys], dv[:, :, keys] = sk * scale, sv
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
