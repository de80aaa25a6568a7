"""Pieces the references share: the norm, RoPE, the products in f32 or in
the control's fp8, and the f32 copy of a layer's weights."""
from __future__ import annotations

import math
from typing import Dict

import torch

F8_MAX = 448.0  # the largest finite float8 e4m3fn value


def no_tf32() -> None:
    """f32 products in f32: a TF32 product is a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def padded_vocab(m: dict) -> int:
    """The embedding and LM head tables' rows: the vocabulary rounded up
    to a multiple of 256, as the program pads them."""
    return (m["vocab_size"] + 255) // 256 * 256


def f32(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The weights whose name starts with ``prefix``, by the rest of their
    name, as f32 copies."""
    return {name[len(prefix):]: w.float() for name, w in weights.items()
            if name.startswith(prefix)}


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (its amax maps to 448), returned in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = F8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def dot(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in f32, or in the control with both operands
    rounded to fp8: x per row, w per output column."""
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, -2)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + w): the model's norm keeps a zero-centred scale."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, D) at positions 0..T-1: the pairs
    (i, i + D/2) rotated by position * theta^(-i / (D/2))."""
    T, _, D = x.shape
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Softmax(q k^T / sqrt(D)) v over keys at or before each query; q (T,
    H, D), k and v (T, KV, D) with H a multiple of KV; blocks of queries."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)  # (H, T, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(s + block, T)
        scores = torch.einsum("qhd,hkd->hqk", q[s:e], k[:, :e]) / math.sqrt(D)
        mask = (torch.arange(e, device=q.device)[None, :]
                > torch.arange(s, e, device=q.device)[:, None])
        scores.masked_fill_(mask, float("-inf"))
        out[s:e] = torch.einsum("hqk,hkd->qhd", torch.softmax(scores, -1), v[:, :e])
    return out


def head_logits(x, final_norm, lm_head, vocab: int, eps: float, precision: str):
    """The final norm and the logits over the real vocabulary (the table's
    padding rows are not read)."""
    return dot(rms_norm(x, final_norm, eps), lm_head[:vocab].t(), precision)
