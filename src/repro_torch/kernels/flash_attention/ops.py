"""Wrapper of the flash attention kernel, in the model's (B, S, H, D) layout.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor goes
to the kernel of ``csrc/flash_attention.cu``, or the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.tile_plan import HEAD_DIMS

NAME = "flash_attention"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P] + [_I] * 9 + [_L] * 12 + [_P]


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int = 0, causal: bool = True) -> torch.Tensor:
    """GQA attention: causal (optionally sliding-window), or with
    ``causal=False`` every query over all keys (the encoders).

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D), as produced by attention_qkv.
    Causal attention needs Sq == Sk; non-causal takes any Sk >= 1 and no
    window.  Returns (B, Sq, H, D) in q's dtype.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"{NAME}: q{tuple(q.shape)} does not match "
                         f"k/v{tuple(k.shape)}")
    if causal and Sk != Sq:
        raise ValueError(f"{NAME}: causal attention needs k/v of q's length "
                         f"{Sq}, got {Sk}")
    if not causal and window > 0:
        raise ValueError(f"{NAME}: a sliding window needs causal attention")
    if Sk < 1 and Sq > 0:
        raise ValueError(f"{NAME}: no keys to attend over")
    if q.device.type == "cpu":
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window,
                                   causal=causal).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    check_kernel_operands(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    fn = common.load_function(NAME, "flash_attention_fwd", _ARGTYPES)
    # element strides in (batch, head, position) order
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, D, int(window), int(causal),
            common.DTYPE_CODES[q.dtype], *strides,
            common.current_stream(q.device))
    common.check(NAME, rc)
    common.count_launch(NAME)
    return out


def check_kernel_operands(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> None:
    """What the kernel takes beyond the shapes: f32 or bf16, a head dim of
    ``HEAD_DIMS`` and aligned rows.  The plain version takes any of these."""
    if q.dtype not in common.DTYPE_CODES:
        raise ValueError(f"{NAME}: unsupported dtype {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    for t in (q, k, v):
        common.check_operand(NAME, t, q.device, q.dtype)


def flash_attention_plan(batch: int, heads: int, seq: int, head_dim: int,
                         dtype: torch.dtype) -> tuple:
    """The tiles the kernel launches for q of (batch, seq, heads, head_dim)
    on the current card, as its ``flash_attention_plan`` reports them:
    (warpgroups, rows, block_kv, stages, smem_bytes), the numbers of
    ``tile_plan.TilePlan.kernel_numbers``.  Launches nothing."""
    fn = common.load_function(NAME, "flash_attention_plan",
                              [_I] * 5 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    common.check(NAME, fn(batch, heads, seq, head_dim,
                          common.DTYPE_CODES[dtype], out))
    return tuple(out)
