"""Wrapper of the WKV6 kernels, in the reference's (B, H, S, D) layout.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor goes
to one of two kernels by a fixed rule on its shape and dtype
(``kernel_for``), or the wrapper raises: bf16 prompts of S >= 2 tokens at
D = 64 to the chunked tensor-core kernel of ``csrc/wkv6_chunk.cu``,
everything else (decode at S = 1, f32, D of 32 or 128) to the token-by-
token kernel of ``csrc/wkv6_scan.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref

NAME = "wkv6_scan"
CHUNK_NAME = "wkv6_chunk"
HEAD_DIMS = (32, 64, 128)
CHUNK_HEAD_DIM = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 15 + [_P]


def kernel_for(dtype: torch.dtype, S: int, D: int) -> str:
    """The kernel a CUDA call of ``wkv6_op`` launches.  f32 stays on the
    scan: bf16 products would miss its f32 checks."""
    if dtype == torch.bfloat16 and S >= 2 and D == CHUNK_HEAD_DIM:
        return CHUNK_NAME
    return NAME


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
            out_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over S >= 1 tokens from a carried state.

    r/k/v: (B, H, S, D) in the model's dtype; logw: (B, H, S, D) f32, <= 0;
    u: (H, D) f32; state: (B, H, D, D) f32.  r/k/v/logw may be strided
    views (the model passes transposed (B, S, H, D) projections).  Returns
    (out (B, H, S, D) in r's dtype, final state (B, H, D, D) f32).  The
    final state goes to ``out_state`` when it is given, which may be
    ``state`` itself (an update in place).  On the card the call runs
    the kernel ``kernel_for(r.dtype, S, D)`` names and bumps its launch
    count, and raises where an input requires grad (neither kernel has a
    backward); on the CPU the plain version is an autograd op.
    """
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"{NAME}: r/k/v/logw must share one (B, H, S, D) "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, S, D = r.shape
    if S < 1:
        raise ValueError(f"{NAME}: needs S >= 1, got {S}")
    if tuple(u.shape) != (H, D) or tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"{NAME}: u{tuple(u.shape)} / state"
                         f"{tuple(state.shape)} do not match r{tuple(r.shape)}")
    if out_state is not None and out_state.shape != state.shape:
        raise ValueError(f"{NAME}: out_state{tuple(out_state.shape)} != "
                         f"state{tuple(state.shape)}")
    if r.device.type == "cpu":
        out, s1 = wkv6_scan_ref(r, k, v, logw, u, state)
        if out_state is None:
            return out, s1
        return out, out_state.copy_(s1)
    common.refuse_grad("wkv6_op", r, k, v, logw, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {r.device}")
    if r.dtype not in common.DTYPE_CODES:
        raise ValueError(f"{NAME}: unsupported dtype {r.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {D} not in {HEAD_DIMS}")
    if out_state is None:
        out_state = torch.empty_like(state, memory_format=torch.contiguous_format)
    for t in (k, v):
        common.check_operand(NAME, t, r.device, r.dtype)
    for t in (logw, u, state, out_state):
        common.check_operand(NAME, t, r.device, torch.float32)
    if not (u.is_contiguous() and state.is_contiguous()
            and out_state.is_contiguous()):
        raise ValueError(f"{NAME}: u, state and out_state must be contiguous")
    common.check_operand(NAME, r, r.device, r.dtype)
    out = torch.empty_like(r)  # keeps r's strides when r is dense
    if out.numel() == 0:
        return out, out_state.copy_(state)
    name = kernel_for(r.dtype, S, D)
    fn = common.load_function(name, f"{name}_fwd", _ARGTYPES)
    # element strides in (batch, head, position) order
    strides = [t.stride(i) for t in (r, k, v, logw, out) for i in (0, 1, 2)]
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(),
            out_state.data_ptr(), B, H, S, D, common.DTYPE_CODES[r.dtype],
            *strides, common.current_stream(r.device))
    common.check(name, rc)
    common.count_launch(name)
    return out, out_state
