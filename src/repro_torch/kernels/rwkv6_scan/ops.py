"""Wrapper of the WKV6 kernels, in the reference's (B, H, S, D) layout.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor goes
to one of two kernels by a fixed rule on its shape and dtype
(``kernel_for``), or the wrapper raises: bf16 prompts of S >= 2 tokens at
D = 64 to the chunked tensor-core kernel of ``csrc/wkv6_chunk.cu``,
everything else (decode at S = 1, f32, D of 32 or 128) to the token-by-
token kernel of ``csrc/wkv6_scan.cu``.

A CUDA call that needs a gradient (grad mode on and an input that requires
grad) goes through ``WKV6Fn``: its forward is the same kernel, and its
backward the kernel of ``csrc/wkv6_bwd.cu`` (bf16 at D = 64 only; any
other CUDA call that needs a gradient raises).  On the CPU the plain
version is an autograd op.  A meta tensor (the dry-run) takes the card's
checks and allocations, launches nothing and reports the call to the op
counters under the name of the kernel the card would run.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, wkv6_bwd_ref, wkv6_scan_ref

NAME = "wkv6_scan"
CHUNK_NAME = "wkv6_chunk"
BWD_NAME = "wkv6_bwd"
HEAD_DIMS = (32, 64, 128)
CHUNK_HEAD_DIM = 64
BWD_HEAD_DIM = 64  # the backward kernel's; it takes bf16 only

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 15 + [_P]
_BWD_ARGTYPES = [_P] * 14 + [_I] * 4 + [ctypes.POINTER(_L), _P]


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
    count; where grad mode is on and an input requires grad it goes
    through ``WKV6Fn`` (bf16, D = 64 and no ``out_state``, or it raises),
    whose final state carries no gradient.  On the CPU the plain version
    is an autograd op.
    """
    check_shapes(r, k, v, logw, u, state)
    if out_state is not None and out_state.shape != state.shape:
        raise ValueError(f"{NAME}: out_state{tuple(out_state.shape)} != "
                         f"state{tuple(state.shape)}")
    if r.device.type == "cpu":
        out, s1 = wkv6_scan_ref(r, k, v, logw, u, state)
        if out_state is None:
            return out, s1
        return out, out_state.copy_(s1)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state)):
        with common.card_checks(r):
            check_backward_operands(r, out_state)
        return WKV6Fn.apply(r, k, v, logw, u, state)
    return _launch_forward(r, k, v, logw, u, state, out_state)


def check_shapes(r, k, v, logw, u, state) -> None:
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"{NAME}: r/k/v/logw must share one (B, H, S, D) "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, S, D = r.shape
    if S < 1:
        raise ValueError(f"{NAME}: needs S >= 1, got {S}")
    if tuple(u.shape) != (H, D) or tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"{NAME}: u{tuple(u.shape)} / state"
                         f"{tuple(state.shape)} do not match r{tuple(r.shape)}")


def check_backward_operands(r: torch.Tensor,
                            out_state: Optional[torch.Tensor] = None) -> None:
    """What a CUDA call that needs a gradient takes: bf16 (the training
    dtype) at D = 64 (rwkv6-7b's head dim), the backward kernel's, and no
    ``out_state``: an update in place, which autograd cannot follow."""
    if r.dtype != torch.bfloat16:
        raise RuntimeError(f"wkv6_op: the backward kernel {BWD_NAME} takes "
                           f"bf16, got {r.dtype}")
    if r.shape[-1] != BWD_HEAD_DIM:
        raise RuntimeError(f"wkv6_op: the backward kernel {BWD_NAME} takes "
                           f"head_dim {BWD_HEAD_DIM}, got {r.shape[-1]}")
    if out_state is not None:
        raise RuntimeError("wkv6_op: out_state is an update in place, which "
                           "autograd cannot differentiate; call it without")


def _launch_forward(r, k, v, logw, u, state, out_state):
    """The forward kernel ``kernel_for`` names, on CUDA tensors (on meta
    tensors, the outputs unwritten and the call counted)."""
    B, H, S, D = r.shape
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"{NAME}: unsupported device {r.device}")
    with common.card_checks(r):
        if r.dtype not in common.DTYPE_CODES:
            raise ValueError(f"{NAME}: unsupported dtype {r.dtype}")
        if D not in HEAD_DIMS:
            raise ValueError(f"{NAME}: head_dim {D} not in {HEAD_DIMS}")
    if out_state is None:
        out_state = torch.empty_like(state, memory_format=torch.contiguous_format)
    with common.card_checks(r):
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
    if r.device.type == "meta":
        common.count_meta_call(name, B=B, H=H, S=S, D=D, dtype=str(r.dtype))
        return out, out_state
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its last dim is strided or a row
    misses the kernels' 16-byte alignment."""
    per_16b = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per_16b == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1)):
        return t
    return t.contiguous()


def wkv6_bwd_op(r, k, v, logw, u, state, dout, *, need_dstate: bool = True):
    """Gradients of ``wkv6_op``'s output against ``dout`` (B, H, S, D),
    the final state's taken as zero: (dr, dk, dv) in r's dtype and layout,
    dlogw (B, H, S, D) f32, du (H, D) f32 and dstate (B, H, D, D) f32, or
    None for dstate without ``need_dstate``.

    A CUDA call (bf16, D = 64) runs ``csrc/wkv6_bwd.cu`` on the current
    stream (two kernels: the chunks' states, then every chunk) and bumps
    its launch count once; the wrapper allocates the states' scratch, and
    the kernel leaves each chunk's share of du, which one sum adds up.  A
    CPU call runs ``wkv6_bwd_ref``; a meta call is counted, with the
    card's checks and allocations."""
    check_shapes(r, k, v, logw, u, state)
    if dout.shape != r.shape:
        raise ValueError(f"{BWD_NAME}: dout{tuple(dout.shape)} != "
                         f"r{tuple(r.shape)}")
    if r.device.type == "cpu":
        grads = wkv6_bwd_ref(r, k, v, logw, u, state, dout)
        return grads if need_dstate else grads[:5] + (None,)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"{BWD_NAME}: unsupported device {r.device}")
    with common.card_checks(r):
        check_backward_operands(r)
    B, H, S, D = r.shape
    # autograd's gradient of the output may come in any layout
    dout = _aligned(dout.to(r.dtype))
    with common.card_checks(r):
        for t in (r, k, v, dout):
            common.check_operand(BWD_NAME, t, r.device, r.dtype)
        for t in (logw, u, state):
            common.check_operand(BWD_NAME, t, r.device, torch.float32)
        if not (u.is_contiguous() and state.is_contiguous()):
            raise ValueError(f"{BWD_NAME}: u and state must be contiguous")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    chunks = -(-S // CHUNK)
    du_part = torch.empty(B, H, chunks, D, device=r.device, dtype=torch.float32)
    states = torch.empty(2, B, H, chunks, D, D, device=r.device, dtype=torch.float32)
    dstate = torch.empty_like(state) if need_dstate else None
    if r.numel() == 0:
        return (dr, dk, dv, dlogw.zero_(), u.new_zeros(u.shape),
                dstate.zero_() if need_dstate else None)
    if r.device.type == "meta":
        common.count_meta_call(BWD_NAME, B=B, H=H, S=S, D=D,
                               dtype=str(r.dtype))
        return dr, dk, dv, dlogw, du_part.sum((0, 2)), dstate
    strides = (_L * 27)(*[t.stride(i) for t in (r, k, v, logw, dout, dr, dk,
                                                dv, dlogw) for i in (0, 1, 2)])
    fn = common.load_function(BWD_NAME, BWD_NAME, _BWD_ARGTYPES)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state.data_ptr(), dout.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du_part.data_ptr(),
            dstate.data_ptr() if need_dstate else None, states.data_ptr(), B, H, S,
            D, strides, common.current_stream(r.device))
    common.check(BWD_NAME, rc)
    common.count_launch(BWD_NAME)
    return dr, dk, dv, dlogw, du_part.sum((0, 2)), dstate


class WKV6Fn(torch.autograd.Function):
    """The WKV6 recurrence with a gradient.  The forward runs the kernel
    ``kernel_for`` names (on the CPU, ``wkv6_scan_ref``) and keeps its
    inputs; the backward is one ``wkv6_bwd_op``.  It returns (out, final
    state); the final state is not differentiable, and its gradient is
    taken as zero."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        if r.device.type == "cpu":
            out, s1 = wkv6_scan_ref(r, k, v, logw, u, state)
        else:
            out, s1 = _launch_forward(r, k, v, logw, u, state, None)
        ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.mark_non_differentiable(s1)
        return out, s1

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dstate1):
        r, k, v, logw, u, state = ctx.saved_tensors
        return wkv6_bwd_op(r, k, v, logw, u, state, dout,
                           need_dstate=ctx.needs_input_grad[5])
