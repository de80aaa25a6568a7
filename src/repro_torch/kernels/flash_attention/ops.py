"""Wrappers of the flash attention kernels, in the model's (B, S, H, D) layout.

A CPU tensor goes to the plain versions in ``ref.py``.  A CUDA tensor goes
to the kernels of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward), or the wrapper raises.

A call that needs a gradient (grad mode on and an input that requires
grad) goes through ``FlashAttentionFn``: its forward also keeps each row's
log-sum-exp, and its backward launches the backward kernels (on the CPU,
the plain forward-with-LSE and the plain backward).  Every other call
takes the forward alone, with no LSE.  Both take bf16 and f32 at every
head dim of ``HEAD_DIMS``.

The bf16 backward's dK/dV work is spread over the card by
``plan_bwd_units``, a pure host planner: each 64-key tile's walk over its
(query head, query tile) iterations is cut into units of at most ``cap``
iterations, which launch heaviest first.  The kernel rebuilds the same
order on the card from its scalar arguments, so a call copies nothing to
the card and never waits for it.  The wrapper allocates one scratch
(``bwd_work_bytes``) for the padded lse and D rows, the order and the f32
partials of split tiles.  The f32 backward walks whole tiles and needs
only its D rows (``bwd_work_bytes_f32``).

A meta tensor (the dry-run) takes the card's checks and allocations,
scratch included, with ``hw.H100``'s SM count for the plan, launches
nothing and reports the call to the op counters
(``common.count_meta_call``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch import hw
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_lse_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.tile_plan import HEAD_DIMS

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
# the backward kernels' dtypes and head dims: bf16 on the tensor cores,
# f32 on the CUDA cores, each at every head dim the forward takes
BWD_DTYPES = (torch.bfloat16, torch.float32)
BWD_HEAD_DIMS = HEAD_DIMS
# rows of the backward's query and key tiles, and the dK/dV units the
# planner counts on at once per SM: the persistent wgmma kernel's two
# workers, one per consumer warpgroup (D = 64, 128), or two mma.sync blocks
# (D = 32); at D = 256 the wgmma kernel's block is one worker, both
# consumer warpgroups on its jobs (``bwd_slots_per_sm``)
BWD_TILE = 64
BWD_SLOTS_PER_SM = 2
# shared memory of an SM that one block may take (the H100's 227 KB)
SM_SMEM_BYTES = 232448

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I] * 9 + [_L] * 12 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 10 + [_L] * 25 + [_P]


def _bhs_strides(*tensors):
    """Element strides of (B, S, H, D) tensors in (batch, head, position)
    order, the kernels' argument order."""
    return [t.stride(i) for t in tensors for i in (0, 2, 1)]


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int = 0, causal: bool = True) -> torch.Tensor:
    """GQA attention: causal (optionally sliding-window), or with
    ``causal=False`` every query over all keys (the encoders).

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D), as produced by attention_qkv.
    Causal attention needs Sq == Sk; non-causal takes any Sk >= 1 and no
    window.  Returns (B, Sq, H, D) in q's dtype.  With grad mode on and an
    input that requires grad the call goes through ``FlashAttentionFn``
    (on the card: a dtype of ``BWD_DTYPES`` and a head dim of
    ``BWD_HEAD_DIMS``).
    """
    check_shapes(q, k, v, window, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type != "cpu":
            with common.card_checks(q):
                check_backward_operands(q)
        return FlashAttentionFn.apply(q, k, v, window, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window,
                                   causal=causal).transpose(1, 2)
    return _launch_forward(q, k, v, window, causal, with_lse=False)[0]


def check_shapes(q, k, v, window: int, causal: bool) -> None:
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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{NAME}: unsupported device {q.device}")


def _launch_forward(q, k, v, window: int, causal: bool, with_lse: bool):
    """The forward kernel on CUDA tensors: (out (B, Sq, H, D), and with
    ``with_lse`` each row's log-sum-exp (B, H, Sq) f32, else None).  On
    meta tensors, the outputs unwritten and the call counted."""
    with common.card_checks(q):
        check_kernel_operands(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if q.device.type == "meta":
        common.count_meta_call(NAME, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, D=D,
                               window=int(window), causal=bool(causal),
                               dtype=str(q.dtype), lse=with_lse)
        return out, lse
    fn = common.load_function(NAME, "flash_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, H, KV, Sq, Sk, D, int(window), int(causal),
            common.DTYPE_CODES[q.dtype], *_bhs_strides(q, k, v, out),
            common.current_stream(q.device))
    common.check(NAME, rc)
    common.count_launch(NAME)
    return out, lse


def flash_attention_fwd_lse(q, k, v, *, window: int = 0, causal: bool = True):
    """The forward and each row's log-sum-exp of the scaled, masked scores
    (natural log): (out (B, Sq, H, D), lse (B, H, Sq) f32).  The forward of
    ``FlashAttentionFn``; on the card, a dtype of ``BWD_DTYPES``."""
    check_shapes(q, k, v, window, causal)
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_lse_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=window, causal=causal)
        return out.transpose(1, 2), lse
    with common.card_checks(q):
        check_backward_operands(q)
    return _launch_forward(q, k, v, window, causal, with_lse=True)


class BwdPlan(NamedTuple):
    """The dK/dV schedule of one (batch, KV head); every one is the same.

    ``units`` in launch order: (key tile, first iteration, end, partial
    slot or -1 for a tile written whole).  Iteration ``it`` of tile t is
    query head ``it // nq`` of the group and query tile ``qt0 + it % nq``,
    with ``(qt0, nq) = walks[t]``.  ``merges``: (key tile, first slot,
    units) of each split tile, whose units write their partials to
    consecutive slots in chunk order."""
    cap: int
    units: Tuple[Tuple[int, int, int, int], ...]
    merges: Tuple[Tuple[int, int, int], ...]
    partials: int
    walks: Tuple[Tuple[int, int], ...]
    work: Tuple[int, ...]


def _tile_walk(t: int, Sq: int, window: int, causal: bool) -> Tuple[int, int]:
    """(first query tile, query tiles) that reach key tile ``t``: causal,
    from its first key to its last key's window; non-causal, all."""
    q_begin, q_end = 0, Sq
    if causal:
        q_begin = t * BWD_TILE
        if window > 0:
            q_end = min(Sq, t * BWD_TILE + BWD_TILE - 1 + window)
    qt0 = q_begin // BWD_TILE
    return qt0, ((q_end - 1) // BWD_TILE - qt0 + 1 if q_end > q_begin else 0)


def bwd_tc_stages(D: int, workers: int) -> int:
    """Stages of the streamed tile pair that each of ``workers`` slots of
    the persistent wgmma backward's block holds at head dim ``D`` (the
    kernel's ``tc::Cfg<D>::STAGES``, at most four): what is left of the
    SM's shared memory, less 1 KB of alignment slack, after the slot's
    fixed tile pair (two buffers at D = 64), a one-worker slot's two
    64 x 64 f32 exchange tiles and 1 KB for barriers, over a stage's
    tile pair and 512 bytes of lse and D rows."""
    tile = BWD_TILE * D * 2
    fixed = (2 if D <= 64 else 1) * 2 * tile
    xch = 2 * BWD_TILE * BWD_TILE * 4 if workers == 1 else 0
    fit = ((SM_SMEM_BYTES - 1024) // workers - fixed - xch - 1024) // (2 * tile + 512)
    return min(4, fit)


def bwd_slots_per_sm(D: int) -> int:
    """The dK/dV workers the bf16 backward runs at once on an SM at head
    dim ``D``: ``BWD_SLOTS_PER_SM`` at D = 32 (two ``mma.sync`` blocks)
    and wherever two slots of two stages each fit (D = 64, 128), else one
    (D = 256, ``bwd_tc_smem_bytes``)."""
    if D == 32 or bwd_tc_stages(D, BWD_SLOTS_PER_SM) >= 2:
        return BWD_SLOTS_PER_SM
    return 1


def bwd_tc_smem_bytes(D: int) -> int:
    """Dynamic shared memory of a block of the persistent wgmma backward at
    head dim ``D`` (the kernel's ``tc::Cfg<D>::SMEM``): its
    ``bwd_slots_per_sm`` slots, each the fixed pair, ``bwd_tc_stages``
    stages, the exchange tiles of a one-worker slot and 8 bytes per
    mbarrier, rounded up to 1 KB, then 1 KB of alignment slack."""
    workers = bwd_slots_per_sm(D)
    stages, tile = bwd_tc_stages(D, workers), BWD_TILE * D * 2
    fb = 2 if D <= 64 else 1
    xch, bars = (2 * BWD_TILE * BWD_TILE * 4, 4) if workers == 1 else (0, 0)
    used = fb * 2 * tile + stages * (2 * tile + 512) + xch + 8 * (2 * (fb + stages) + bars)
    return workers * (-(-used // 1024) * 1024) + 1024


@functools.lru_cache(maxsize=256)
def plan_bwd_units(B: int, KV: int, G: int, Sq: int, Sk: int, window: int,
                   causal: bool, sms: int, cap: int = 0,
                   slots: int = BWD_SLOTS_PER_SM) -> BwdPlan:
    """The dK/dV units of the backward kernel, from the shape and the
    card's SM count ``sms`` alone (no tensor is read).

    Key tile t walks w(t) = G x nq(t) iterations.  The cap T is the
    balanced share of the card's ``slots * sms`` dK/dV workers
    (``bwd_slots_per_sm`` of the head dim), ceil(B KV sum w / (slots
    sms)), so no unit is longer than that share plus one (``cap`` > 0 sets
    T instead, for tests).  Each walk is
    cut into full units of T and a remainder; the full units launch
    first in (tile, chunk) order, then the remainders, larger first and
    ties by tile.  The kernel's ``plan_block`` builds the same order."""
    walks = tuple(_tile_walk(t, Sq, window, causal)
                  for t in range(-(-Sk // BWD_TILE)))
    work = tuple(G * nq for _, nq in walks)
    if cap <= 0:
        cap = max(1, -(-B * KV * sum(work) // (slots * sms)))
    full, rest, merges, slot = [], [], [], 0
    for t, w in enumerate(work):
        f, r = divmod(w, cap)
        nu = f + (r > 0)
        first = slot if nu >= 2 else -1
        full += [(t, c * cap, (c + 1) * cap, -1 if first < 0 else first + c)
                 for c in range(f)]
        if r:
            rest.append((t, f * cap, w, -1 if first < 0 else first + f))
        if nu >= 2:
            merges.append((t, slot, nu))
            slot += nu
    rest.sort(key=lambda u: (u[1] - u[2], u[0]))
    return BwdPlan(cap, tuple(full + rest), tuple(merges), slot, walks, work)


def bwd_work_bytes(plan: BwdPlan, B: int, H: int, KV: int, Sq: int,
                   D: int) -> int:
    """Bytes of the backward's scratch, laid out as the kernel's ``layout``:
    lse2 and D rows padded to whole tiles (f32), the order (one int4 per
    unit and per merge), then the partials (f32 dK and dV of 64 keys per
    slot and (batch, KV head)), 256-byte aligned."""
    rows = B * H * -(-Sq // BWD_TILE) * BWD_TILE
    off_table = -(-8 * rows // 16) * 16
    off_part = -(-(off_table + 16 * (len(plan.units) + len(plan.merges))) // 256) * 256
    return off_part + B * KV * plan.partials * 2 * BWD_TILE * D * 4


def bwd_work_bytes_f32(B: int, H: int, Sq: int) -> int:
    """Bytes of the f32 backward's scratch: the D rows (B, H, Sq) f32,
    256-byte aligned."""
    return -(-4 * B * H * Sq // 256) * 256


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    """The SMs the plan spreads over: the card's, or on the meta device
    the H100's of ``hw``."""
    if device.type == "meta":
        return hw.H100.sms
    return _sm_count(device.index or 0)


def flash_attention_bwd_op(q, k, v, out, dout, lse, *, window: int = 0,
                           causal: bool = True):
    """(dq, dk, dv) of the flash forward, in the layouts and dtypes of q, k
    and v: q/out/dout (B, Sq, H, D), k/v (B, Sk, KV, D), lse (B, H, Sq)
    from ``flash_attention_fwd_lse``.

    A bf16 CUDA call plans the dK/dV units on the host
    (``plan_bwd_units`` with the head dim's ``bwd_slots_per_sm``, cached
    by shape), allocates one scratch of ``bwd_work_bytes`` and runs the
    backward's kernels on the current stream: D and the schedule, dQ,
    dK/dV, and the merge of split tiles.  An f32 call allocates the D rows
    (``bwd_work_bytes_f32``) and runs D, dQ and dK/dV on the CUDA cores.  It copies nothing to the card and does not wait for it, so it
    can be captured in a CUDA graph, and it bumps the backward's launch
    count once, whatever the number of kernels.  Meta tensors get the
    same checks and allocations, and the call is counted."""
    check_shapes(q, k, v, window, causal)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), dout.transpose(1, 2), lse, window=window,
            causal=causal)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    with common.card_checks(q):
        check_backward_operands(q)
        check_kernel_operands(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"{BWD_NAME}: out{tuple(out.shape)} / "
                         f"dout{tuple(dout.shape)} != q{tuple(q.shape)}")
    # the kernels read lse rows with plain loads: any Sq, no row alignment
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{BWD_NAME}: lse must be contiguous f32 "
                         f"{(B, H, Sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    # a no-op for autograd's gradient of the attention output, which comes
    # back contiguous in the training dtype; a broadcast cotangent is copied
    dout = dout.to(q.dtype).contiguous()
    with common.card_checks(q):
        for t in (out, dout):
            common.check_operand(BWD_NAME, t, q.device, q.dtype)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if q.dtype == torch.float32:
        cap, nbytes = 1, bwd_work_bytes_f32(B, H, Sq)
    else:
        plan = plan_bwd_units(B, KV, H // KV, Sq, Sk, int(window), bool(causal),
                              _sms(q.device), slots=bwd_slots_per_sm(D))
        cap, nbytes = plan.cap, bwd_work_bytes(plan, B, H, KV, Sq, D)
    work = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    if q.device.type == "meta":
        common.count_meta_call(BWD_NAME, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, D=D,
                               window=int(window), causal=bool(causal),
                               dtype=str(q.dtype), scratch=nbytes)
        return dq, dk, dv
    fn = common.load_function(BWD_NAME, "flash_attention_bwd", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Sk, D, int(window),
            int(causal), common.DTYPE_CODES[q.dtype], cap, nbytes,
            *_bhs_strides(q, k, v, out, dout, dq, dk, dv),
            common.current_stream(q.device))
    common.check(BWD_NAME, rc)
    common.count_launch(BWD_NAME)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient.  The forward keeps q, k, v, the
    output and each row's log-sum-exp; the backward recomputes the
    probabilities from them (``flash_attention_bwd_op``)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool):
        out, lse = flash_attention_fwd_lse(q, k, v, window=window,
                                           causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, dout, lse,
                                            window=ctx.window,
                                            causal=ctx.causal)
        return dq, dk, dv, None, None


def check_backward_operands(q: torch.Tensor) -> None:
    """What a CUDA call that needs a gradient takes: a dtype of
    ``BWD_DTYPES`` (bf16, the training dtype, or f32) and a head dim of
    ``BWD_HEAD_DIMS``."""
    if q.dtype not in BWD_DTYPES:
        raise RuntimeError(f"{BWD_NAME}: the backward kernels take bf16 and "
                           f"f32, got {q.dtype}")
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise RuntimeError(f"{BWD_NAME}: head_dim {q.shape[-1]} not in "
                           f"{BWD_HEAD_DIMS}")


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
