"""Wrapper of the decode attention kernel, in the model's (B, H, D) layout.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor goes
to the kernel of ``csrc/decode_attention.cu``, or the wrapper raises.  With
q and the caches in bf16 that is the split-K kernel pair, planned on the
host by ``plan_splits``; otherwise the single-pass f32 kernel.  A meta
tensor (the dry-run) takes the card's checks and allocations, with
``hw.H100``'s SM count for the plan, launches nothing and reports the call
to the op counters; its lengths are not known there, so every row counts
its whole cache of ``Smax`` positions.

``return_lse`` adds each query's log-sum-exp to the result, in the same
launches, for a caller that merges partial outputs (a sharded decode
whose ranks hold blocks of a row's positions): the output is then f32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

NAME = "decode_attention"
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16
# cache rows per tile of the split kernel (16 per warp, 4 warps), and the
# blocks per SM the split plan aims for
SPLIT_TILE = 64
BLOCKS_PER_SM = 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_L] * 6 + [_P]


def plan_splits(batch_heads: int, smax: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of the split-K kernel: each of ``splits`` blocks per
    (sequence, kv head) covers ``chunk`` cache positions, a multiple of
    ``SPLIT_TILE``.  Planned from ``smax``, ``batch_heads`` = B * KV and
    the card's SM count ``sms`` alone (never from the device lengths, so no
    host sync), aiming at ``BLOCKS_PER_SM * sms`` blocks where ``smax``
    allows."""
    want = -(-BLOCKS_PER_SM * sms // max(batch_heads, 1))
    chunk = max(SPLIT_TILE, smax // want // SPLIT_TILE * SPLIT_TILE)
    return chunk, max(1, -(-smax // chunk))


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths, *,
                        return_lse: bool = False):
    """One query token per sequence over its cache.

    q: (B, H, D); caches: (B, KV, Smax, D); lengths: an int or a scalar or
    (B,) integer tensor, the number of valid cache positions of each row
    (clamped to [0, Smax] by the kernel).  The caches may be of another
    float type than q (the engine's cache is bf16 whatever the weights').
    Returns (B, H, D) in q's dtype; a row of length 0 is zeros.  With
    ``return_lse`` returns (out (B, H, D) f32, lse (B, H) f32): lse is the
    log-sum-exp of each query's scaled scores over its valid positions, in
    natural-log units, -inf for a row of length 0.  On the card it raises
    where an input requires grad (the kernel has no backward); on the CPU
    the plain version is an autograd op.
    """
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)}")
    B, H, D = q.shape
    KV, Smax = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % KV:
        raise ValueError(f"{NAME}: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)}")
    G = H // KV
    if q.device.type == "cpu":
        got = decode_attention_ref(q.reshape(B, KV, G, D), k_cache, v_cache,
                                   lengths, return_lse=return_lse)
        if return_lse:
            return got[0].reshape(B, H, D), got[1].reshape(B, H)
        return got.reshape(B, H, D)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    with common.card_checks(q):
        common.refuse_grad("decode_attention_op", q, k_cache, v_cache)
        for t in (q, k_cache):
            if t.dtype not in common.DTYPE_CODES:
                raise ValueError(f"{NAME}: unsupported dtype {t.dtype}")
        if D not in HEAD_DIMS:
            raise ValueError(f"{NAME}: head_dim {D} not in {HEAD_DIMS}")
        if G > MAX_GROUP:
            raise ValueError(f"{NAME}: group size {G} > {MAX_GROUP}")
        if not q.is_contiguous():
            raise ValueError(f"{NAME}: q must be contiguous")
        common.check_operand(NAME, q, q.device, q.dtype)
        for t in (k_cache, v_cache):
            common.check_operand(NAME, t, q.device, k_cache.dtype)
    lens = torch.as_tensor(lengths)
    if lens.dtype.is_floating_point or lens.ndim > 1 or lens.numel() not in (1, B):
        raise ValueError(f"{NAME}: lengths must be an integer scalar or (B,)")
    lens = lens.to(device=q.device, dtype=torch.int32).reshape(-1)
    lens = lens.expand(B).contiguous()
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    result = (out, lse) if return_lse else out
    if out.numel() == 0:
        return result
    chunk = splits = 0
    scratch = None
    if q.dtype == k_cache.dtype == torch.bfloat16:
        sms = (hw.H100.sms if q.device.type == "meta" else
               torch.cuda.get_device_properties(q.device).multi_processor_count)
        chunk, splits = plan_splits(B * KV, Smax, sms)
        # per (b, kv head, split, g): O[D] unnormalised, then (m, l)
        scratch = torch.empty(B * KV * splits * G * (D + 2),
                              dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        common.count_meta_call(NAME, B=B, H=H, KV=KV, D=D, Smax=Smax,
                               dtype=str(q.dtype),
                               cache_dtype=str(k_cache.dtype),
                               **({"lse": True} if return_lse else {}))
        return result
    fn = common.load_function(NAME, "decode_attention_fwd", _ARGTYPES)
    strides = [t.stride(i) for t in (k_cache, v_cache) for i in (0, 1, 2)]
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            scratch.data_ptr() if scratch is not None else None, B, KV, G,
            Smax, D, common.DTYPE_CODES[q.dtype],
            common.DTYPE_CODES[k_cache.dtype], chunk, splits, *strides,
            common.current_stream(q.device))
    common.check(NAME, rc)
    common.count_launch(NAME)
    return result
