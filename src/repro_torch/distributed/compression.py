"""Gradient compression for the data-parallel all-reduce, the reference's
``distributed/compression.py`` in PyTorch.

int8 block-quantized gradients with error feedback: the quantization
residual is carried to the next step, so compression error doesn't bias
the descent direction.  The arithmetic is the reference's, bit for bit:
zero padding to whole blocks of BLOCK values, an f32 scale of
max|x| / 127 per block (1 where the block is all zeros), round half to
even and clip to +-127.  It runs in plain PyTorch on the gradients'
device, one leaf at a time, so that its temporaries stay the size of one
leaf.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q, scales): q is
    (blocks, BLOCK) int8, scales (blocks,) f32."""
    flat = x.to(torch.float32).reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    # 127 as a tensor on the device: CUDA multiplies by the reciprocal of a
    # host scalar divisor, which can differ from the quotient in its last bit
    scale = (blocks.abs().amax(dim=1, keepdim=True)
             / torch.tensor(127.0, device=blocks.device))
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(blocks / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int]) -> torch.Tensor:
    """The f32 values of ``quantize_int8``'s output, cut to ``shape``."""
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress_one(g: torch.Tensor, e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: (the quantized g + e in g's dtype, the new f32 error),
    the reference's ``one``."""
    target = g.to(torch.float32) + e
    q, s = quantize_int8(target)
    deq = dequantize_int8(q, s, g.shape)
    return deq.to(g.dtype), target - deq


def compress_tree(grads: Mapping[str, torch.Tensor],
                  error: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize grads + error leaf by leaf, by name; returns (the
    quantized gradients, the new error).

    The caller all-reduces the (q, scale) pairs over the data axis and
    dequantizes; here the lossy round trip is modelled locally.
    """
    sent, new_error = {}, {}
    for name, g in grads.items():
        sent[name], new_error[name] = compress_one(g, error[name])
    return sent, new_error


def init_error(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """f32 zeros beside each weight."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
