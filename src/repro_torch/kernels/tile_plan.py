"""The Hopper tile plan of the port's flash attention kernel.

It states what ``csrc/flash_attention.cu`` launches for a call of
``(batch, heads, seq, head_dim)`` on a card of ``sms`` streaming
multiprocessors, and takes the place of the reference's TPU tile autotuner
(``repro.kernels.autotune``) in the profiler's ``TPProfile.block_plan``.
Nothing here is searched: the kernel's tiles are fixed per head dim, and
only the query rows per block follow the call's size.

* bf16 (the tensor-core kernel): one or two consumer warpgroups of 64
  query rows each (``pick_warpgroups``), kv tiles of ``BKV`` rows (128,
  64 at D = 256), a ring of ``STAGES`` kv tiles and the dynamic shared
  memory ``SMEM`` of the kernel's ``Cfg``;
* f32 (the CUDA-core kernel): 64 query rows (32 at D = 256), kv tiles of
  32 rows, one stage, shared memory from its ``smem_floats``.

The grid is ``ceil(seq / rows) x heads x batch`` blocks.  The kernel
exports the same numbers as ``flash_attention_plan``, from the same
constants and the same warpgroup choice, and ``chip_smoke.py`` holds this
module against it on the card (``ops.flash_attention_plan``).

Host code: it imports nothing of torch and reads no device.
"""
from __future__ import annotations

from dataclasses import dataclass

HEAD_DIMS = (32, 64, 128, 256)
# opt-in dynamic shared memory of one block on sm_90 (227 KiB)
SMEM_PER_BLOCK = 232448
# the bf16 kernel's layout (csrc/flash_attention.cu, tc::Cfg): boxes of
# 64-element (128-byte) rows, an mbarrier area and alignment slack
_BOX_ROW_BYTES = 128
_BARRIER_BYTES = 128
_ALIGN_SLACK = 1024
_MAX_STAGES = 3


@dataclass(frozen=True)
class TilePlan:
    """What one flash attention call launches."""

    warpgroups: int  # consumer warpgroups per block; 0 = the CUDA cores
    rows: int  # query rows per block
    block_kv: int  # kv rows per tile
    stages: int  # kv tiles in flight in the ring
    smem_bytes: int  # dynamic shared memory per block
    blocks: int  # blocks of the grid
    waves: int  # ceil(blocks / sms): waves at one block per SM

    def kernel_numbers(self) -> tuple:
        """The five numbers the kernel's ``flash_attention_plan`` fills."""
        return (self.warpgroups, self.rows, self.block_kv, self.stages,
                self.smem_bytes)


def pick_warpgroups(batch: int, heads: int, seq: int, head_dim: int,
                    sms: int) -> int:
    """Two consumer warpgroups (128 query rows) while that still puts at
    least one block on each SM, else one (64 rows); D = 256 always one."""
    tiles_128 = batch * heads * (-(-seq // 128))
    return 2 if head_dim <= 128 and tiles_128 >= sms else 1


def _bf16_tiles(batch, heads, seq, head_dim, sms):
    nwg = pick_warpgroups(batch, heads, seq, head_dim, sms)
    bkv = 64 if head_dim == 256 else 128
    dc = max(head_dim, 64) // 64  # 64-column boxes per row (D = 32 pads)
    q_bytes = nwg * dc * 64 * _BOX_ROW_BYTES
    kv_tile = dc * bkv * _BOX_ROW_BYTES
    budget = SMEM_PER_BLOCK - _ALIGN_SLACK - _BARRIER_BYTES
    stages = min((budget - q_bytes) // (2 * kv_tile), _MAX_STAGES)
    smem = q_bytes + 2 * stages * kv_tile + _BARRIER_BYTES + _ALIGN_SLACK
    return nwg, nwg * 64, bkv, stages, smem


def _f32_tiles(head_dim):
    bq, bkv = (32 if head_dim == 256 else 64), 32
    floats = (bq * (head_dim + 4) + bkv * (head_dim + 4) + bkv * head_dim
              + bq * (bkv + 1))
    return 0, bq, bkv, 1, 4 * floats


def tile_plan(batch: int, heads: int, seq: int, head_dim: int, sms: int,
              dtype: str = "bfloat16") -> TilePlan:
    """The tiles the flash kernel launches for q of (batch, seq, heads,
    head_dim) in ``dtype`` ("bfloat16" or "float32") on ``sms`` SMs."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    if min(batch, heads, seq, sms) < 1:
        raise ValueError("tile_plan: batch, heads, seq and sms must be >= 1")
    if dtype == "bfloat16":
        nwg, rows, bkv, stages, smem = _bf16_tiles(batch, heads, seq,
                                                   head_dim, sms)
    elif dtype == "float32":
        nwg, rows, bkv, stages, smem = _f32_tiles(head_dim)
    else:
        raise ValueError(f"flash_attention: unsupported dtype {dtype!r}")
    blocks = -(-seq // rows) * heads * batch
    return TilePlan(warpgroups=nwg, rows=rows, block_kv=bkv, stages=stages,
                    smem_bytes=smem, blocks=blocks, waves=-(-blocks // sms))
