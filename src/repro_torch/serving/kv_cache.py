"""KV-cache data structures of the serving engine (PyTorch), counterparts
of ``repro.serving.kv_cache``.

* :class:`PagedKVCache` -- vLLM-style paged cache: a page pool per layer
  plus per-sequence block tables; pages are allocated and freed by a
  host-side free list.  ``gather_seq`` materialises a sequence's
  contiguous view.
* :class:`SlotKVCache` -- the contiguous per-slot cache of the engine's
  lockstep decode.

The tensors live on one device and are written in place (the reference
rebuilds its immutable arrays).  Under the "seq" layout of a sharded
dense decoder (``distributed.sharding.kv_layout``) a slot cache holds
this rank's block of every slot's positions, ``seq``: its writes and
copies take the part of a sequence that falls in the block.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import KVCache, SeqShard


@dataclass
class PagedKVCache:
    """Page pool: k/v are (L, num_pages, KV, page, D)."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int
    free_pages: List[int] = field(default_factory=list)
    tables: Dict[int, List[int]] = field(default_factory=dict)  # seq -> pages
    lengths: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def create(cls, layers: int, num_pages: int, kv_heads: int,
               page_size: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        shape = (layers, num_pages, kv_heads, page_size, head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   page_size=page_size, free_pages=list(range(num_pages)))

    # -- host-side allocator --
    def alloc_seq(self, seq_id: int) -> None:
        self.tables[seq_id] = []
        self.lengths[seq_id] = 0

    def free_seq(self, seq_id: int) -> None:
        self.free_pages.extend(self.tables.pop(seq_id, []))
        self.lengths.pop(seq_id, None)

    def _ensure_capacity(self, seq_id: int, new_len: int) -> None:
        need = (new_len + self.page_size - 1) // self.page_size
        table = self.tables[seq_id]
        while len(table) < need:
            if not self.free_pages:
                raise MemoryError("KV page pool exhausted")
            table.append(self.free_pages.pop())

    # -- device-side writes --
    def append(self, seq_id: int, k_new: torch.Tensor,
               v_new: torch.Tensor) -> None:
        """k_new/v_new: (L, KV, T, D), T new tokens of one sequence.  Each
        page the tokens touch takes one in-place write of its run of them
        (T / page_size writes, not T)."""
        T = k_new.shape[2]
        start = self.lengths[seq_id]
        self._ensure_capacity(seq_id, start + T)
        table = self.tables[seq_id]
        ps = self.page_size
        t = 0
        while t < T:
            pos = start + t
            page, off = table[pos // ps], pos % ps
            n = min(ps - off, T - t)
            self.k[:, page, :, off:off + n] = k_new[:, :, t:t + n]
            self.v[:, page, :, off:off + n] = v_new[:, :, t:t + n]
            t += n
        self.lengths[seq_id] = start + T

    def gather_seq(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Contiguous (L, KV, len_padded, D) copies of a sequence's pages."""
        table = torch.as_tensor(self.tables[seq_id], dtype=torch.long,
                                device=self.k.device)
        out = []
        for pool in (self.k, self.v):
            pages = pool.index_select(1, table)  # (L, n_pages, KV, ps, D)
            L, n, KV, ps, D = pages.shape
            out.append(pages.transpose(1, 2).reshape(L, KV, n * ps, D))
        return out[0], out[1], self.lengths[seq_id]


@dataclass
class SlotKVCache:
    """Contiguous (L, slots, KV, positions, D) cache with per-slot lengths
    (the whole sequence's, on every rank).  ``seq``: this rank's block of
    the positions under the "seq" layout, or None where it holds all of
    them."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: np.ndarray  # host-side (slots,) int32
    free_slots: List[int] = field(default_factory=list)
    seq: Optional[SeqShard] = None

    @classmethod
    def create(cls, layers: int, slots: int, kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16,
               device="cuda") -> "SlotKVCache":
        shape = (layers, slots, kv_heads, max_len, head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=np.zeros(slots, np.int32),
                   free_slots=list(range(slots)))

    @property
    def cache(self) -> KVCache:
        """The (k, v) pair that the model's ``decode_step`` takes."""
        return KVCache(self.k, self.v, self.seq)

    def alloc(self) -> int:
        return self.free_slots.pop()

    def free(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.free_slots.append(slot)

    def write_prefill(self, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, length: int) -> None:
        """k_new/v_new: (L, KV, S, D) from a prefill, written into ``slot``
        at positions 0..S-1 (of them, the ones in this rank's block, which
        may be none); the rest of the slot is left as it is."""
        if self.seq is not None:
            block = slice(self.seq.start, self.seq.start + self.seq.chunk)
            k_new, v_new = k_new[:, :, block], v_new[:, :, block]
        n = k_new.shape[2]
        self.k[:, slot, :, :n] = k_new
        self.v[:, slot, :, :n] = v_new
        self.lengths[slot] = length

    def copy_prefix(self, src_slot: int, dst_slot: int, length: int) -> None:
        """Prefix-cache hit: duplicate the first ``length`` tokens (of them,
        the ones in this rank's block)."""
        n = length if self.seq is None else min(max(length - self.seq.start, 0),
                                                self.seq.chunk)
        self.k[:, dst_slot, :, :n] = self.k[:, src_slot, :, :n]
        self.v[:, dst_slot, :, :n] = self.v[:, src_slot, :, :n]
        self.lengths[dst_slot] = length
