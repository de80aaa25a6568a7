"""Serving engine for the port's models, counterpart of ``repro.serving.engine``.

Slot-based continuous batching on a :class:`DenseLM`, an :class:`RWKVLM`
or a :class:`HymbaLM` (an encoder, the VLM and the enc-dec are refused:
the first has no decode step, the other two prefill with image or audio
inputs, which the reference's engine does not pass either):

  * prefill admits a waiting request into a free slot (logits for its
    last token seed decoding); for a dense KV cache, exact-prefix cache
    reuse via :class:`PrefixCache` + :meth:`SlotKVCache.copy_prefix` -- the
    longest cached prefix of the prompt is copied from the slot that
    already holds its KV and only the suffix is computed.  A recurrent
    state (rwkv) has no per-token prefix to copy, and neither has hymba's
    cache, whose Mamba states hold the whole prompt (beside full-layer KV
    and a window ring); so, as in the reference, they get no prefix cache
    and ``cached_tokens`` stays 0, and admission writes every leaf of the
    slot's cache;
  * decode runs one step for all slots with per-slot positions (ragged
    continuous batching);
  * greedy sampling; requests complete when their token budget is spent.

The cache tensors are updated in place.  A sharded dense decoder whose
cache lays its positions over ``model`` (the "seq" layout) writes only
this rank's block of the slot's positions (``SlotKVCache.write_prefill``
of the prompt's KV), copies only the block's part of a cached prefix,
and decodes through the model's ``KVCache``, which carries the block; a
sharded hymba's ``HymbaCache`` carries its blocks of the full layers'
positions and of the rings' indices, and admission writes those blocks
of the prompt's KV (``_merge_slot``).

One deliberate divergence from the reference: the reference decodes
idle slots too, as token 0 at position 0, and so overwrites position 0
of every idle slot's KV, which the prefix cache may still point at for a
finished sequence.  Here an idle slot decodes at position -1, which
writes no KV and attends over nothing; its logits are thrown away as in
the reference.  An idle slot
of a recurrent state is decoded as in the reference (token 0; the model
ignores positions), which changes that slot's state, but admission
overwrites all of it.  The same holds for hymba's Mamba states: an idle
slot writes no KV, but its conv and ssm states drift until admission.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import KVCache
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hymba import HymbaCache
from repro_torch.models.transformer import EncoderLM
from repro_torch.models.vision import VisionLM
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.serving.prefix_cache import PrefixCache


@dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    cached_tokens: int = 0  # prompt tokens served from the prefix cache


class ServingEngine:
    def __init__(self, model, *, device="cuda", slots: int = 8,
                 max_len: int = 256, prefix_caching: bool = True,
                 min_prefix: int = 8):
        if isinstance(model, EncoderLM):
            raise ValueError(f"{model.cfg.name} is an encoder: it has no decode "
                             "step or cache to serve from; call its prefill")
        if isinstance(model, (VisionLM, EncDecLM)):
            # the reference's engine prefills {"tokens"} alone, as this one
            raise ValueError(f"{model.cfg.name} prefills with per-request "
                             "image or audio inputs, which the engine does "
                             "not take; use launch.serve_model.generate")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.max_len = max_len
        self.min_prefix = min_prefix
        self.lengths = np.zeros(slots, np.int32)
        cache = model.init_cache(slots, max_len)
        # prefix reuse needs the positional (k, v) layout; a recurrent
        # state or hymba's cache (a dict of (L, slots, ...) leaves) has no
        # prefix to copy
        if isinstance(cache, tuple):
            self.kv = SlotKVCache(k=cache[0], v=cache[1], lengths=self.lengths,
                                  seq=getattr(cache, "seq", None))
            self.state = None
        else:
            self.kv, self.state = None, cache
            prefix_caching = False
        # every live trie node is a token whose KV some slot holds, so
        # slots * max_len entries never evict a live prefix (the
        # reference's fixed 1024 would drop any prefix of a longer prompt)
        self.prefix_cache = (PrefixCache(max_entries=slots * max_len)
                             if prefix_caching else None)
        self.active: Dict[int, ServeRequest] = {}  # slot -> request
        self.waiting: List[ServeRequest] = []
        self.free_slots = list(range(slots))
        self.stats = {"prefill_tokens": 0, "cached_tokens": 0,
                      "decode_steps": 0}

    @property
    def cache(self):
        """The ``KVCache`` (k, v), each (L, slots, KV, positions, D), or the
        dict of (L, slots, ...) leaves of a recurrent state or hymba's
        cache."""
        return self.kv.cache if self.state is None else self.state

    def submit(self, req: ServeRequest) -> None:
        self.waiting.append(req)

    # -- engine iterations --
    def step(self) -> List[ServeRequest]:
        """One engine iteration; returns requests completed this step."""
        self._admit()
        return self._decode_step()

    def run_to_completion(self, max_steps: int = 10_000) -> List[ServeRequest]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.waiting and not self.active:
                break
        return out

    def _admit(self) -> None:
        while self.waiting and self.free_slots:
            req = self.waiting.pop(0)
            slot = self.free_slots.pop()
            req.slot = slot
            plen = len(req.prompt)
            tokens = [int(t) for t in req.prompt]

            matched, src = 0, None
            if self.prefix_cache is not None:
                matched, src = self.prefix_cache.longest_prefix(tokens)
                matched = min(matched, plen - 1)
                if matched < self.min_prefix:
                    matched, src = 0, None
            # the slot's old KV is about to be overwritten: every cache
            # entry still pointing at it is stale from here on (the lookup
            # above may legitimately have matched it -- the bytes are still
            # in place until we write)
            if self.prefix_cache is not None:
                self.prefix_cache.invalidate_slot(slot)

            if src is not None:
                first_tok = self._prefill_from_prefix(slot, src, matched,
                                                      tokens)
                req.cached_tokens = matched
                self.stats["cached_tokens"] += matched
                self.stats["prefill_tokens"] += plen - matched
            else:
                prompt = torch.as_tensor(np.asarray(req.prompt),
                                         device=self.device)[None]
                logits, cache = self.model.prefill(prompt)
                if self.kv is not None:
                    self.kv.write_prefill(slot, cache[0][:, 0], cache[1][:, 0], plen)
                else:
                    _merge_slot(self.state, cache, slot)
                self.stats["prefill_tokens"] += plen
                first_tok = int(torch.argmax(logits[0]))
            self.lengths[slot] = plen
            if self.prefix_cache is not None:
                self.prefix_cache.insert(tokens, slot)
            req.generated.append(first_tok)
            self.active[slot] = req

    def _prefill_from_prefix(self, slot: int, src: int, matched: int,
                             tokens: List[int]) -> int:
        """Prefix-cache hit: copy the shared KV out of ``src`` and run only
        the suffix through the model, one token at a time, on a batch-1
        view of the slot; returns the first sampled token.

        ``cache[:, slot:slot+1]`` is a view, so each decode step writes the
        suffix's KV straight into the slot (the reference copies the slot
        out and back)."""
        self.kv.copy_prefix(src, slot, matched)
        view = self.kv.cache.rows(slice(slot, slot + 1))
        logits = None
        for pos in range(matched, len(tokens)):
            logits, _ = self.model.decode_step(view, [tokens[pos]], [pos])
        return int(torch.argmax(logits[0]))

    def _decode_step(self) -> List[ServeRequest]:
        if not self.active:
            return []
        slots = sorted(self.active)
        tokens = np.zeros(self.slots, np.int64)
        pos = np.full(self.slots, -1, np.int64)  # idle slots: no KV write
        for s in slots:
            tokens[s] = self.active[s].generated[-1]
            pos[s] = self.lengths[s]
        logits, _ = self.model.decode_step(self.cache, tokens, pos)
        self.stats["decode_steps"] += 1
        completed = []
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in slots:
            req = self.active[s]
            self.lengths[s] += 1
            req.generated.append(int(toks[s]))
            if (len(req.generated) >= req.max_new_tokens
                    or self.lengths[s] >= self.max_len - 1):
                req.done = True
                completed.append(req)
                del self.active[s]
                # the slot's KV (prompt + all but the final generated
                # token) stays valid until the slot is reused; register
                # the full sequence for exact-prefix reuse
                if self.prefix_cache is not None:
                    seq = [int(t) for t in req.prompt] + req.generated[:-1]
                    self.prefix_cache.insert(seq[:self.max_len - 1], s)
                self.lengths[s] = 0
                self.free_slots.append(s)
        return completed


def _merge_slot(cache, prefill_cache, slot: int) -> None:
    """Write one sequence's prefill cache into slot ``slot``, in place.

    Leaf by leaf (the (k, v) pair of a dense cache, the dict of a recurrent
    state or of hymba's cache), the prefill's (L, 1, ...) leaf goes to
    ``[:, slot]``, cast to the cache's dtype.  A leaf as long as the slot's
    is written whole: a recurrent state, hymba's conv and ssm states, and
    its window ring once the prompt fills it (the prefill placed position
    p at p % W).  A shorter leaf is a KV of (L, 1, KV, S, D): it fills
    positions 0..S-1 (ring indices, for a ring of S < W) and the rest of
    the slot is zeroed, as the reference's padded update leaves it.  Into
    a ``KVCache`` or a ``HymbaCache`` whose KV leaves hold a block of the
    positions or ring indices (the "seq" layout), the prompt's KV of every
    position or index gives the block's part."""
    if isinstance(cache, HymbaCache):
        pairs = [(big, _block(prefill_cache[name], cache.block(name)))
                 for name, big in cache.items()]
    elif isinstance(cache, dict):
        pairs = [(big, prefill_cache[name]) for name, big in cache.items()]
    elif isinstance(cache, KVCache):
        pairs = [(big, _block(small, cache.seq)) for big, small in zip(cache, prefill_cache)]
    else:
        pairs = zip(cache, prefill_cache)
    for big, small in pairs:
        small, dst = small[:, 0], big[:, slot]
        if small.shape == dst.shape:
            dst.copy_(small)
            continue
        S = small.shape[2]
        dst[:, :, :S] = small
        dst[:, :, S:] = 0


def _block(kv: torch.Tensor, seq) -> torch.Tensor:
    """The part of a prompt's (L, 1, KV, S, D) KV that falls in the block
    ``seq`` of the positions (all of it where None)."""
    return kv if seq is None else kv[:, :, :, seq.start:seq.start + seq.chunk]
