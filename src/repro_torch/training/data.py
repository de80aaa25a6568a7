"""Deterministic synthetic token pipeline.

Generates reproducible pseudo-corpus batches (Zipfian token draw with a
Markov flavor so the loss actually decreases) — sharded per data-parallel
host, seekable by step for fault-tolerant restart (the pipeline state IS
the step counter, so restoring a checkpoint restores the data stream).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Seekable, shardable token stream."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        assert cfg.global_batch % num_shards == 0
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given step (pure function of (step, shard, seed))."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 97 + self.shard)
        # Zipf-ish marginals, clipped into vocab
        raw = rng.zipf(c.zipf_a, size=(self.local_batch, c.seq_len + 1))
        tokens = np.minimum(raw, c.vocab_size - 1).astype(np.int32)
        # inject local structure: with p=0.35 repeat previous token + 1
        rep = rng.random((self.local_batch, c.seq_len + 1)) < 0.35
        shifted = np.roll(tokens, 1, axis=1) + 1
        tokens = np.where(rep, np.minimum(shifted, c.vocab_size - 1), tokens)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
