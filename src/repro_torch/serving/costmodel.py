"""Analytical step-cost model for LLM serving on the chip classes of
:mod:`repro_torch.hw`: NVIDIA H100 GPUs (the default) and the TPU classes.

One implementation shared by (a) the discrete-event cluster simulator that
the Scepsy profiler replays traces through, and (b) the §Roofline report —
so scheduling decisions and the roofline are mutually consistent
(DESIGN.md decision 6).

Every step time is the classic three-term roofline:

    t = max(FLOPs / (chips·peak·eff), bytes / (chips·bw·eff)) + t_collective

with TP collectives modeled explicitly (2 all-reduces per layer, ring
over the `model` axis inside one high-bandwidth domain: ICI on a TPU,
NVLink on an H100 host).

Every public cost function takes a keyword-only ``chip`` — a
:class:`repro_torch.hw.ChipClass` supplying the roofline constants and
efficiency knobs.  ``chip=None`` means ``hw.DEFAULT_CHIP_CLASS``, which
in the port is the H100 (the reference's default is its v5e-class part);
pass ``chip=hw.V5E`` for the reference's default numbers bit-for-bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch import hw
from repro_torch.configs.base import ArchConfig
from repro_torch.hw import ChipClass

BYTES_PER_PARAM = 2  # bf16 weights
KV_BYTES = 2  # bf16 cache


@dataclass(frozen=True)
class StepCost:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def total(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


# Per-config derived constants, memoized by object identity (hashing a
# ~30-field frozen dataclass per call is slower than the loops it would
# replace; the entry holds a strong ref to cfg so its id can't be
# recycled).  The model zoo is small, so the cache never grows large.
#
# The closed forms below are BIT-EXACT equivalents of the original
# per-layer accumulation loops: every per-layer term is an
# integer-valued float, so as long as the totals stay below 2**53 (they
# do by ~9 orders of magnitude for real configs) iterated addition and
# one multiplication produce the identical float.
_cfg_cache: dict = {}


def _cfg_consts(cfg: ArchConfig) -> tuple:
    """(cfg, active_params, params, n_full_attn_layers)"""
    entry = _cfg_cache.get(id(cfg))
    if entry is None:
        n_full = (sum(1 for layer in cfg.full_attn_layers
                      if 0 <= layer < cfg.num_layers)
                  if (cfg.sliding_window and cfg.full_attn_layers)
                  else cfg.num_layers)
        entry = (cfg, cfg.active_param_count(), cfg.param_count(), n_full)
        _cfg_cache[id(cfg)] = entry
    return entry


def _span_sum(cfg: ArchConfig, n_full: int, context: int) -> float:
    """Sum over layers of each layer's attention span at ``context``."""
    if cfg.sliding_window and cfg.full_attn_layers:
        return (n_full * context
                + (cfg.num_layers - n_full) * min(context,
                                                  cfg.sliding_window))
    return cfg.num_layers * context


def flops_per_token(cfg: ArchConfig, context: int) -> float:
    """Forward FLOPs for one token at the given attention context length."""
    _, active_params, _, n_full = _cfg_consts(cfg)
    base = 2.0 * active_params
    if cfg.attn_free:
        # WKV state update+readout: ~4*D ops per channel per token
        return base + 4.0 * cfg.num_layers * cfg.d_model * cfg.head_dim
    attn = 4.0 * cfg.num_heads * cfg.head_dim * _span_sum(cfg, n_full,
                                                          context)
    if cfg.ssm_state and not cfg.attn_free:  # hymba mamba heads
        attn += 6.0 * cfg.num_layers * cfg.q_dim * cfg.ssm_state
    return base + attn


def kv_bytes_per_seq(cfg: ArchConfig, context: int) -> float:
    """KV-cache bytes held (and streamed per decode step) for one sequence."""
    if cfg.attn_free:
        return (cfg.num_layers * cfg.num_heads * cfg.head_dim ** 2 * 4
                + 2 * cfg.num_layers * cfg.d_model * KV_BYTES)
    _, _, _, n_full = _cfg_consts(cfg)
    per_layer = 2 * cfg.kv_dim * KV_BYTES
    total = float(per_layer) * _span_sum(cfg, n_full, context)
    if cfg.ssm_state and not cfg.attn_free:
        total += cfg.num_layers * cfg.q_dim * cfg.ssm_state * 4
    return total


def model_bytes(cfg: ArchConfig) -> float:
    return _cfg_consts(cfg)[2] * BYTES_PER_PARAM


def tp_collective_time(cfg: ArchConfig, tokens: int, tp: int, *,
                       chip: Optional[ChipClass] = None) -> float:
    """2 ring all-reduces of (tokens, d_model) bf16 per layer over TP."""
    if tp <= 1:
        return 0.0
    chip = chip or hw.DEFAULT_CHIP_CLASS
    payload = tokens * cfg.d_model * BYTES_PER_PARAM
    ring = 2.0 * (tp - 1) / tp * payload / chip.ici_link_bw
    n_coll = 2 * (cfg.num_layers + cfg.encoder_layers)
    return n_coll * (ring + chip.collective_latency)


def prefill_cost(cfg: ArchConfig, prompt_tokens: int, *, tp: int = 1,
                 fraction: float = 1.0, cached_tokens: int = 0,
                 chip: Optional[ChipClass] = None) -> StepCost:
    """Cost of prefilling one sequence (processed as one chunked pass)."""
    chip = chip or hw.DEFAULT_CHIP_CLASS
    new = max(prompt_tokens - cached_tokens, 1)
    # attention span grows with position; integrate: avg span ~ prompt/2
    flops = 0.0
    avg_ctx = cached_tokens + new / 2
    flops = new * flops_per_token(cfg, int(avg_ctx))
    compute = flops / (tp * fraction * chip.peak_flops_bf16
                       * chip.mxu_efficiency)
    # prefill is compute-bound; weight reads amortize over tokens
    bytes_ = model_bytes(cfg) / max(new / 256.0, 1.0)
    memory = bytes_ / (tp * fraction * chip.hbm_bw * chip.hbm_efficiency)
    coll = tp_collective_time(cfg, new, tp, chip=chip)
    return StepCost(compute, memory, coll)


def decode_step_cost(cfg: ArchConfig, batch: int, avg_context: int, *,
                     tp: int = 1, fraction: float = 1.0,
                     chip: Optional[ChipClass] = None) -> StepCost:
    """Cost of one engine iteration decoding ``batch`` sequences."""
    chip = chip or hw.DEFAULT_CHIP_CLASS
    batch = max(batch, 1)
    flops = batch * flops_per_token(cfg, avg_context)
    compute = flops / (tp * fraction * chip.peak_flops_bf16
                       * chip.mxu_efficiency)
    bytes_ = (model_bytes(cfg)
              + batch * kv_bytes_per_seq(cfg, avg_context))
    memory = bytes_ / (tp * fraction * chip.hbm_bw * chip.hbm_efficiency)
    coll = tp_collective_time(cfg, batch, tp, chip=chip)
    return StepCost(compute, memory, coll)


def max_batch_size(cfg: ArchConfig, avg_context: int, *, tp: int = 1,
                   fraction: float = 1.0, headroom: float = 0.9,
                   chip: Optional[ChipClass] = None) -> int:
    """KV-capacity-limited max concurrent sequences per replica."""
    chip = chip or hw.DEFAULT_CHIP_CLASS
    budget = tp * fraction * chip.hbm_bytes * headroom - model_bytes(cfg)
    if budget <= 0:
        return 0
    per_seq = kv_bytes_per_seq(cfg, avg_context)
    return max(int(budget / max(per_seq, 1.0)), 0)


def min_fraction_units(cfg: ArchConfig, spec, avg_context: int = 2048,
                       min_seqs: int = 1,
                       chip: Optional[ChipClass] = None) -> int:
    """Minimum GPU-fraction units to load params + a minimal KV cache
    (the scheduler's per-LLM lower bound, paper §5)."""
    chip = chip or hw.DEFAULT_CHIP_CLASS
    need = (model_bytes(cfg)
            + min_seqs * kv_bytes_per_seq(cfg, avg_context)) / 0.9
    units = math.ceil(need / chip.hbm_bytes * spec.fractions_per_chip)
    return max(units, 1)


def fits_on_class(cfg: ArchConfig, chip: ChipClass, *, max_tp: int = 1,
                  avg_context: int = 2048) -> bool:
    """Whether the model fits (params + one sequence's KV) on ``chip``
    at some TP degree up to ``max_tp``."""
    need = (model_bytes(cfg) + kv_bytes_per_seq(cfg, avg_context)) / 0.9
    return need <= max_tp * chip.hbm_bytes


def swap_cost(cfg: ArchConfig, *, chip: Optional[ChipClass] = None) -> float:
    """Model-swap (weight reload) time — Aegaeon baseline overhead."""
    chip = chip or hw.DEFAULT_CHIP_CLASS
    return model_bytes(cfg) / chip.host_to_hbm_bw
