"""AdamW over a model's weights, the reference's ``training/optimizer.py``
in PyTorch.

bf16 weights, f32 first and second moments and an int32 step, all on the
weights' device.  ``apply_updates`` takes the reference's steps in f32:
linear warm-up of the learning rate, clipping by the global gradient norm,
bias correction and decoupled weight decay; each weight is written back in
its own dtype.  Unlike the reference, whose update returns new trees, the
port updates the weights and the moments in place, so that a step holds
no second copy of either.

A model sharded by ``distributed.sharding.shard_model`` takes the same
steps on DTensors: its moments are sharded over ``data`` too (ZeRO-1),
each data rank updates its slice of every weight (``zero_slice``) and
gathers the new weight over ``data`` (``zero_write``), and the global norm
counts every element once (``sum_over_model``).  A plain tensor passes
through those helpers unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (local, sum_over_model,
                                              zero_moment, zero_slice,
                                              zero_write)


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Dict[str, torch.Tensor]  # name -> f32, like the weight
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _zeros(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor):
        return zero_moment(p)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_state(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments in f32 beside each weight (with the ZeRO-1 placements
    of a DTensor weight), and step 0."""
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={n: _zeros(p) for n, p in params.items()},
        v={n: _zeros(p) for n, p in params.items()})


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-dim tensor
    on the tensors' device; no host sync).  A DTensor's local shard counts,
    summed over ``model`` where it is sharded over it, so every element
    counts once on every rank."""
    tensors = list(tensors)
    sq = torch.stack([local(t).float().square().sum() for t in tensors])
    return sum_over_model(sq, tensors).sum().sqrt()


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: AdamWState,
                  cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """One AdamW step of every weight in ``params`` by its gradient in
    ``grads`` (same names), in place; returns the state with the step
    advanced.  Every scalar stays on the device."""
    step = state.step + 1
    t = step.float()
    warm = torch.clamp(t / max(cfg.warmup_steps, 1), max=1.0)
    lr = cfg.lr * warm
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.tensor(cfg.b1, device=t.device) ** t
    bc2 = 1 - torch.tensor(cfg.b2, device=t.device) ** t
    for name, p in params.items():
        g = zero_slice(grads[name]).float() * scale
        m, v = local(state.m[name]), local(state.v[name])
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        p32 = zero_slice(p).float()
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps) + cfg.weight_decay * p32
        zero_write(p, p32 - lr * delta)
    return AdamWState(step=step, m=state.m, v=state.v)
