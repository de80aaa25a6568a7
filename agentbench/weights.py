"""Seeded weights, made on the device in a few large calls.

A family's reference (``agentbench/reference/<family>.py``) lists the
leaves it needs as ``Leaf`` entries: name, shape, dtype and the rule that
draws it.  ``make`` draws one flat buffer per dtype with a single
``torch.randn`` call from a generator seeded with the run's seed, then
shapes each leaf as a view of its buffer and scales or shifts it in place.
The same seed on the same device gives the same values, so the reference
draws the weights again after the program is freed, and never reads the
program's copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    """One weight: ``value = mean + std * N(0, 1)``, plus, with ``ramp``,
    a linear ramp over the last dim from ``ramp[0]`` to ``ramp[1]``."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float
    mean: float = 0.0
    ramp: Tuple[float, float] | None = None

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make(leaves: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves' tensors, views of one buffer per dtype, drawn from
    ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    by_dtype: Dict[torch.dtype, List[Leaf]] = {}
    for leaf in leaves:
        by_dtype.setdefault(leaf.dtype, []).append(leaf)
    out: Dict[str, torch.Tensor] = {}
    # a fixed order of dtypes, so that the generator's stream is the same
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.randn(sum(l.numel for l in group), generator=gen,
                           device=device, dtype=dtype)
        at = 0
        for leaf in group:
            t = flat[at:at + leaf.numel].view(leaf.shape)
            at += leaf.numel
            t.mul_(leaf.std)
            if leaf.mean:
                t.add_(leaf.mean)
            if leaf.ramp is not None:
                n = leaf.shape[-1]
                lo, hi = leaf.ramp
                t.add_(torch.linspace(lo, hi, n, device=device, dtype=torch.float32)
                       .to(dtype))
            out[leaf.name] = t
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Make every parameter of ``model`` the tensor of the same name: its
    storage becomes the buffer's (no copy).  Every parameter must be named,
    with its shape and dtype, and every weight must be used."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise ValueError(f"weights do not match the model: missing {missing[:5]}, "
                         f"unused {extra[:5]}")
    for name, p in params.items():
        w = weights[name]
        if w.shape != p.shape or w.dtype != p.dtype or w.device != p.device:
            raise ValueError(f"{name}: model {tuple(p.shape)} {p.dtype} {p.device}, "
                             f"weights {tuple(w.shape)} {w.dtype} {w.device}")
        p.data = w
