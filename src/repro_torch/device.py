"""Device selection for the port's entry points.

Entry points run on the card by default.  The CPU is taken only when the
caller names it (``device="cpu"``, as the tests do); with no CUDA device
and no explicit CPU request they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "explicitly to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def model_device(device="cuda") -> torch.device:
    """``resolve_device``, or the meta device (``device="meta"``), where a
    model's weights are shapes alone: placement tables and the dry-run's
    counts."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)
