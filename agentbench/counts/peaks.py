"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)."""
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, flops: float = BF16_FLOPS) -> float:
    """The least seconds the card can take: operations at the peak rate or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / flops, nbytes / HBM_BYTES)
