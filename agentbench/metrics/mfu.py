"""Percent of the card's bf16 peak that the model's FLOPs (``counts/model.py``)
of every prefill and decode call in the profiled stretch would take over
the stretch's length."""
from agentbench.counts.model import flops
from agentbench.counts.peaks import BF16_FLOPS


def read(record):
    prof = record.get("profile")
    calls = [c for c in record.get("calls", []) if c.get("in_profile")]
    if not prof or not calls:
        return None
    total = sum(flops(c, record["model"]) for c in calls)
    return 100.0 * total / (prof["window_s"] * BF16_FLOPS)
