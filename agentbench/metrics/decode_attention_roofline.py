"""Percent of decode_attention's roofline over the profiled stretch: its calls'
bounds (``agentbench/counts/decode_attention.py``) over its entries' device time."""
from agentbench.metrics import roofline


def read(record):
    return roofline(record, "decode_attention")
