"""Percent of wkv6_chunk's roofline over the profiled stretch: its calls'
bounds (``agentbench/counts/wkv6_chunk.py``) over its entries' device time."""
from agentbench.metrics import roofline


def read(record):
    return roofline(record, "wkv6_chunk")
