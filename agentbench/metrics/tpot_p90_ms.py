"""The 90th percentile, over every call completed inside the window with
two tokens or more, of (last token time - first token time) / (tokens -
1) (ms)."""
from agentbench.metrics import percentile


def read(record):
    p = percentile(record["window"]["tpot_s"], 90)
    return None if p is None else 1e3 * p
