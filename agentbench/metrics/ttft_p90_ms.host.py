"""The 90th percentile, over every call whose first token fell inside the
window, of its first token's time less its send time (ms), read in a
traced run.  A first token counts as seen at the end of the engine step
that admitted the call.  Under closed-loop clients the first tokens wait
behind prefills that run one after another, and the tail of some 100 to
250 calls swings by a tenth between runs of one code, too wide for a
bound: so it is a per-layer reading of the engine's queue."""
from agentbench.metrics import percentile


def read(record):
    p = percentile(record["window"]["ttft_s"], 90)
    return None if p is None else 1e3 * p
