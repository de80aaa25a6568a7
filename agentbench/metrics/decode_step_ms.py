"""Mean ms of the model's batched decode step over all slots (CUDA events
around each call, ending in a synchronisation), where the profiler is
off; a prefix hit's one-row suffix calls are not counted."""
from agentbench.metrics import outside_profile


def read(record):
    calls = [c for c in outside_profile(record.get("calls", [])) if c["kind"] == "decode"]
    return sum(c["ms"] for c in calls) / len(calls) if calls else None
