"""ms of the model's prefill calls (CUDA events around each, ending in a
synchronisation) per thousand prompt tokens, where the profiler is off."""
from agentbench.metrics import outside_profile


def read(record):
    calls = [c for c in outside_profile(record.get("calls", [])) if c["kind"] == "prefill"]
    tokens = sum(c["S"] for c in calls)
    return 1e3 * sum(c["ms"] for c in calls) / tokens if tokens else None
