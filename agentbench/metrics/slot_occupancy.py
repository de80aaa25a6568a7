"""Percent of the engine's slots that hold a request, over its batched
decode steps where the profiler is off."""
from agentbench.metrics import outside_profile


def read(record):
    calls = [c for c in outside_profile(record.get("calls", [])) if c["kind"] == "decode"]
    if not calls:
        return None
    return 100.0 * sum(sum(1 for n in c["lengths"] if n > 0) / c["rows"]
                       for c in calls) / len(calls)
