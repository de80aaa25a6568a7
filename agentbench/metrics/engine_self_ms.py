"""Host ms per engine step outside the model's calls (admission, the
prefix cache, the KV slots, sampling), where the profiler is off.  In a
traced run each model call ends in a synchronisation, so this holds no
wait for the device."""
from agentbench.metrics import outside_profile


def read(record):
    steps = outside_profile(record.get("steps", []))
    if not steps:
        return None
    return 1e3 * sum(s["s"] - s["model_s"] for s in steps) / len(steps)
