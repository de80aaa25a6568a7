"""GB of KV cache that the active slots' tokens hold, mean over the
engine's batched decode steps in the window: the memory the traffic uses
of the pool the engine reserves (slots x max_len positions), beside the
run's ``memory_peak_bytes``.  None for a model with no KV cache."""


def read(record):
    m = record["model"]
    calls = [c for c in record.get("calls", []) if c["kind"] == "decode"]
    if m.get("attn_free") or not calls:
        return None
    per_token = 2 * m["num_layers"] * m["num_kv_heads"] * m["head_dim"] * record["dtype_bytes"]
    return per_token * sum(sum(c["lengths"]) for c in calls) / len(calls) / 1e9
