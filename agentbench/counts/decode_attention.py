"""``csrc/decode_attention.cu``: one query a row over its cache (the split
and merge kernels together), one launch per layer and decode call, bf16."""
NAMES = ("decode_split", "decode_merge", "decode_fwd")
BYTES = 2  # bf16 q, cache and output


def calls(call: dict, m: dict) -> list:
    if call["kind"] not in ("decode", "suffix") or m.get("attn_free"):
        return []
    shape = {"lengths": list(call["lengths"]), "H": m["num_heads"],
             "KV": m["num_kv_heads"], "D": m["head_dim"]}
    return [shape] * m["num_layers"]


def work(s: dict):
    """4 D operations per valid cache entry and head; q read and o written
    per row, each row's valid keys and values read, the lengths read."""
    B, H, KV, D = len(s["lengths"]), s["H"], s["KV"], s["D"]
    tokens = sum(s["lengths"])
    nbytes = BYTES * 2 * B * H * D + BYTES * 2 * tokens * KV * D + 4 * B
    return 4.0 * H * D * tokens, nbytes
