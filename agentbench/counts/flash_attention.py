"""``csrc/flash_attention.cu``: causal prefill attention, one launch per
layer and prefill of B = 1 prompt of S tokens, bf16."""
NAMES = ("flash_fwd",)
BYTES = 2  # bf16


def calls(call: dict, m: dict) -> list:
    if call["kind"] != "prefill" or m.get("attn_free"):
        return []
    shape = {"B": 1, "S": call["S"], "H": m["num_heads"], "KV": m["num_kv_heads"],
             "D": m["head_dim"]}
    return [shape] * m["num_layers"]


def work(s: dict):
    """4 D operations per unmasked (query, key) pair and head (S (S + 1) / 2
    pairs); q read and o written over S rows, k and v read."""
    B, S, H, KV, D = s["B"], s["S"], s["H"], s["KV"], s["D"]
    pairs = S * (S + 1) // 2
    return 4.0 * D * pairs * H * B, BYTES * (2 * B * S * H * D + 2 * B * S * KV * D)
