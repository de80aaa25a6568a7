"""``csrc/wkv6_chunk.cu``: the chunked WKV6 on the tensor cores, for a bf16
prefill of S >= 2 tokens at D = 64, one launch per layer."""
NAMES = ("wkv6_chunk",)


def calls(call: dict, m: dict) -> list:
    if call["kind"] != "prefill" or not m.get("attn_free") or call["S"] < 2:
        return []
    shape = {"B": 1, "S": call["S"], "H": m["num_heads"], "D": m["head_dim"]}
    return [shape] * m["num_layers"]


def work(s: dict):
    """Per (b, h) and chunk of 64 tokens, the inter-chunk (C x D x D)
    product, the 6 off-diagonal and 10 diagonal-or-below (16 x 16 x D)
    sub-chunk products and the (D x C x D) state update, each once; r, k,
    v read and o written in bf16, logw read in f32, u read, the f32 state
    read and written."""
    B, S, H, D = s["B"], s["S"], s["H"], s["D"]
    C, SUB = 64, 16
    chunks = B * H * S / C
    ops = 2.0 * D * (C * D + 6 * SUB * SUB + 10 * SUB * SUB + C * D) * chunks
    nbytes = 4 * 2 * B * H * S * D + 4 * B * H * S * D + 4 * H * D + 2 * 4 * B * H * D * D
    return ops, nbytes
