"""``csrc/wkv6_scan.cu``: the token-by-token WKV6 on the CUDA cores; the
decode step of every row (idle rows too), and a prefill of one token."""
NAMES = ("wkv6_fwd",)
PEAK = "f32"  # the scan's operations run on the CUDA cores in f32


def calls(call: dict, m: dict) -> list:
    if not m.get("attn_free"):
        return []
    if call["kind"] in ("decode", "suffix"):
        shape = {"B": call["rows"], "S": 1, "H": m["num_heads"], "D": m["head_dim"]}
    elif call["S"] == 1:
        shape = {"B": 1, "S": 1, "H": m["num_heads"], "D": m["head_dim"]}
    else:
        return []
    return [shape] * m["num_layers"]


def work(s: dict):
    """~5 D^2 f32 operations per token and head (r S, and S w + k^T v);
    the same bytes as the chunked form's."""
    B, S, H, D = s["B"], s["S"], s["H"], s["D"]
    nbytes = 4 * 2 * B * H * S * D + 4 * B * H * S * D + 4 * H * D + 2 * 4 * B * H * D * D
    return 5.0 * B * H * S * D * D, nbytes
