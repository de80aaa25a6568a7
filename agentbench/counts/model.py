"""Model FLOPs of a model call: 2 per weight multiplied per token (an MoE
layer's router and its K routed experts), 4 D per attended (query, key)
pair and head, rwkv6's WKV6 4 D^2 per token, head and layer (r S and the
state update), and the LM head over the tokens whose logits are taken:
a prefill's last token, every active row of a decode.  Idle rows are not
counted: their work is thrown away."""


def _layer_weights(m: dict) -> int:
    d, f = m["d_model"], m["d_ff"]
    if m.get("attn_free"):  # rwkv6: r k v g o, both LoRAs, channel mix
        return 5 * d * d + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d + 2 * d * f + d * d
    qd = m["num_heads"] * m["head_dim"]
    kvd = m["num_kv_heads"] * m["head_dim"]
    attn = 2 * d * qd + 2 * d * kvd
    mats = 3 if m["activation"] in ("swiglu", "geglu") else 2
    if m.get("num_experts"):
        return attn + d * m["num_experts"] + m["experts_per_token"] * mats * d * f
    return attn + mats * d * f


def flops(call: dict, m: dict) -> float:
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, D = m["num_heads"], m["head_dim"]
    if call["kind"] == "prefill":
        tokens, heads_out = call["S"], 1
        pairs = call["S"] * (call["S"] + 1) // 2
    else:
        active = [n for n in call["lengths"] if n > 0]
        tokens = heads_out = len(active)
        pairs = sum(active)
    total = 2.0 * tokens * L * _layer_weights(m) + 2.0 * heads_out * d * V
    if m.get("attn_free"):
        total += 4.0 * D * D * H * L * tokens
    else:
        total += 4.0 * D * H * L * pairs
    return total
