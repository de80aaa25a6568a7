"""OLMoE-1B-7B (arXiv:2409.02060) as the repository's MoE decoder defines
it, in plain f32 PyTorch, layer by layer.

Per layer: pre-norm attention (RoPE, causal, multi-head, no biases), then
pre-norm routed experts: f32 router logits, softmax over the E experts,
the top K renormalised over themselves, each kept choice's SwiGLU expert
weighted by its gate.  Departures from the published model, which the
program shares and this file therefore keeps:

* no QK-norm: the published model RMS-normalises each token's whole q
  and k projections before RoPE;
* the norm is ``x / rms(x) * (1 + w)`` (a zero-centred scale; the
  published RMSNorm scales by ``w``);
* capacity: the published model is dropless.  The program routes each
  prompt's prefill as one row of S tokens with a capacity of
  C = max(K, min(ceil(S K / E * capacity_factor), S)) choices an expert:
  the choices are taken in token-major, rank-minor order, and one that
  finds its expert full is dropped (its gate is not given to another).
  A served token is decoded as a row of its own (C = K: nothing drops),
  over the cache of the prompt.  ``logits`` holds the program to that
  rule: the first ``prefill_len`` tokens are one row under the capacity,
  and every later token routes alone;
* the router's load-balancing loss and z-loss are training terms and
  take no part here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from agentbench.reference.common import (causal_attention, dot, f32,
                                         head_logits, padded_vocab, rms_norm, rope)
from agentbench.weights import Leaf


def leaves(m: dict) -> List[Leaf]:
    """Every weight, by the program's names; matrices are (d_in, d_out)
    and drawn at 1/sqrt(d_in), the embedding at 1, the norms' zero-centred
    scales at 0.1; the router is f32."""
    d, f, E = m["d_model"], m["d_ff"], m["num_experts"]
    qd, kvd = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    bf = torch.bfloat16
    out = [Leaf("embed", (padded_vocab(m), d), bf, 1.0)]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [Leaf(p + "ln1", (d,), bf, 0.1),
                Leaf(p + "attn.wq", (d, qd), bf, d ** -0.5),
                Leaf(p + "attn.wk", (d, kvd), bf, d ** -0.5),
                Leaf(p + "attn.wv", (d, kvd), bf, d ** -0.5),
                Leaf(p + "attn.wo", (qd, d), bf, qd ** -0.5),
                Leaf(p + "ln2", (d,), bf, 0.1),
                Leaf(p + "mlp.router", (d, E), torch.float32, d ** -0.5),
                Leaf(p + "mlp.w_gate", (E, d, f), bf, d ** -0.5),
                Leaf(p + "mlp.w_up", (E, d, f), bf, d ** -0.5),
                Leaf(p + "mlp.w_down", (E, f, d), bf, f ** -0.5)]
    out += [Leaf("final_norm", (d,), bf, 0.1),
            # logits = x @ lm_head^T: its fan-in is d
            Leaf("lm_head", (padded_vocab(m), d), bf, d ** -0.5)]
    return out


def kept_choices(experts: torch.Tensor, num_experts: int, capacity: int) -> torch.Tensor:
    """(S, K) experts of one row -> (S, K) bool: the choice's place in its
    expert, counted over the row's choices in token-major, rank-minor
    order, is below ``capacity``."""
    S, K = experts.shape
    onehot = torch.nn.functional.one_hot(experts.reshape(-1), num_experts)
    place = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    return (place < capacity).reshape(S, K)


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], m: dict, prefill_len: int,
        precision: str) -> torch.Tensor:
    S = h.shape[0]
    E, K = m["num_experts"], m["experts_per_token"]
    probs = torch.softmax(h @ p["mlp.router"], dim=-1)  # the router stays f32
    gates, experts = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(experts, dtype=torch.bool)
    P = min(prefill_len, S)
    cap = max(K, min(math.ceil(P * K / E * m["capacity_factor"]), P))
    keep[:P] = kept_choices(experts[:P], E, cap)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, rank = torch.nonzero((experts == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = dot(torch.nn.functional.silu(dot(x, p["mlp.w_gate"][e], precision))
                * dot(x, p["mlp.w_up"][e], precision), p["mlp.w_down"][e], precision)
        out.index_add_(0, tok, y * gates[tok, rank][:, None])
    return out


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], m: dict, seqs: List[Tuple[torch.Tensor, int]],
           precision: str = "f32") -> List[torch.Tensor]:
    """For each (tokens, prefill_len) of ``seqs``, the logits at positions
    prefill_len - 1 .. len(tokens) - 1; layer by layer over all of them,
    each layer's weights copied to f32 once."""
    H, KV, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    xs = [weights["embed"][t].float() for t, _ in seqs]
    for i in range(m["num_layers"]):
        p = f32(weights, f"layers.{i}.")
        for n, (x, (_, prefill_len)) in enumerate(zip(xs, seqs)):
            T = x.shape[0]
            h = rms_norm(x, p["ln1"], eps)
            q = rope(dot(h, p["attn.wq"], precision).view(T, H, D), m["rope_theta"])
            k = rope(dot(h, p["attn.wk"], precision).view(T, KV, D), m["rope_theta"])
            v = dot(h, p["attn.wv"], precision).view(T, KV, D)
            x = x + dot(causal_attention(q, k, v).reshape(T, H * D), p["attn.wo"],
                        precision)
            xs[n] = x + moe(rms_norm(x, p["ln2"], eps), p, m, prefill_len, precision)
        del p
    norm, table = weights["final_norm"].float(), weights["lm_head"].float()
    return [head_logits(x[P - 1:], norm, table, m["vocab_size"], eps, precision)
            for x, (_, P) in zip(xs, seqs)]
