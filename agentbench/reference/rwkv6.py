"""RWKV-6 "Finch" (arXiv:2404.05892) as the repository's rwkv6 model
defines it, in plain f32 PyTorch, layer by layer over the whole sequence.

Per layer, with every token's input shifted by one (the first token's
predecessor is zero):

* time mix: the data-dependent lerp of the normed input and its shifted
  copy into five inputs (r, k, v, w, g) through a rank-32 LoRA; r, k, v
  projections; the gate silu(x_g W_g); the log decay
  logw = -exp(w0 + tanh(x_w A) B) through a rank-64 LoRA; per head the
  WKV6 recurrence
      S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
      o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,
  a group norm per head (eps 64e-5) with its scale and bias, times the
  gate, through W_o;
* channel mix: the lerp of the normed input and its shifted copy into
  k and r, sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v).

Departures from the published model, which the program shares and this
file therefore keeps: the norms are RMS norms with a zero-centred scale
(the published model uses LayerNorm), there is no LayerNorm after the
embedding (the published model's ln0), and the two LoRA ranks are fixed
at 32 and 64 (the published 7B's are 64 and 128).  The
recurrence is computed in chunks of ``CHUNK`` tokens: within a chunk
every pair's decay is the exponential of a difference of cumulative log
decays, which is never positive, so nothing overflows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from agentbench.reference.common import dot, f32, head_logits, padded_vocab, rms_norm
from agentbench.weights import Leaf

DDLERP_R = 32
LORA_R = 64
CHUNK = 64


def leaves(m: dict) -> List[Leaf]:
    """Every weight, by the program's names.  Matrices (d_in, d_out) at
    1/sqrt(d_in); the LoRAs' second factors at 0.1; the lerp weights about
    0.5; w0 a ramp from -5 to -1 over the channels with noise; u, the
    group norm's bias and the norms' zero-centred scales at 0.1 to 0.5;
    w0 and u are f32."""
    d, f = m["d_model"], m["d_ff"]
    bf, fl = torch.bfloat16, torch.float32
    out = [Leaf("embed", (padded_vocab(m), d), bf, 1.0)]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [Leaf(p + "ln1", (d,), bf, 0.1),
                Leaf(p + "tm.mu_x", (d,), bf, 0.2, 0.5),
                Leaf(p + "tm.mu", (5, d), bf, 0.2, 0.5),
                Leaf(p + "tm.ddl_w1", (d, 5 * DDLERP_R), bf, d ** -0.5),
                Leaf(p + "tm.ddl_w2", (5, DDLERP_R, d), bf, 0.1),
                Leaf(p + "tm.wr", (d, d), bf, d ** -0.5),
                Leaf(p + "tm.wk", (d, d), bf, d ** -0.5),
                Leaf(p + "tm.wv", (d, d), bf, d ** -0.5),
                Leaf(p + "tm.wg", (d, d), bf, d ** -0.5),
                Leaf(p + "tm.wo", (d, d), bf, d ** -0.5),
                Leaf(p + "tm.w0", (d,), fl, 0.1, ramp=(-5.0, -1.0)),
                Leaf(p + "tm.w_lora1", (d, LORA_R), bf, d ** -0.5),
                Leaf(p + "tm.w_lora2", (LORA_R, d), bf, 0.1),
                Leaf(p + "tm.u", (d,), fl, 0.5),
                Leaf(p + "tm.gn_scale", (d,), bf, 0.1, 1.0),
                Leaf(p + "tm.gn_bias", (d,), bf, 0.1),
                Leaf(p + "ln2", (d,), bf, 0.1),
                Leaf(p + "cm.mu_k", (d,), bf, 0.2, 0.5),
                Leaf(p + "cm.mu_r", (d,), bf, 0.2, 0.5),
                Leaf(p + "cm.wk", (d, f), bf, d ** -0.5),
                Leaf(p + "cm.wv", (f, d), bf, f ** -0.5),
                Leaf(p + "cm.wr", (d, d), bf, d ** -0.5)]
    out += [Leaf("final_norm", (d,), bf, 0.1),
            Leaf("lm_head", (padded_vocab(m), d), bf, d ** -0.5)]
    return out


def shifted(x: torch.Tensor) -> torch.Tensor:
    """Each token's predecessor, zero before the first."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def wkv6(r, k, v, logw, u) -> torch.Tensor:
    """The recurrence over (H, T, D) inputs from a zero state; u (H, D);
    returns o (H, T, D)."""
    H, T, D = r.shape
    state = r.new_zeros(H, D, D)
    out = torch.empty_like(r)
    for s in range(0, T, CHUNK):
        e = min(s + CHUNK, T)
        rc, kc, vc, wc = r[:, s:e], k[:, s:e], v[:, s:e], logw[:, s:e]
        n = e - s
        cum = torch.cumsum(wc, dim=1)  # through token i
        before = cum - wc  # through token i - 1
        # o_i from the chunk's start state: r_i decayed by tokens < i
        o = torch.einsum("hid,hde->hie", rc * torch.exp(before), state)
        # pairs j < i: r_i k_j decayed by tokens j+1 .. i-1
        diff = before[:, :, None, :] - cum[:, None, :, :]  # (H, i, j, D)
        lower = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
        diff = diff.masked_fill(~lower[None, :, :, None], float("-inf"))
        a = torch.einsum("hid,hjd,hijd->hij", rc, kc, torch.exp(diff))
        o = o + torch.einsum("hij,hje->hie", a, vc)
        # the bonus of the token itself
        o = o + (rc * u[:, None, :] * kc).sum(-1, keepdim=True) * vc
        out[:, s:e] = o
        # the state after the chunk
        last = cum[:, -1:, :]
        state = (torch.exp(last[:, 0, :, None]) * state
                 + torch.einsum("hjd,hje->hde", kc * torch.exp(last - cum), vc))
    return out


def group_norm(x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def time_mix(a: torch.Tensor, p: Dict[str, torch.Tensor], m: dict,
             precision: str) -> torch.Tensor:
    T, d = a.shape
    H, D = m["num_heads"], m["head_dim"]
    dx = shifted(a) - a
    base = a + dx * p["tm.mu_x"]
    lora = torch.tanh(dot(base, p["tm.ddl_w1"], precision)).view(T, 5, DDLERP_R)
    delta = torch.einsum("tnr,nrd->tnd", lora, p["tm.ddl_w2"])
    xr, xk, xv, xw, xg = (a + dx * (p["tm.mu"][i] + delta[:, i]) for i in range(5))
    r, k, v = (dot(xi, p[w], precision).view(T, H, D).transpose(0, 1)
               for xi, w in ((xr, "tm.wr"), (xk, "tm.wk"), (xv, "tm.wv")))
    g = torch.nn.functional.silu(dot(xg, p["tm.wg"], precision))
    logw = -torch.exp(p["tm.w0"] + dot(torch.tanh(dot(xw, p["tm.w_lora1"], precision)),
                                       p["tm.w_lora2"], precision))
    o = wkv6(r, k, v, logw.view(T, H, D).transpose(0, 1), p["tm.u"].view(H, D))
    normed = group_norm(o.transpose(0, 1)).reshape(T, d)
    normed = normed * p["tm.gn_scale"] + p["tm.gn_bias"]
    return dot(normed * g, p["tm.wo"], precision)


def channel_mix(b: torch.Tensor, p: Dict[str, torch.Tensor], precision: str):
    dx = shifted(b) - b
    xk, xr = b + dx * p["cm.mu_k"], b + dx * p["cm.mu_r"]
    kv = dot(torch.relu(dot(xk, p["cm.wk"], precision)).square(), p["cm.wv"], precision)
    return torch.sigmoid(dot(xr, p["cm.wr"], precision)) * kv


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], m: dict, seqs: List[Tuple[torch.Tensor, int]],
           precision: str = "f32") -> List[torch.Tensor]:
    """For each (tokens, prefill_len) of ``seqs``, the logits at positions
    prefill_len - 1 .. len(tokens) - 1.  The recurrence carries every
    token alike, so a prompt and its served tokens run as one sequence;
    layer by layer over all of them, each layer's weights copied to f32
    once."""
    eps = m["norm_eps"]
    xs = [weights["embed"][t].float() for t, _ in seqs]
    for i in range(m["num_layers"]):
        p = f32(weights, f"layers.{i}.")
        for n, x in enumerate(xs):
            x = x + time_mix(rms_norm(x, p["ln1"], eps), p, m, precision)
            xs[n] = x + channel_mix(rms_norm(x, p["ln2"], eps), p, precision)
        del p
    norm, table = weights["final_norm"].float(), weights["lm_head"].float()
    return [head_logits(x[P - 1:], norm, table, m["vocab_size"], eps, precision)
            for x, (_, P) in zip(xs, seqs)]
