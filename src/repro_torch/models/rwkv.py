"""RWKV6 "Finch" (rwkv6-7b) in PyTorch, counterpart of ``repro.models.rwkv``.

The WKV6 recurrence per head (head_dim D):

    S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t     (state: D x D, f32)
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t

Unlike the reference, whose model prefills through the jnp ``wkv6_chunked``
(which needs S % 64 == 0 past one chunk) and decodes through ``wkv6_step``,
both prefill and decode here call the port's kernel ``wkv6_op`` directly,
for any S >= 1; decode runs it at S = 1.  ``RWKVLM.plain_kernels = True``
takes its plain PyTorch version instead (for comparisons only).

:class:`RWKVLM` holds the weights of ``repro.models.rwkv.rwkv_layer_defs``
in the same layout, one :class:`RWKVLayer` per layer, and serves and
trains:

    prefill(tokens)                   -> (last logits, state)
    decode_step(cache, tokens, pos)   -> (logits, cache)   (pos is ignored)
    init_cache(batch, max_len)        -> state             (max_len is ignored)
    forward_loss(tokens, labels)      -> mean cross entropy

The loss is the reference's ``forward_loss``: every layer from zero
states, under ``layers.remat``; on the card its WKV6 calls go through
``WKV6Fn`` (the forward kernel, then ``csrc/wkv6_bwd.cu``).

The state is ``{"wkv": (L, B, H, D, D) f32, "tm_x": (L, B, d), "cm_x":
(L, B, d)}``, the token-shift states in the weights' dtype.  Sharded over
``model`` (``distributed.sharding.shard_model``, the reference's
``LAYER_SPECS``), H is this rank's heads: ``wr``, ``wk``, ``wv``, ``wg``,
``w_lora2`` and the channel mix's ``wk`` are column shards, each input of
theirs entering through ``copy_to_model`` (so every weight upstream, the
lerp's and the lora's first factor, which stay whole, gets a whole
gradient), ``wo`` and the channel mix's ``wv`` row shards summed over
``model``, and the WKV6 kernels run on the local heads.  (The reference
declares them bf16 but writes back its decode's own dtype, so with bf16
weights the two agree.)  ``decode_step`` updates the cache in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import model_device
from repro_torch.kernels.rwkv6_scan import wkv6_op, wkv6_scan_ref
from repro_torch.distributed.sharding import MODEL, local, model_ways
from repro_torch.models.layers import (ACC_DTYPE, NORM_SPEC, VOCAB_SPEC,
                                       activate, column_parallel,
                                       embed_lookup, matmul, model_logits,
                                       model_loss, remat, rms_norm,
                                       row_parallel)

LORA_R = 64  # decay lora rank
DDLERP_R = 32  # data-dependent lerp rank


@dataclass(frozen=True)
class ParamDef:
    """Shape and init rule of one weight, as the reference's ``ParamDef``:
    init is normal (times ``scale``, default 1/sqrt(fan_in)), zeros, ones or
    decay_init; ``f32`` weights stay f32 in a bf16 model."""

    shape: Tuple[int, ...]
    init: str = "normal"
    scale: Optional[float] = None
    f32: bool = False


def rwkv_layer_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln1": ParamDef((d,), "zeros"),
        "tm": {
            # data-dependent lerp (5 targets: r, k, v, w, g)
            "mu_x": ParamDef((d,), "zeros"),
            "mu": ParamDef((5, d), "zeros"),
            "ddl_w1": ParamDef((d, 5 * DDLERP_R), scale=1e-2),
            "ddl_w2": ParamDef((5, DDLERP_R, d), scale=1e-2),
            "wr": ParamDef((d, d)),
            "wk": ParamDef((d, d)),
            "wv": ParamDef((d, d)),
            "wg": ParamDef((d, d)),
            "wo": ParamDef((d, d)),
            "w0": ParamDef((d,), "decay_init", f32=True),
            "w_lora1": ParamDef((d, LORA_R), scale=1e-2),
            "w_lora2": ParamDef((LORA_R, d), scale=1e-2),
            "u": ParamDef((d,), "zeros", f32=True),
            "gn_scale": ParamDef((d,), "ones"),
            "gn_bias": ParamDef((d,), "zeros"),
        },
        "ln2": ParamDef((d,), "zeros"),
        "cm": {
            "mu_k": ParamDef((d,), "zeros"),
            "mu_r": ParamDef((d,), "zeros"),
            "wk": ParamDef((d, f)),
            "wv": ParamDef((f, d)),
            "wr": ParamDef((d, d)),
        },
    }


# the reference's placements of ``rwkv_layer_defs``' weights
LAYER_SPECS = {
    "ln1": NORM_SPEC,
    "tm": {"mu_x": (None,), "mu": (None, None), "ddl_w1": (None, None),
           "ddl_w2": (None, None, None), "wr": (None, MODEL),
           "wk": (None, MODEL), "wv": (None, MODEL), "wg": (None, MODEL),
           "wo": (MODEL, None), "w0": (MODEL,), "w_lora1": (None, None),
           "w_lora2": (None, MODEL), "u": (MODEL,), "gn_scale": (MODEL,),
           "gn_bias": (MODEL,)},
    "ln2": NORM_SPEC,
    "cm": {"mu_k": (None,), "mu_r": (None,), "wk": (None, MODEL),
           "wv": (MODEL, None), "wr": (None, None)},
}
# ``model_defs``' placements (hymba's embed, final_norm and lm_head too)
MODEL_SPECS = {"embed": VOCAB_SPEC, "final_norm": NORM_SPEC,
               "lm_head": VOCAB_SPEC}


def model_defs(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    return {"embed": ParamDef((v, d), scale=1.0),
            "final_norm": ParamDef((d,), "zeros"),
            "lm_head": ParamDef((v, d))}


@torch.no_grad()
def instantiate(p: torch.Tensor, pdef: ParamDef,
                generator: torch.Generator) -> None:
    """Fill ``p`` by ``pdef``'s rule (the reference's ``ParamDef.instantiate``).
    A normal draw is made on p's device in f32, then cast."""
    if pdef.init == "zeros":
        p.zero_()
    elif pdef.init == "ones":
        p.fill_(1.0)
    elif pdef.init == "decay_init":
        # log-spaced decay init of w, from -5 to -1 over the last dim
        n = p.shape[-1]
        base = -5.0 + 4.0 * (torch.arange(n, dtype=torch.float32,
                                          device=p.device) / max(n - 1, 1))
        p.copy_(base.expand(p.shape))
    else:
        fan_in = p.shape[-2] if p.ndim >= 2 else p.shape[-1]
        scale = pdef.scale if pdef.scale is not None else fan_in ** -0.5
        draw = torch.randn(p.shape, generator=generator, device=p.device,
                           dtype=torch.float32)
        p.copy_(draw.mul_(scale))


@torch.no_grad()
def instantiate_all(module: nn.Module, defs: dict,
                    generator: torch.Generator) -> None:
    """``instantiate`` every weight of ``module`` named in ``defs``: a
    ``ParamDef`` names a tensor attribute, a dict of them a
    ``ParameterDict``."""
    for name, pdef in defs.items():
        if isinstance(pdef, dict):
            group = getattr(module, name)
            for key, sub in pdef.items():
                instantiate(group[key], sub, generator)
        else:
            instantiate(getattr(module, name), pdef, generator)


def _param(pdef: ParamDef, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(pdef.shape, device=device,
                                    dtype=torch.float32 if pdef.f32 else dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Time mix and channel mix
# ---------------------------------------------------------------------------


def wkv6(r, k, v, logw, u, state, *, plain: bool = False):
    """The WKV6 scan over (B, H, S, D) inputs from ``state`` (B, H, D, D),
    which is updated in place; returns (out, state)."""
    if plain:
        out, s1 = wkv6_scan_ref(r, k, v, logw, u, state)
        return out, state.copy_(s1)
    return wkv6_op(r, k, v, logw, u, state, out_state=state)


def local_heads(tm, cfg: ArchConfig) -> int:
    """The WKV heads of a time mix on this rank: all of them unsharded,
    ``num_heads / ways`` where its projections are sharded over
    ``model``."""
    return cfg.num_heads // model_ways(tm["wr"])


def _ddlerp(tm, x: torch.Tensor, xx: torch.Tensor):
    """RWKV6 data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g).
    Its weights are whole on every rank, and so are its outputs."""
    base = x + (xx - x) * local(tm["mu_x"])
    lora = torch.tanh(matmul(base, local(tm["ddl_w1"])))
    lora = lora.reshape(*lora.shape[:-1], 5, DDLERP_R)
    delta = torch.einsum("...nr,nrd->...nd", lora.to(ACC_DTYPE),
                         local(tm["ddl_w2"]).to(ACC_DTYPE)).to(x.dtype)
    mu = local(tm["mu"])
    return tuple(x + (xx - x) * (mu[i] + delta[..., i, :]) for i in range(5))


def _group_norm(x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head groupnorm over head_dim, x: (..., H, D); f32 out."""
    xf = x.to(ACC_DTYPE)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def _decay_and_gate(tm, xw: torch.Tensor, xg: torch.Tensor):
    """The log decay and the gate, each of this rank's channels (``wg``,
    ``w_lora2`` and ``w0`` sharded over ``model``; ``w_lora1`` whole)."""
    g = activate(column_parallel(xg, tm["wg"]), "silu")
    lora = torch.tanh(matmul(xw, local(tm["w_lora1"])))
    logw = -torch.exp(local(tm["w0"]).to(ACC_DTYPE)
                      + column_parallel(lora, tm["w_lora2"]).to(ACC_DTYPE))
    return logw, g


def _mix_out(tm, out: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """Groupnorm of the (..., H, D) wkv output (per head: no collective),
    gate and output projection (``wo``'s rows of this rank's heads, summed
    over ``model``)."""
    normed = _group_norm(out).reshape(*out.shape[:-2], -1)
    normed = (normed * local(tm["gn_scale"]).to(ACC_DTYPE)
              + local(tm["gn_bias"]).to(ACC_DTYPE)).to(dtype)
    return row_parallel(normed * g, tm["wo"])


def _wkv_operands(tm, x: torch.Tensor, tm_x: torch.Tensor, cfg: ArchConfig):
    """The WKV6 operands of x (B, S, d) after the token-shift state tm_x
    (B, d): r, k, v and logw as (B, H, S, D) views of (B, S, H, D)
    projections (no copy), and the gate g.  H is this rank's heads
    (``local_heads``)."""
    B, S, _ = x.shape
    H, D = local_heads(tm, cfg), cfg.head_dim
    xx = torch.cat([tm_x[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(tm, x, xx)
    r, k, v = (column_parallel(a, tm[w]).view(B, S, H, D).transpose(1, 2)
               for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    logw, g = _decay_and_gate(tm, xw, xg)
    return r, k, v, logw.view(B, S, H, D).transpose(1, 2), g


def time_mix_prefill(tm, x: torch.Tensor, cfg: ArchConfig,
                     tm_state: torch.Tensor, wkv_state: torch.Tensor, *,
                     plain: bool = False):
    """x: (B, S, d).  Returns (out, (last_x, wkv_state)); ``wkv_state`` is
    updated in place."""
    r, k, v, logw, g = _wkv_operands(tm, x, tm_state, cfg)
    out, wkv_state = wkv6(r, k, v, logw, local(tm["u"]).view(-1, cfg.head_dim),
                          wkv_state, plain=plain)
    return _mix_out(tm, out.transpose(1, 2), g, x.dtype), (x[:, -1], wkv_state)


def time_mix_decode(tm, x: torch.Tensor, cfg: ArchConfig,
                    tm_state: torch.Tensor, wkv_state: torch.Tensor, *,
                    plain: bool = False):
    """x: (B, d), one token.  ``wkv_state`` is updated in place."""
    B, _ = x.shape
    H, D = local_heads(tm, cfg), cfg.head_dim
    xr, xk, xv, xw, xg = _ddlerp(tm, x, tm_state.to(x.dtype))
    r, k, v = (column_parallel(a, tm[w]).view(B, H, 1, D)
               for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    logw, g = _decay_and_gate(tm, xw, xg)
    out, wkv_state = wkv6(r, k, v, logw.view(B, H, 1, D),
                          local(tm["u"]).view(H, D), wkv_state, plain=plain)
    return _mix_out(tm, out[:, :, 0], g, x.dtype), (x, wkv_state)


def channel_mix(cm, x: torch.Tensor, cm_state: torch.Tensor, prefill: bool):
    """The channel mix: ``wk`` sharded over ``model`` by columns, ``wv`` by
    rows (summed over ``model``), the receptance ``wr`` whole."""
    if prefill:
        xx = torch.cat([cm_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
        new_state = x[:, -1]
    else:
        xx = cm_state.to(x.dtype)
        new_state = x
    xk = x + (xx - x) * local(cm["mu_k"])
    xr = x + (xx - x) * local(cm["mu_r"])
    kv = row_parallel(activate(column_parallel(xk, cm["wk"]), "relu_sq"), cm["wv"])
    gate = torch.sigmoid(matmul(xr, local(cm["wr"])).to(ACC_DTYPE)).to(x.dtype)
    return gate * kv, new_state


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        defs = rwkv_layer_defs(cfg)
        self.ln1 = _param(defs["ln1"], device, dtype)
        self.tm = nn.ParameterDict(
            {k: _param(p, device, dtype) for k, p in defs["tm"].items()})
        self.ln2 = _param(defs["ln2"], device, dtype)
        self.cm = nn.ParameterDict(
            {k: _param(p, device, dtype) for k, p in defs["cm"].items()})

    def step(self, x, state, cfg, plain: bool, prefill: bool):
        """Serving: x (B, S, d) in prefill, (B, d) in decode; state: (tm_x,
        cm_x, wkv), the last updated in place."""
        tm_x, cm_x, wkv = state
        time_mix = time_mix_prefill if prefill else time_mix_decode
        h, (tm_x, wkv) = time_mix(
            self.tm, rms_norm(x, self.ln1, cfg.norm_eps), cfg, tm_x, wkv,
            plain=plain)
        x = x + h
        h, cm_x = channel_mix(self.cm, rms_norm(x, self.ln2, cfg.norm_eps),
                              cm_x, prefill=prefill)
        return x + h, (tm_x, cm_x, wkv)

    def forward(self, x, cfg, plain: bool):
        """The loss's layer, the reference's ``layer_prefill`` from zero
        states: x (B, S, d) -> (B, S, d), writing nothing in place."""
        B, _, d = x.shape
        H, D = local_heads(self.tm, cfg), cfg.head_dim
        shift = x.new_zeros(B, d)
        r, k, v, logw, g = _wkv_operands(
            self.tm, rms_norm(x, self.ln1, cfg.norm_eps), shift, cfg)
        out, _ = (wkv6_scan_ref if plain else wkv6_op)(
            r, k, v, logw, local(self.tm["u"]).view(H, D),
            x.new_zeros(B, H, D, D, dtype=torch.float32))
        x = x + _mix_out(self.tm, out.transpose(1, 2), g, x.dtype)
        h, _ = channel_mix(self.cm, rms_norm(x, self.ln2, cfg.norm_eps),
                           shift, prefill=True)
        return x + h


class RWKVLM(nn.Module):
    """rwkv6 on one device.

    The weights start at zero; ``init_params`` draws them by the
    reference's rules, and ``repro_torch.bridge.load_reference_params``
    copies them from the reference's parameter tree.  ``w0`` and ``u`` are
    f32 whatever the model's dtype.  Setting ``plain_kernels`` to True runs
    the plain PyTorch version of the WKV6 kernels (for comparisons only).
    """

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = model_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype
        self.plain_kernels = False
        defs = model_defs(cfg)
        self.embed = _param(defs["embed"], dev, dtype)
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, dev, dtype) for _ in range(cfg.num_layers))
        self.final_norm = _param(defs["final_norm"], dev, dtype)
        self.lm_head = _param(defs["lm_head"], dev, dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "RWKVLM":
        """Draw every weight by its ``ParamDef`` rule, one at a time."""
        instantiate_all(self, model_defs(self.cfg), generator)
        layer_defs = rwkv_layer_defs(self.cfg)
        for layer in self.layers:
            instantiate_all(layer, layer_defs, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements by the port's names."""
        return {**MODEL_SPECS, "layers": LAYER_SPECS}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    @torch.no_grad()
    def prefill(self, tokens):
        """tokens: (B, S), any S >= 1.  Returns the logits (B, vocab) of the
        last token and the state after the prompt (the cache layout)."""
        tokens = self._tokens(tokens)
        x = embed_lookup(self.embed, tokens)
        state = self.init_cache(tokens.shape[0], 0)
        x = self._run(x, state, prefill=True)
        return model_logits(self, x[:, -1]), state

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token per row.  cache: the state dict; tokens: (B,); ``pos``
        is ignored (the recurrence carries position).  Updates ``cache`` in
        place and returns (logits (B, vocab) f32, cache)."""
        del pos
        x = embed_lookup(self.embed, self._tokens(tokens))
        return model_logits(self, self._run(x, cache, prefill=False)), cache

    def _run(self, x, state, prefill: bool):
        """Every layer over ``x``, updating the state dict in place."""
        for i, layer in enumerate(self.layers):
            x, (tm_x, cm_x, _) = layer.step(
                x, (state["tm_x"][i], state["cm_x"][i], state["wkv"][i]),
                self.cfg, self.plain_kernels, prefill)
            state["tm_x"][i] = tm_x
            state["cm_x"][i] = cm_x
        return x

    def forward_loss(self, tokens, labels) -> torch.Tensor:
        """The reference's ``forward_loss``: tokens and labels (B, S), any
        S >= 1; the mean cross entropy of the f32 logits at every
        position."""
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layer in self.layers:
            x = remat(layer, x, self.cfg, self.plain_kernels)
        return model_loss(self, x, self._tokens(labels))

    def init_cache(self, batch: int, max_len: int):
        """Zero state for ``batch`` sequences; O(1) in length, so
        ``max_len`` is ignored.  The WKV state holds this rank's heads
        (``local_heads``), the token-shift states the whole width."""
        del max_len
        cfg = self.cfg
        L, D, d = cfg.num_layers, cfg.head_dim, cfg.d_model
        H = local_heads(self.layers[0].tm, cfg)
        return {
            "wkv": torch.zeros((L, batch, H, D, D), device=self.device,
                               dtype=torch.float32),
            "tm_x": torch.zeros((L, batch, d), device=self.device,
                                dtype=self.dtype),
            "cm_x": torch.zeros((L, batch, d), device=self.device,
                                dtype=self.dtype),
        }
