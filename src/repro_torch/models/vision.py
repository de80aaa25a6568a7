"""llama-3.2-vision-11b's decoder in PyTorch, counterpart of
``repro.models.vision.make_vlm``.

The image frontend is a stub, as in the reference: ``image_embeds``, (B,
num_image_tokens, vision_d_model) precomputed patch embeddings, are an
input of ``prefill``.  The model is ``G = num_layers // cross_attn_every``
groups of ``cross_attn_every`` dense :class:`DecoderLayer` s followed by
one gated :class:`CrossLayer`; :class:`VisionLM` keeps the self layers in
one flat list (layer ``g * per + j`` is the reference's ``[g][j]``) and
runs them in the reference's group order.  It serves:

    prefill(tokens, image_embeds)      -> (last logits, prefill cache)
    decode_step(cache, tokens, pos)    -> (logits, cache)
    init_cache(batch, max_len)         -> cache

and trains through ``forward_loss(tokens, labels, image_embeds)``, the
reference's, with every self and cross layer rematerialised
(``layers.remat``; the reference leaves its cross layers out of
``jax.checkpoint``, and recomputation changes no value).
``extra_inputs(batch)`` names the image input's shape and dtype.

The cache is a dict of stacked bf16 leaves, each contiguous:

    k, v    (num_layers, B, KV, max_len, D)        the self layers' KV
    ck, cv  (G, B, KV, num_image_tokens, D)        the image's K/V, per group

A prefill cache has the same keys, with S positions in ``k``/``v``, in
the weights' dtype.  The cross K/V are projected once, at prefill, with no
rope; prefill attends over them through the flash kernel's non-causal mode
(Sq != Sk) and decode through the decode kernel over all
``num_image_tokens`` entries.  ``decode_step`` updates ``k``/``v`` in
place.

Sharded, every leaf keeps the "heads" layout (KV the KV heads of the
rank's call), a lasting divergence: the reference lays the self cache's
positions over ``model`` and replicates the image cache over it.  The 8
KV heads divide every model ways the config is meshed at, so
``sharding.kv_layout`` gives "heads", as the reference's dry-run rule
does; the self cache is then the bytes a GPU that "seq" would hold,
without its q gather, merge and K/V gather (``wk``/``wv`` are split over
``model`` here), and the image cache a W-th of the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import model_device
from repro_torch.distributed.sharding import MODEL, attention_share, local
from repro_torch.models.layers import (MLP_SPECS, NORM_SPEC, VOCAB_SPEC,
                                       bidirectional_attention,
                                       column_parallel, cross_kv,
                                       decode_attention, embed_lookup,
                                       full_lengths, mlp_block, model_logits,
                                       model_loss, remat, rms_norm,
                                       row_parallel)
from repro_torch.models.transformer import (CACHE_DTYPE, DecoderLayer, _param,
                                            dense_mlp, init_like_reference,
                                            layer_specs)

# the reference's placements of ``cross_layer_defs``' weights
CROSS_SPECS = {"ln": NORM_SPEC, "wq": (None, MODEL), "wk": (None, MODEL),
               "wv": (None, MODEL), "wo": (MODEL, None), "gate": (),
               "ln_mlp": NORM_SPEC, "mlp": MLP_SPECS, "gate_mlp": ()}


class CrossLayer(nn.Module):
    """``cross_layer_defs``: ``ln``, ``wq`` (d, q_dim), ``wk``/``wv``
    (vision_d_model, kv_dim), ``wo``, the f32 scalar ``gate``, ``ln_mlp``,
    the SwiGLU ``mlp`` and the f32 scalar ``gate_mlp``.  Each sublayer's
    output is scaled by tanh of its gate, computed in f32 and rounded to
    x's dtype before the product, as in the reference."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, vd = cfg.d_model, cfg.vision_d_model
        self.ln = _param((d,), device, dtype)
        self.wq = _param((d, cfg.q_dim), device, dtype)
        self.wk = _param((vd, cfg.kv_dim), device, dtype)
        self.wv = _param((vd, cfg.kv_dim), device, dtype)
        self.wo = _param((cfg.q_dim, d), device, dtype)
        self.gate = _param((), device, torch.float32)
        self.ln_mlp = _param((d,), device, dtype)
        self.mlp = dense_mlp(cfg, device, dtype)
        self.gate_mlp = _param((), device, torch.float32)

    def kv(self, image_embeds, cfg):
        """``cross_kv``: (B, I, vd) -> k, v (B, I, KV, D), KV this rank's
        heads (``layers.cross_kv``)."""
        return cross_kv(image_embeds, self.wq, self.wk, self.wv, cfg)

    def _gated(self, x, attn, cfg):
        """The gated residuals around the attention output (..., this
        rank's heads' part of q_dim) and the MLP: ``wo``'s partial sums are
        summed over ``model`` before the f32 ``tanh(gate)`` scales them,
        and the gates stay whole."""
        x = x + torch.tanh(local(self.gate)).to(x.dtype) * row_parallel(attn, self.wo)
        h = mlp_block(self.mlp, rms_norm(x, self.ln_mlp, cfg.norm_eps),
                      cfg.activation)
        return x + torch.tanh(local(self.gate_mlp)).to(x.dtype) * h

    def forward(self, x, image_embeds, cfg, plain=False):
        """The training pass: the image's K/V (``kv``), then the layer."""
        return self.prefill(x, *self.kv(image_embeds, cfg), cfg, plain)

    def prefill(self, x, k, v, cfg, plain):
        """``cross_layer_apply``: x (B, S, d) over k/v (B, I, KV, D)."""
        B, S, _ = x.shape
        q = column_parallel(rms_norm(x, self.ln, cfg.norm_eps), self.wq)
        attn = bidirectional_attention(
            q.reshape(B, S, -1, cfg.head_dim), k, v, plain=plain)
        return self._gated(x, attn.reshape(B, S, -1), cfg)

    def decode(self, x, ck, cv, lengths, cfg, plain):
        """One token per row, x (B, d), over the cached ck/cv (B, KV, I, D)."""
        B = x.shape[0]
        q = column_parallel(rms_norm(x, self.ln, cfg.norm_eps), self.wq)
        attn = decode_attention(q.reshape(B, -1, cfg.head_dim),
                                ck, cv, lengths, plain=plain)
        return self._gated(x, attn.reshape(B, -1), cfg)


class VisionLM(nn.Module):
    """The VLM decoder on one device: ``embed``, ``self_layers`` (one
    :class:`DecoderLayer` per self layer), ``cross_layers`` (one
    :class:`CrossLayer` per group), ``final_norm`` and ``lm_head``.
    Weights start at zero; ``init_params`` draws them by the reference's
    rules (the gates stay zero, so a seeded model ignores its image until
    the gates are set) and ``repro_torch.bridge.load_reference_params``
    copies them from the reference's tree.  ``plain_kernels`` runs the
    plain versions of the attention kernels (for comparisons only)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = model_device(device)
        if cfg.num_layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"groups of {cfg.cross_attn_every}")
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype
        self.plain_kernels = False
        self.per = cfg.cross_attn_every
        groups = cfg.num_layers // self.per
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = _param((v, d), dev, dtype)
        self.self_layers = nn.ModuleList(
            DecoderLayer(cfg, dev, dtype) for _ in range(cfg.num_layers))
        self.cross_layers = nn.ModuleList(
            CrossLayer(cfg, dev, dtype) for _ in range(groups))
        self.final_norm = _param((d,), dev, dtype)
        self.lm_head = _param((v, d), dev, dtype)

    def init_params(self, generator: torch.Generator) -> "VisionLM":
        """Seeded weights by the reference's rules (``init_like_reference``)."""
        init_like_reference(self, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements by the port's names."""
        return {"embed": VOCAB_SPEC, "final_norm": NORM_SPEC,
                "lm_head": VOCAB_SPEC, "self_layers": layer_specs(self.cfg),
                "cross_layers": CROSS_SPECS}

    def _groups(self):
        """(self layers, cross layer) of each group, in order."""
        for g, cross in enumerate(self.cross_layers):
            yield self.self_layers[g * self.per:(g + 1) * self.per], cross

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _image(self, image_embeds) -> torch.Tensor:
        return torch.as_tensor(image_embeds, device=self.device).to(self.dtype)

    def extra_inputs(self, batch: int) -> dict:
        """The input beside the tokens, as the reference's bundle names it:
        {"image_embeds": ((batch, num_image_tokens, vision_d_model),
        dtype)}, in the weights' dtype."""
        cfg = self.cfg
        return {"image_embeds": ((batch, cfg.num_image_tokens,
                                  cfg.vision_d_model), self.dtype)}

    @torch.no_grad()
    def prefill(self, tokens, image_embeds):
        """tokens: (B, S), every row S tokens long (no lengths, as in the
        reference); image_embeds: (B, num_image_tokens, vision_d_model),
        taken in the weights' dtype.  Returns the logits (B, vocab) of the
        last token and the prefill cache."""
        cfg, plain = self.cfg, self.plain_kernels
        img = self._image(image_embeds)
        x = embed_lookup(self.embed, self._tokens(tokens))
        ks, vs, cks, cvs = [], [], [], []
        for layers, cross in self._groups():
            for layer in layers:
                x, (k, v) = layer.prefill(x, cfg, plain)
                ks.append(k)
                vs.append(v)
            ck, cv = cross.kv(img, cfg)
            x = cross.prefill(x, ck, cv, cfg, plain)
            cks.append(ck.transpose(1, 2))
            cvs.append(cv.transpose(1, 2))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "ck": torch.stack(cks), "cv": torch.stack(cvs)}
        return model_logits(self, x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token per row.  cache: the dict of ``init_cache``; tokens:
        (B,); pos: scalar or (B,) positions.  Writes the self layers' K/V
        at ``pos`` in place, attends over all image entries in every row,
        and returns (logits (B, vocab) f32, cache)."""
        cfg, plain = self.cfg, self.plain_kernels
        x = embed_lookup(self.embed, self._tokens(tokens))
        pos = torch.as_tensor(pos, device=self.device)
        lengths = full_lengths(cache["ck"][0])
        i = 0
        for g, (layers, cross) in enumerate(self._groups()):
            for layer in layers:
                x, _ = layer.decode(x, (cache["k"][i], cache["v"][i]), pos,
                                    cfg, plain)
                i += 1
            x = cross.decode(x, cache["ck"][g], cache["cv"][g], lengths, cfg,
                             plain)
        return model_logits(self, x), cache

    def forward_loss(self, tokens, labels, image_embeds) -> torch.Tensor:
        """The reference's ``forward_loss``: tokens and labels (B, S) over
        image_embeds (B, num_image_tokens, vision_d_model), taken in the
        weights' dtype; the mean cross entropy of the f32 logits at every
        position.  Each cross layer projects the image's K/V inside its
        ``remat``, and its f32 gates take gradients as any weight."""
        cfg, plain = self.cfg, self.plain_kernels
        img = self._image(image_embeds)
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layers, cross in self._groups():
            for layer in layers:
                x = remat(layer, x, cfg, plain)
            x = remat(cross, x, img, cfg, plain)
        return model_loss(self, x, self._tokens(labels))

    def init_cache(self, batch: int, max_len: int):
        """Zero bf16 leaves of the cache layout; KV is this rank's KV heads
        in a sharded model (``attention_share``), of the self layers and of
        the cross layers."""
        cfg = self.cfg
        attn, cross = self.self_layers[0].attn, self.cross_layers[0]
        heads = attention_share(attn["wq"], attn["wk"], cfg).kv_heads
        kv = (cfg.num_layers, batch, heads, max_len, cfg.head_dim)
        heads = attention_share(cross.wq, cross.wk, cfg).kv_heads
        image = (len(self.cross_layers), batch, heads,
                 cfg.num_image_tokens, cfg.head_dim)
        return {name: torch.zeros(shape, device=self.device, dtype=CACHE_DTYPE)
                for name, shape in (("k", kv), ("v", kv), ("ck", image),
                                    ("cv", image))}
