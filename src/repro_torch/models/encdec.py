"""seamless-m4t-large-v2's encoder-decoder in PyTorch, counterpart of
``repro.models.encdec.make_encdec``.

The speech frontend is a stub, as in the reference: ``audio_frames``, (B,
num_audio_frames, d_model) precomputed frame embeddings, go straight into
``encoder_layers`` :class:`EncoderLayer` s (rope at frame positions,
non-causal attention, the MLP) and ``enc_norm``.  Each of the
``num_layers`` :class:`EncDecLayer` s of the decoder runs causal
self-attention, cross-attention over the encoder's output (ungated, no
rope) and the MLP.  :class:`EncDecLM` serves:

    encode(audio_frames)                 -> (B, F, d) encoder output
    prefill(tokens, audio_frames)        -> (last logits, prefill cache)
    decode_step(cache, tokens, pos)      -> (logits, cache)
    init_cache(batch, max_len)           -> cache

and trains through ``forward_loss(tokens, labels, audio_frames)``, the
reference's, with every encoder and decoder layer rematerialised
(``layers.remat``; the reference leaves its encoder out of
``jax.checkpoint``, and recomputation changes no value).
``extra_inputs(batch)`` names the audio input's shape and dtype.

The cache is a dict of stacked bf16 leaves, each contiguous:

    k, v    (num_layers, B, KV, max_len, D)           self-attention KV
    ck, cv  (num_layers, B, KV, num_audio_frames, D)  each layer's cross K/V

A prefill cache has the same keys, with S positions in ``k``/``v``, in
the weights' dtype.  Prefill runs the encoder and every attention through
the flash kernel (non-causal for the encoder and the cross-attention,
Sq != Sk there); decode attends over the self cache's prefix and over all
``num_audio_frames`` cross entries through the decode kernel, and updates
``k``/``v`` in place.

Sharded, every leaf keeps the "heads" layout (KV the KV heads of the
rank's call), a lasting divergence: the reference lays the self and
frame caches' positions over ``model``.  The 16 KV heads divide every
model ways the config is meshed at, so ``sharding.kv_layout`` gives
"heads", as the reference's dry-run rule does, and both caches are the
bytes a GPU that "seq" would hold, without its q gather, merge and K/V
gather (``wk``/``wv`` are split over ``model`` here).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import model_device
from repro_torch.distributed.sharding import MODEL, attention_share
from repro_torch.models.layers import (ATTENTION_SPECS, MLP_SPECS, NORM_SPEC,
                                       VOCAB_SPEC, attention_block_decode,
                                       attention_block_prefill,
                                       bidirectional_attention,
                                       column_parallel, cross_kv,
                                       decode_attention, embed_lookup,
                                       full_lengths, mlp_block, model_logits,
                                       model_loss, remat, rms_norm,
                                       row_parallel)
from repro_torch.models.transformer import (CACHE_DTYPE, EncoderLayer, _param,
                                            attention_params, dense_mlp,
                                            init_like_reference, layer_specs)

# the reference's placements of ``dec_layer_defs``' weights
DEC_LAYER_SPECS = {"ln1": NORM_SPEC, "self_attn": ATTENTION_SPECS,
                   "ln_x": NORM_SPEC, "wq_x": (None, MODEL),
                   "wk_x": (None, MODEL), "wv_x": (None, MODEL),
                   "wo_x": (MODEL, None), "ln2": NORM_SPEC, "mlp": MLP_SPECS}


class EncDecLayer(nn.Module):
    """``dec_layer_defs``: ``ln1``, ``self_attn`` (wq, wk, wv, wo), ``ln_x``,
    the cross projections ``wq_x``, ``wk_x``, ``wv_x`` and ``wo_x``, ``ln2``
    and ``mlp``."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.ln1 = _param((d,), device, dtype)
        self.self_attn = attention_params(cfg, device, dtype)
        self.ln_x = _param((d,), device, dtype)
        self.wq_x = _param((d, qd), device, dtype)
        self.wk_x = _param((d, kvd), device, dtype)
        self.wv_x = _param((d, kvd), device, dtype)
        self.wo_x = _param((qd, d), device, dtype)
        self.ln2 = _param((d,), device, dtype)
        self.mlp = dense_mlp(cfg, device, dtype)

    def cross_kv(self, enc_out, cfg):
        """(B, F, d) encoder output -> k, v (B, F, KV, D), KV this rank's
        heads (``layers.cross_kv``)."""
        return cross_kv(enc_out, self.wq_x, self.wk_x, self.wv_x, cfg)

    def _mlp(self, x, cfg):
        return x + mlp_block(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps),
                             cfg.activation)

    def forward(self, x, enc_out, cfg, plain=False):
        """The training pass: this layer's cross K/V of ``enc_out``
        (``cross_kv``), then the layer, keeping no K/V."""
        return self.prefill(x, *self.cross_kv(enc_out, cfg), cfg, plain)[0]

    def prefill(self, x, ck, cv, cfg, plain):
        """``dec_layer_prefill`` over this layer's cross k/v (B, F, KV, D);
        returns x and the self-attention's (k, v), each (B, KV, S, D)."""
        B, S, _ = x.shape
        h, kv = attention_block_prefill(
            self.self_attn, rms_norm(x, self.ln1, cfg.norm_eps), cfg,
            plain=plain)
        x = x + h
        q = column_parallel(rms_norm(x, self.ln_x, cfg.norm_eps), self.wq_x)
        attn = bidirectional_attention(
            q.reshape(B, S, -1, cfg.head_dim), ck, cv, plain=plain)
        x = x + row_parallel(attn.reshape(B, S, -1), self.wo_x)
        return self._mlp(x, cfg), kv

    def decode(self, x, kv, ck, cv, pos, lengths, cfg, plain):
        """One token per row, x (B, d): the self-attention writes its K/V
        at ``pos`` into ``kv`` in place; the cross-attention reads ck/cv
        (B, KV, F, D) over ``lengths`` entries."""
        B = x.shape[0]
        h, _ = attention_block_decode(
            self.self_attn, rms_norm(x, self.ln1, cfg.norm_eps), kv, pos, cfg,
            plain=plain)
        x = x + h
        q = column_parallel(rms_norm(x, self.ln_x, cfg.norm_eps), self.wq_x)
        attn = decode_attention(q.reshape(B, -1, cfg.head_dim),
                                ck, cv, lengths, plain=plain)
        x = x + row_parallel(attn.reshape(B, -1), self.wo_x)
        return self._mlp(x, cfg)


class EncDecLM(nn.Module):
    """The encoder-decoder on one device: ``embed``, ``enc_layers``,
    ``enc_norm``, ``dec_layers``, ``final_norm`` and ``lm_head``, named as
    the reference names them.  Weights start at zero, as in ``DenseLM``;
    ``plain_kernels`` runs the plain versions of the attention kernels
    (for comparisons only)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = model_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype
        self.plain_kernels = False
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = _param((v, d), dev, dtype)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, dev, dtype) for _ in range(cfg.encoder_layers))
        self.enc_norm = _param((d,), dev, dtype)
        self.dec_layers = nn.ModuleList(
            EncDecLayer(cfg, dev, dtype) for _ in range(cfg.num_layers))
        self.final_norm = _param((d,), dev, dtype)
        self.lm_head = _param((v, d), dev, dtype)

    def init_params(self, generator: torch.Generator) -> "EncDecLM":
        """Seeded weights by the reference's rules (``init_like_reference``)."""
        init_like_reference(self, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements by the port's names."""
        return {"embed": VOCAB_SPEC, "enc_layers": layer_specs(self.cfg),
                "enc_norm": NORM_SPEC, "dec_layers": DEC_LAYER_SPECS,
                "final_norm": NORM_SPEC, "lm_head": VOCAB_SPEC}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def extra_inputs(self, batch: int) -> dict:
        """The input beside the tokens, as the reference's bundle names it:
        {"audio_frames": ((batch, num_audio_frames, d_model), dtype)}, in
        the weights' dtype."""
        cfg = self.cfg
        return {"audio_frames": ((batch, cfg.num_audio_frames, cfg.d_model),
                                 self.dtype)}

    def _encoder(self, audio_frames, train: bool):
        """The normed encoder output (B, F, d) of the frames, taken in the
        weights' dtype; with ``train`` each layer runs under ``remat``."""
        x = torch.as_tensor(audio_frames, device=self.device).to(self.dtype)
        for layer in self.enc_layers:
            args = (x, self.cfg, self.plain_kernels)
            x = remat(layer, *args) if train else layer(*args)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def encode(self, audio_frames):
        """(B, F, d) frames, taken in the weights' dtype -> the normed
        encoder output (B, F, d)."""
        return self._encoder(audio_frames, train=False)

    @torch.no_grad()
    def prefill(self, tokens, audio_frames):
        """tokens: (B, S), every row S tokens long; audio_frames: (B,
        num_audio_frames, d_model).  Returns the logits (B, vocab) of the
        last token and the prefill cache."""
        cfg, plain = self.cfg, self.plain_kernels
        enc_out = self.encode(audio_frames)
        x = embed_lookup(self.embed, self._tokens(tokens))
        ks, vs, cks, cvs = [], [], [], []
        for layer in self.dec_layers:
            ck, cv = layer.cross_kv(enc_out, cfg)
            x, (k, v) = layer.prefill(x, ck, cv, cfg, plain)
            ks.append(k)
            vs.append(v)
            cks.append(ck.transpose(1, 2))
            cvs.append(cv.transpose(1, 2))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "ck": torch.stack(cks), "cv": torch.stack(cvs)}
        return model_logits(self, x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token per row.  cache: the dict of ``init_cache``; tokens:
        (B,); pos: scalar or (B,) positions.  Returns (logits (B, vocab)
        f32, cache), the self K/V written in place."""
        cfg, plain = self.cfg, self.plain_kernels
        x = embed_lookup(self.embed, self._tokens(tokens))
        pos = torch.as_tensor(pos, device=self.device)
        lengths = full_lengths(cache["ck"][0])
        for i, layer in enumerate(self.dec_layers):
            x = layer.decode(x, (cache["k"][i], cache["v"][i]), cache["ck"][i],
                             cache["cv"][i], pos, lengths, cfg, plain)
        return model_logits(self, x), cache

    def forward_loss(self, tokens, labels, audio_frames) -> torch.Tensor:
        """The reference's ``forward_loss``: the encoder over audio_frames
        (B, num_audio_frames, d_model), then the decoder over tokens (B,
        S), each layer projecting its cross K/V of the encoder output
        inside its ``remat``; the mean cross entropy of the f32 logits at
        every position against labels (B, S)."""
        enc_out = self._encoder(audio_frames, train=True)
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layer in self.dec_layers:
            x = remat(layer, x, enc_out, self.cfg, self.plain_kernels)
        return model_loss(self, x, self._tokens(labels))

    def init_cache(self, batch: int, max_len: int):
        """Zero bf16 leaves of the cache layout; KV is this rank's KV heads
        in a sharded model (``attention_share``), of the self-attention and
        of the cross projections."""
        cfg = self.cfg
        layer = self.dec_layers[0]
        attn = layer.self_attn
        heads = attention_share(attn["wq"], attn["wk"], cfg).kv_heads
        kv = (cfg.num_layers, batch, heads, max_len, cfg.head_dim)
        heads = attention_share(layer.wq_x, layer.wk_x, cfg).kv_heads
        frames = (cfg.num_layers, batch, heads,
                  cfg.num_audio_frames, cfg.head_dim)
        return {name: torch.zeros(shape, device=self.device, dtype=CACHE_DTYPE)
                for name, shape in (("k", kv), ("v", kv), ("ck", frames),
                                    ("cv", frames))}
