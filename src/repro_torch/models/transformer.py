"""Dense and MoE decoder-only LM and encoder (PyTorch), counterparts of
``make_dense_lm`` and ``make_encoder``.

:class:`DenseLM` holds the weights of ``repro.models.transformer.dense_lm_defs``
in the same ``(d_in, d_out)`` layout, one :class:`DecoderLayer` per layer
(a Python loop over layers replaces ``lax.scan``); an MoE config (olmoe,
granite-moe) gives each layer the routed experts of ``models/moe.py`` in
place of the dense MLP.  It serves:

    prefill(tokens[, lengths][, max_len]) -> (last logits, (k, v))
    decode_step(cache, tokens, pos)    -> (logits, cache)
    init_cache(batch, max_len)         -> (k, v), each (L, B, KV, Smax, D) bf16

The KV cache is bf16 whatever the weights' dtype, as in the reference.
``decode_step`` updates the cache in place and returns it.  Sharded, the
cache takes the reference's layout over ``model``
(``sharding.kv_layout``): "heads", KV the KV heads of the rank's
attention call, or "seq" where the KV heads do not divide into the model
ways (qwen2.5-3b, qwen2-7b and glm4-9b at 8): every KV head over the
rank's block of Smax / W positions (``sharding.KVCache``, ``seq_shard``;
all Smax where W does not divide it), decoded by
``layers.attention_block_decode_seq``.  It trains
through

    forward_loss(tokens, labels)       -> mean cross entropy (f32)

the reference's ``forward_loss``: logits at every position, each layer
rematerialised in the backward (``torch.utils.checkpoint``, the
counterpart of its ``remat_layer``).  ``make_microbatched_loss`` splits a
batch into microbatches and runs each one's backward in turn.

:class:`EncoderLM` holds the weights of ``make_encoder`` (e5-base-v2, the
MiniLM reranker): :class:`EncoderLayer` runs non-causal attention, and

    prefill(tokens)                    -> (mean-pooled embedding, None)

It has no cache and no decode step.  It trains through

    forward_loss(tokens[, labels])     -> mean square of the pooled embedding

the reference's surrogate loss, each layer rematerialised as in
``DenseLM``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import model_device
from repro_torch.distributed.sharding import (KVCache, attention_share,
                                             kv_layout, model_mesh, seq_shard)
from repro_torch.models.layers import (ATTENTION_SPECS, MLP_SPECS, NORM_SPEC,
                                       VOCAB_SPEC, attention_block_decode,
                                       attention_block_decode_seq,
                                       attention_block_prefill, attention_qkv,
                                       bidirectional_attention, embed_lookup,
                                       mlp_block, model_logits, model_loss,
                                       own_columns, remat, rms_norm,
                                       row_parallel)
from repro_torch.models.moe import MOE_SPECS, moe_block, moe_shapes

CACHE_DTYPE = torch.bfloat16


def make_microbatched_loss(forward_loss: Callable, num_microbatches: int
                           ) -> Callable:
    """The reference's ``make_microbatched_loss`` in PyTorch's idiom: the
    returned ``loss_fn(batch)`` splits every (B, ...) tensor of ``batch``
    into ``num_microbatches`` consecutive slices of B / num_microbatches
    rows, runs ``forward_loss(**microbatch)`` and the backward of its loss
    over num_microbatches on each in turn (so only one microbatch's
    activations are alive at a time, and the reference's outer remat has
    no counterpart), and returns the mean loss, detached.  The gradients
    of the mean accumulate in each weight's ``.grad``, in the weight's
    dtype, as its own backward leaves them."""
    mu = max(1, num_microbatches)

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        rows = {name: t.shape[0] for name, t in batch.items()}
        if any(n % mu for n in rows.values()):
            raise ValueError(f"batch rows {rows} do not split into {mu} "
                             "microbatches")
        total = 0.0
        for parts in zip(*(t.chunk(mu) for t in batch.values())):
            loss = forward_loss(**dict(zip(batch, parts)))
            (loss / mu).backward()
            total = total + loss.detach()
        return total / mu

    return loss_fn


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


@torch.no_grad()
def init_like_reference(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight as the reference's ``ParamDef.instantiate`` does:
    normal * 1/sqrt(fan_in) with fan_in = shape[-2] (d for an MoE router
    and its (E, d, f) experts, f for (E, f, d); the embedding at scale
    1.0), norms, biases and the VLM's 0-dim gates zeros.  Each tensor is
    drawn on the device in f32 and cast to its own dtype (the gates' f32
    whatever the model's), one at a time."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim <= 1:  # ln1/ln2/final_norm/bq/bk/bv, gate/gate_mlp
            p.zero_()
            continue
        scale = 1.0 if leaf == "embed" else 1.0 / math.sqrt(p.shape[-2])
        draw = torch.randn(p.shape, generator=generator, device=p.device,
                           dtype=torch.float32)
        p.copy_(draw.mul_(scale))
        del draw


def attention_params(cfg: ArchConfig, device, dtype) -> nn.ParameterDict:
    """The reference's ``attention_defs``: wq, wk, wv, wo and, with
    ``qkv_bias``, bq, bk, bv."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
    return nn.ParameterDict({k: _param(s, device, dtype)
                             for k, s in shapes.items()})


def dense_mlp(cfg: ArchConfig, device, dtype) -> nn.ParameterDict:
    """The reference's ``mlp_defs``: w_gate (gated activations only), w_up
    and w_down."""
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.activation in ("swiglu", "geglu"):
        shapes = {"w_gate": (d, f), **shapes}
    return nn.ParameterDict({k: _param(s, device, dtype)
                             for k, s in shapes.items()})


def layer_specs(cfg: ArchConfig) -> dict:
    """The placements of a ``_Block``'s weights (``decoder_layer_defs``)."""
    return {"ln1": NORM_SPEC, "ln2": NORM_SPEC, "attn": ATTENTION_SPECS,
            "mlp": MOE_SPECS if cfg.is_moe else MLP_SPECS}


class _Block(nn.Module):
    """One layer's weights, named as the reference names them: ``ln1``,
    ``attn`` (wq, wk, wv, wo and the optional biases), ``ln2``, ``mlp``
    (the dense MLP, or an MoE model's router and experts)."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param((d,), device, dtype)
        self.attn = attention_params(cfg, device, dtype)
        self.ln2 = _param((d,), device, dtype)
        if cfg.is_moe:  # the router stays f32 whatever the model's dtype
            self.mlp = nn.ParameterDict(
                {k: _param(s, device, torch.float32 if f32 else dtype)
                 for k, (s, f32) in moe_shapes(cfg).items()})
        else:
            self.mlp = dense_mlp(cfg, device, dtype)

    def _ffn(self, x, cfg):
        """The reference's ``_ffn``: the routed experts of an MoE model,
        else the dense MLP."""
        x = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.is_moe:
            return moe_block(self.mlp, x, cfg)
        return mlp_block(self.mlp, x, cfg.activation)


class DecoderLayer(_Block):
    def forward(self, x, cfg, plain=False):
        """The training pass, ``decoder_layer_train``: the prefill's
        function without its cache.  (It is ``forward`` and not ``train``,
        which ``nn.Module`` keeps for the train/eval switch.)"""
        return self.prefill(x, cfg, plain)[0]

    def prefill(self, x, cfg, plain, all_kv=False):
        h, kv = attention_block_prefill(
            self.attn, rms_norm(x, self.ln1, cfg.norm_eps), cfg, plain=plain,
            all_kv=all_kv)
        x = x + h
        return x + self._ffn(x, cfg), kv

    def decode(self, x, kv, pos, cfg, plain, layout="heads", seq=None):
        """One token per row over the layer's cache ``kv`` of ``layout``;
        under "seq", at the rank's block ``seq`` (a ``SeqShard``) of the
        positions, or all of them (None)."""
        if layout == "heads":
            h, kv = attention_block_decode(
                self.attn, rms_norm(x, self.ln1, cfg.norm_eps), kv, pos, cfg,
                plain=plain)
        else:
            h, kv = attention_block_decode_seq(
                self.attn, rms_norm(x, self.ln1, cfg.norm_eps), kv, pos, cfg,
                seq, plain=plain)
        x = x + h
        return x + self._ffn(x, cfg), kv


class DenseLM(nn.Module):
    """A GQA/RoPE decoder, dense or MoE, on one device.

    The weights start at zero; ``init_params`` draws them from a generator,
    and ``repro_torch.bridge.load_reference_params`` copies them from the
    reference's parameter tree.  Setting ``plain_kernels`` to True runs
    the plain PyTorch versions of the attention kernels (for comparisons
    only).  On the meta device (``device="meta"``) the weights are shapes
    alone, for placement tables (``distributed.sharding.per_gpu_bytes``).
    """

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
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dev, dtype) for _ in range(cfg.num_layers))
        self.final_norm = _param((d,), dev, dtype)
        self.lm_head = None if cfg.tie_embeddings else _param((v, d), dev, dtype)

    def init_params(self, generator: torch.Generator) -> "DenseLM":
        """Seeded weights by the reference's rules (``init_like_reference``)."""
        init_like_reference(self, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements (``dense_lm_defs``) by the port's
        names (``distributed.sharding.param_specs``)."""
        return {"embed": VOCAB_SPEC, "lm_head": VOCAB_SPEC,
                "final_norm": NORM_SPEC, "layers": layer_specs(self.cfg)}

    # -- model-facing helpers --
    def _embed_in(self, tokens):
        x = embed_lookup(self.embed, tokens)
        if self.cfg.name.startswith("gemma"):
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def kv_layout(self) -> str:
        """The cache's layout over ``model``: ``sharding.kv_layout`` of the
        config at the mesh the weights are sharded on ("heads" unsharded)."""
        return kv_layout(self.cfg, model_mesh(self))

    @torch.no_grad()
    def prefill(self, tokens, lengths: Optional[torch.Tensor] = None, *,
                max_len: Optional[int] = None):
        """tokens: (B, S).  Returns the logits (B, vocab) of the last token
        (of token ``lengths[b]-1`` when given) and the prompt's KV, each
        (L, B, KV, S, D) in the weights' dtype.  Under the "seq" layout KV
        is every KV head, and with ``max_len`` (the positions of the cache
        it goes to) each rank returns its block of them that the prompt
        fills: positions [r c, (r + 1) c) of S, c = max_len / W (all S
        where W does not divide max_len), an empty block past the
        prompt."""
        tokens = self._tokens(tokens)
        x = self._embed_in(tokens)
        seq_layout = self.kv_layout() == "seq"
        seq = (seq_shard(self.layers[0].attn["wq"], max_len)
               if seq_layout and max_len is not None else None)
        ks, vs = [], []
        for layer in self.layers:
            x, (k, v) = layer.prefill(x, self.cfg, self.plain_kernels,
                                      all_kv=seq_layout)
            if seq is not None:  # a copy: the whole prompt's KV goes now
                k = k[:, :, seq.start:seq.start + seq.chunk].contiguous()
                v = v[:, :, seq.start:seq.start + seq.chunk].contiguous()
            ks.append(k)
            vs.append(v)
        if lengths is None:
            last = x[:, -1]
        else:
            lengths = torch.as_tensor(lengths, device=self.device).long()
            last = x[torch.arange(x.shape[0], device=self.device), lengths - 1]
        return model_logits(self, last), (torch.stack(ks), torch.stack(vs))

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token per row.  cache: (k, v), each (L, B, KV, Smax, D), or
        under the "seq" layout the ``KVCache`` of ``init_cache`` (or a view
        of its rows); tokens: (B,); pos: scalar or (B,) positions, negative
        for an idle row (no KV write, output discarded).  Updates ``cache``
        in place and returns (logits (B, vocab) f32, cache)."""
        x = self._embed_in(self._tokens(tokens))
        pos = torch.as_tensor(pos, device=self.device)
        layout = self.kv_layout()
        if layout == "seq" and not isinstance(cache, KVCache):
            raise ValueError(f"{self.cfg.name}: a cache of the \"seq\" layout "
                             "is the KVCache of init_cache, which says the "
                             "rank's block of positions")
        seq = cache.seq if layout == "seq" else None
        k_all, v_all = cache
        for i, layer in enumerate(self.layers):
            x, _ = layer.decode(x, (k_all[i], v_all[i]), pos, self.cfg,
                                self.plain_kernels, layout, seq)
        return model_logits(self, x), cache

    def forward_loss(self, tokens, labels) -> torch.Tensor:
        """The reference's ``forward_loss``: tokens and labels (B, S); the
        mean cross entropy of the f32 logits at every position over the
        padded vocabulary (padded rows at -1e30).  Each layer runs under
        ``torch.utils.checkpoint`` (non-reentrant): its activations are
        recomputed in the backward, as the reference's ``remat_layer``
        does, so the flash forward runs twice per layer."""
        x = self._embed_in(self._tokens(tokens))
        for layer in self.layers:
            x = remat(layer, x, self.cfg, self.plain_kernels)
        return model_loss(self, x, self._tokens(labels))

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """(k, v), each (L, batch, KV, positions, D) bf16 zeros, as a
        ``KVCache``.  Under the "heads" layout (unsharded included) KV is
        the KV heads of this rank's attention call (``attention_share``)
        and positions max_len; under "seq" KV is every KV head and
        positions the rank's block of max_len / W (``seq``), or all
        max_len where the model ways W do not divide it."""
        cfg = self.cfg
        attn = self.layers[0].attn
        seq = None
        if self.kv_layout() == "heads":
            kv_heads = attention_share(attn["wq"], attn["wk"], cfg).kv_heads
        else:
            kv_heads = cfg.num_kv_heads
            seq = seq_shard(attn["wq"], max_len)
        positions = max_len if seq is None else seq.chunk
        shape = (cfg.num_layers, batch, kv_heads, positions, cfg.head_dim)
        return KVCache(torch.zeros(shape, device=self.device, dtype=CACHE_DTYPE),
                       torch.zeros(shape, device=self.device, dtype=CACHE_DTYPE),
                       seq)


class EncoderLayer(_Block):
    """``encoder_layer``: rope at positions 0..S-1, non-causal attention,
    the MLP (GELU with no gate for the encoders), pre-norm residuals."""

    def forward(self, x, cfg, plain=False):
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        share = attention_share(self.attn["wq"], self.attn["wk"], cfg)
        q, k, v = attention_qkv(self.attn, rms_norm(x, self.ln1, cfg.norm_eps),
                                positions, cfg, share)
        h = bidirectional_attention(q, k, v, plain=plain)
        x = x + row_parallel(own_columns(h, share), self.attn["wo"])
        return x + self._ffn(x, cfg)


class EncoderLM(nn.Module):
    """An encoder-only model on one device (e5-base-v2, the MiniLM
    reranker), counterpart of ``make_encoder``: ``embed``, ``layers`` and
    ``final_norm``, no LM head.  Weights start at zero, as in ``DenseLM``;
    ``plain_kernels`` runs the plain version of the attention kernel
    (for comparisons only)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = model_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype
        self.plain_kernels = False
        d = cfg.d_model
        self.embed = _param((cfg.padded_vocab, d), dev, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dev, dtype) for _ in range(cfg.num_layers))
        self.final_norm = _param((d,), dev, dtype)

    def init_params(self, generator: torch.Generator) -> "EncoderLM":
        """Seeded weights by the reference's rules (``init_like_reference``)."""
        init_like_reference(self, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements (``make_encoder``'s defs)."""
        return {"embed": VOCAB_SPEC, "final_norm": NORM_SPEC,
                "layers": layer_specs(self.cfg)}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _pooled(self, x):
        """The mean over S of the final-normed states, (B, d_model), taken
        in f32 and returned in x's dtype."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x.float().mean(dim=1).to(x.dtype)

    @torch.no_grad()
    def prefill(self, tokens):
        """tokens: (B, S), every row S tokens long (no padding mask, as in
        the reference).  Returns the pooled embedding (``_pooled``) and
        None (an encoder keeps no cache)."""
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layer in self.layers:
            x = layer(x, self.cfg, self.plain_kernels)
        return self._pooled(x), None

    def forward_loss(self, tokens, labels=None) -> torch.Tensor:
        """The reference's surrogate loss: the mean of the squares of the
        pooled embedding, in f32.  ``labels`` is taken and ignored, as the
        reference's batch carries it.  Each layer runs under ``remat``."""
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layer in self.layers:
            x = remat(layer, x, self.cfg, self.plain_kernels)
        return self._pooled(x).float().square().mean()
