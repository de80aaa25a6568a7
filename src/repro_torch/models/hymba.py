"""Hymba (hymba-1.5b) in PyTorch, counterpart of ``repro.models.hymba``.

Each layer runs, on the same normed input, GQA attention heads (a sliding
window on most layers; ``cfg.full_attn_layers`` attend over the whole
prefix) and Mamba-style selective-scan heads (state ``cfg.ssm_state``),
fuses them as ``x + (norm(attn) + norm(ssm)) / 2`` and ends with a SwiGLU
MLP.  Attention goes through ``layers.attention_block_prefill`` and
``attention_block_decode``, so through the port's flash and decode
kernels; the Mamba heads are plain PyTorch, as the reference's are jnp
(no Pallas kernel backs them).

:class:`HymbaLM` holds one :class:`HymbaLayer` per layer in a flat list
(the reference groups them only for ``lax.scan``) and serves:

    prefill(tokens[, max_len])        -> (last logits, prefill cache)
    decode_step(cache, tokens, pos)   -> (logits, cache)
    init_cache(batch, max_len)        -> cache

and trains through ``forward_loss(tokens, labels)``, the reference's: the
prefill's function with fresh Mamba states and no cache, each layer
rematerialised (``layers.remat``).

The cache is a :class:`HymbaCache`, a dict of stacked leaves:

    k_full, v_full  (F, B, KV, max_len, D)       bf16, the F full layers
    k_swa, v_swa    (W_n, B, KV, min(W, max_len), D)  bf16, ring of the
                                                 sliding-window layers
    conv            (L, B, h, CONV_K - 1)        the weights' dtype
    ssm             (L, B, h, ssm_state)         f32

A prefill cache is a plain dict of the same keys, with S positions in
``k_full`` and min(S, W) in ``k_swa``.  ``decode_step`` updates the cache
in place.

Sharded (``distributed.sharding.shard_model``), h is the rank's h / W
Mamba channels and the KV cache takes the reference's layout over
``model`` (``kv_layout``).  hymba attends with a window, so wherever its
KV heads do not divide the model ways (5 over 2, 4 or 8) it is "seq":
every KV head, over the rank's block of the full layers' max_len
positions and of the rings' min(W, max_len) indices (``seq_shard``:
all of them where the ways do not divide the length), the blocks in
``HymbaCache.blocks``; decode runs ``layers.attention_block_decode_seq``
with the layer's window (q gathered, the decode kernel's LSE mode over
the block, ``merge_over_model``).  Elsewhere KV is the KV heads of the
rank's attention call (``sharding.attention_share``: every head its
block of the query columns touches).  The Mamba weights follow the
reference's specs over the channels, but for ``w_in``: its [x | z]
halves are split per half (``PAIRED_HALVES``), so that a rank holds
both halves of its channels; ``w_xdbc``'s rows give partial sums of the
low rank, B and C, summed over ``model``.

Deliberate divergences from the reference:

* position p of a sliding-window layer sits at ring index ``p % W`` after
  a prefill, as decode writes it; the reference keeps the last W rows at
  0..W-1, which breaks the ring once S > W and S % W != 0;
* the Mamba prefill takes any S >= 1 (a shorter last chunk); the
  reference asserts S % 128 == 0 once S > 128;
* the loss rematerialises every layer; the reference leaves its three
  full-attention layers out of ``jax.checkpoint``.  Recomputation changes
  no value, and a layer kept whole would hold its Mamba scan's f32
  intermediates through the whole backward;
* sharded, ``w_in`` is split per half where the reference's ``fit_spec``
  splits its 2h columns (the same bytes a rank); and where the KV heads
  divide the model ways (no production mesh) the KV projections are
  split over ``model`` and the cache keeps the "heads" layout, the
  rank's own KV heads over every position: the bytes of "seq", without
  its q gather and merge, the reference's dry-run's own rule for such
  heads but for the window.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import model_device
from repro_torch.distributed.sharding import (MODEL, SeqShard,
                                             attention_share, copy_to_model,
                                             kv_layout, local, model_mesh,
                                             model_shard, model_ways, seq_shard)
from repro_torch.models.layers import (ACC_DTYPE, ATTENTION_SPECS, MLP_SPECS,
                                       NORM_SPEC, attention_block_decode,
                                       attention_block_decode_seq,
                                       attention_block_prefill, embed_lookup,
                                       matmul, mlp_block, model_logits,
                                       model_loss, remat, rms_norm,
                                       row_parallel)
from repro_torch.models.rwkv import (MODEL_SPECS, ParamDef, _param,
                                     instantiate_all, model_defs)
from repro_torch.models.transformer import CACHE_DTYPE

SSM_CHUNK = 128
# tokens whose chunks one step of the prefill scan takes at once: 16
# chunks, (B, 2048, h, n) f32 tensors, 210 MB each at hymba-1.5b's widths
SCAN_BLOCK = 16 * SSM_CHUNK
CONV_K = 4
DT_RANK = 48


# ---------------------------------------------------------------------------
# Mamba head block
# ---------------------------------------------------------------------------


def mamba_defs(cfg: ArchConfig) -> dict:
    d, h, n = cfg.d_model, cfg.q_dim, cfg.ssm_state
    return {
        "w_in": ParamDef((d, 2 * h)),
        "conv_w": ParamDef((h, CONV_K), scale=0.5),
        "w_xdbc": ParamDef((h, DT_RANK + 2 * n)),
        "w_dt": ParamDef((DT_RANK, h), scale=0.1),
        "dt_bias": ParamDef((h,), "zeros"),
        "a_log": ParamDef((h, n), "decay_init", f32=True),
        "d_skip": ParamDef((h,), "ones"),
        "w_out": ParamDef((h, d)),
    }


# the reference's placements of ``mamba_defs``' weights: the h channels
# over ``model`` (``w_in`` as its (d, 2, h) view: ``sharding.PAIRED_HALVES``)
MAMBA_SPECS = {"w_in": (None, MODEL), "conv_w": (MODEL, None),
               "w_xdbc": (MODEL, None), "w_dt": (None, MODEL),
               "dt_bias": (MODEL,), "a_log": (MODEL, None), "d_skip": (MODEL,),
               "w_out": (MODEL, None)}


def mamba_channels(p, cfg: ArchConfig) -> int:
    """The Mamba channels of this rank: all h, or h / W over ``model``."""
    return cfg.q_dim // model_ways(p["conv_w"])


def _mamba_in(p, xin: torch.Tensor):
    """x, z (..., h) of the rank's channels: ``xin`` through ``w_in``'s
    columns, (d, 2h) or the local (d, 2, h) shard of its paired view,
    which reshapes to ``[x | z]`` of the same channels."""
    w = local(p["w_in"])
    xz = matmul(copy_to_model(xin, p["w_in"]), w.reshape(w.shape[0], -1))
    h = xz.shape[-1] // 2
    return xz[..., :h], xz[..., h:]


def _ssm_inputs(p, x: torch.Tensor, n: int):
    """dt (softplus, f32), B, C (f32) and A = -exp(a_log) of the conv
    output ``x`` (..., h).  Sharded, ``w_xdbc``'s rows give partial sums of
    dt's low rank, B and C, which every channel shares: summed over
    ``model``, then entering the rank's channels through
    ``copy_to_model`` (``w_dt``'s columns, and the scan of its channels,
    each take a part of their gradient)."""
    dbc = copy_to_model(row_parallel(x, p["w_xdbc"]), p["w_dt"])
    dt = F.softplus(matmul(dbc[..., :DT_RANK], local(p["w_dt"])).to(ACC_DTYPE)
                    + local(p["dt_bias"]).to(ACC_DTYPE))
    Bc = dbc[..., DT_RANK:DT_RANK + n].to(ACC_DTYPE)
    Cc = dbc[..., DT_RANK + n:].to(ACC_DTYPE)
    return dt, Bc, Cc, -torch.exp(local(p["a_log"]).to(ACC_DTYPE))


def _scan_chunks(decay: torch.Tensor, add: torch.Tensor):
    """Inclusive scan of s_t = decay_t * s_{t-1} + add_t along dim 1 of
    (N, C, h, n) f32 tensors, each of the N chunks from s = 0: returns (the
    product of decays up to t, s_t).  Log-depth doubling: at shift k each
    t >= k takes in the combined element k steps back, ceil(log2 C) steps
    in all.  Decays are multiplied, never divided, so nothing grows past 1
    (a factoring through exp(-cumsum(dt * A)) would overflow f32 at strong
    decays)."""
    C = decay.shape[1]
    k = 1
    while k < C:
        add = torch.cat([add[:, :k], decay[:, k:] * add[:, :-k] + add[:, k:]],
                        dim=1)
        decay = torch.cat([decay[:, :k], decay[:, k:] * decay[:, :-k]], dim=1)
        k *= 2
    return decay, add


def _ssm_scan(x, dt, Bc, Cc, A, d_skip, s0):
    """y_t = C_t . s_t + d_skip * x_t over s_t = exp(dt_t A) s_{t-1} +
    dt_t x_t B_t, all f32: x, dt (B, S, h), Bc, Cc (B, S, n), A (h, n),
    s0 (B, h, n).  Returns y (B, S, h) and the state after the last token.

    Chunks of SSM_CHUNK tokens (min(SSM_CHUNK, S) when shorter), as the
    reference's; a block of up to SCAN_BLOCK tokens scans all its chunks
    at once from zero (``_scan_chunks``) and then carries the state from
    chunk to chunk, so the launches per block do not grow with its chunks.
    The last chunk is padded with dt = 0 (decay 1, nothing added), which
    leaves every real token's state as it is."""
    Bsz, S, h = x.shape
    n = Bc.shape[-1]
    C = min(SSM_CHUNK, S)
    ys = []
    for b0 in range(0, S, SCAN_BLOCK):
        T = min(SCAN_BLOCK, S - b0)
        chunks = -(-T // C)
        pad = (0, 0, 0, chunks * C - T)
        dt_b, x_b, B_b, C_b = (F.pad(a[:, b0:b0 + T], pad)
                               for a in (dt, x, Bc, Cc))
        decay = torch.exp(dt_b[..., None] * A)  # (B, T', h, n)
        add = (dt_b * x_b)[..., None] * B_b[:, :, None, :]
        cum, s_in = _scan_chunks(decay.view(Bsz * chunks, C, h, n),
                                 add.view(Bsz * chunks, C, h, n))
        cum = cum.view(Bsz, chunks, C, h, n)
        s_in = s_in.view(Bsz, chunks, C, h, n)
        starts = []
        for c in range(chunks):
            starts.append(s0)
            s0 = s_in[:, c, -1] + cum[:, c, -1] * s0
        s_all = s_in + cum * torch.stack(starts, dim=1)[:, :, None]
        y = torch.einsum("bkchn,bkcn->bkch", s_all,
                         C_b.view(Bsz, chunks, C, n))
        ys.append(y.reshape(Bsz, chunks * C, h)[:, :T])
    return torch.cat(ys, dim=1) + d_skip * x, s0


def mamba_prefill(p, xin: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor):
    """xin: (B, S, d), any S >= 1; conv_state: (B, h, K-1) in the weights'
    dtype; ssm_state: (B, h, n) f32.  Returns (out (B, S, d), new conv
    state (the last K-1 pre-conv inputs), new ssm state f32)."""
    _, S, _ = xin.shape
    n = ssm_state.shape[-1]
    x, z = _mamba_in(p, xin)
    # causal depthwise conv over time, in the weights' dtype
    x_pad = torch.cat([conv_state.to(x.dtype), x.transpose(1, 2)], dim=-1)
    w = local(p["conv_w"])
    conv = x_pad[:, :, 0:S] * w[None, :, 0:1]
    for i in range(1, CONV_K):
        conv = conv + x_pad[:, :, i:i + S] * w[None, :, i:i + 1]
    new_conv_state = x_pad[:, :, -(CONV_K - 1):]
    x = F.silu(conv.transpose(1, 2))  # (B, S, h)
    dt, Bc, Cc, A = _ssm_inputs(p, x, n)
    y, ssm_state = _ssm_scan(x.to(ACC_DTYPE), dt, Bc, Cc, A,
                             local(p["d_skip"]).to(ACC_DTYPE),
                             ssm_state.to(ACC_DTYPE))
    y = y.to(xin.dtype) * F.silu(z)
    return row_parallel(y, p["w_out"]), new_conv_state, ssm_state


def mamba_decode(p, xin: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor):
    """xin: (B, d), one token per row.  Returns (out (B, d), new conv
    state, new ssm state f32)."""
    n = ssm_state.shape[-1]
    x, z = _mamba_in(p, xin)
    x_hist = torch.cat([conv_state.to(x.dtype), x[..., None]], dim=-1)
    conv = (x_hist * local(p["conv_w"])[None]).sum(dim=-1)
    x = F.silu(conv)
    dt, Bc, Cc, A = _ssm_inputs(p, x, n)
    xf = x.to(ACC_DTYPE)
    ssm_state = (ssm_state.to(ACC_DTYPE) * torch.exp(dt[..., None] * A)
                 + (dt * xf)[..., None] * Bc[:, None, :])
    y = torch.einsum("bhn,bn->bh", ssm_state, Cc)
    y = y + local(p["d_skip"]).to(ACC_DTYPE) * xf
    y = y.to(xin.dtype) * F.silu(z)
    return row_parallel(y, p["w_out"]), x_hist[:, :, 1:], ssm_state


# ---------------------------------------------------------------------------
# Hymba layer (parallel attention + mamba, mean fusion)
# ---------------------------------------------------------------------------


def hymba_layer_defs(cfg: ArchConfig) -> dict:
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    attn = {"wq": ParamDef((d, qd)), "wk": ParamDef((d, kvd)),
            "wv": ParamDef((d, kvd)), "wo": ParamDef((qd, d))}
    if cfg.qkv_bias:
        attn.update(bq=ParamDef((qd,), "zeros"), bk=ParamDef((kvd,), "zeros"),
                    bv=ParamDef((kvd,), "zeros"))
    return {
        "ln1": ParamDef((d,), "zeros"),
        "attn": attn,
        "mamba": mamba_defs(cfg),
        "fuse_na": ParamDef((d,), "zeros"),
        "fuse_ns": ParamDef((d,), "zeros"),
        "ln2": ParamDef((d,), "zeros"),
        "mlp": {"w_gate": ParamDef((d, f)), "w_up": ParamDef((d, f)),
                "w_down": ParamDef((f, d))},
    }


def layer_groups(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """The reference's ``_groups``: layer indices split into alternating
    ("full", 1) singletons and ("swa", count) runs, in layer order."""
    full = set(cfg.full_attn_layers)
    groups = []
    i = 0
    while i < cfg.num_layers:
        if i in full:
            groups.append(("full", 1))
            i += 1
        else:
            j = i
            while j < cfg.num_layers and j not in full:
                j += 1
            groups.append(("swa", j - i))
            i = j
    return groups


class HymbaLayer(nn.Module):
    """One layer's weights, named as the reference names them, and its
    attention ``window`` (0 on a full-attention layer)."""

    def __init__(self, cfg: ArchConfig, device, dtype, window: int):
        super().__init__()
        self.window = window
        for name, pdef in hymba_layer_defs(cfg).items():
            if isinstance(pdef, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: _param(sub, device, dtype) for k, sub in pdef.items()}))
            else:
                setattr(self, name, _param(pdef, device, dtype))

    def _fuse_and_mlp(self, x, attn_out, ssm_out, cfg):
        fused = 0.5 * (rms_norm(attn_out, self.fuse_na, cfg.norm_eps)
                       + rms_norm(ssm_out, self.fuse_ns, cfg.norm_eps))
        x = x + fused
        return x + mlp_block(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps),
                             cfg.activation)

    def forward(self, x, cfg, plain=False):
        """The training pass: the prefill from fresh (zero) Mamba states,
        keeping neither its K/V nor its states."""
        B, h = x.shape[0], mamba_channels(self.mamba, cfg)
        conv = torch.zeros((B, h, CONV_K - 1), device=x.device, dtype=x.dtype)
        ssm = torch.zeros((B, h, cfg.ssm_state), device=x.device,
                          dtype=ACC_DTYPE)
        return self.prefill(x, cfg, plain, conv, ssm)[0]

    def prefill(self, x, cfg, plain, conv_state, ssm_state, all_kv=False):
        """x: (B, S, d).  Returns (x, (k, v) (B, KV, S, D), conv, ssm); KV
        every KV head with ``all_kv`` (the "seq" layout's)."""
        h_in = rms_norm(x, self.ln1, cfg.norm_eps)
        # each branch takes the normed input through a node of its own, so
        # that its gradient is summed within the branch first, as a sharded
        # layer's ``copy_to_model`` sums it (the same bits, sharded or not)
        attn_out, kv = attention_block_prefill(self.attn, h_in.view_as(h_in), cfg,
                                               window=self.window, plain=plain,
                                               all_kv=all_kv)
        ssm_out, conv_state, ssm_state = mamba_prefill(
            self.mamba, h_in.view_as(h_in), conv_state, ssm_state)
        return self._fuse_and_mlp(x, attn_out, ssm_out, cfg), kv, conv_state, \
            ssm_state

    def decode(self, x, kv, pos, cfg, plain, conv_state, ssm_state,
               layout="heads", seq=None):
        """x: (B, d).  Writes K/V into ``kv`` in place (at ``pos``, or at
        ``pos % W`` on a ring; under the "seq" ``layout`` where the rank's
        block ``seq`` holds it) and returns (x, conv, ssm)."""
        h_in = rms_norm(x, self.ln1, cfg.norm_eps)
        if layout == "heads":
            attn_out, _ = attention_block_decode(self.attn, h_in, kv, pos, cfg,
                                                 window=self.window, plain=plain)
        else:
            attn_out, _ = attention_block_decode_seq(
                self.attn, h_in, kv, pos, cfg, seq, window=self.window, plain=plain)
        ssm_out, conv_state, ssm_state = mamba_decode(self.mamba, h_in,
                                                      conv_state, ssm_state)
        return self._fuse_and_mlp(x, attn_out, ssm_out, cfg), conv_state, \
            ssm_state


def _ring(kv: torch.Tensor, window: int) -> torch.Tensor:
    """The last min(S, W) positions of (B, KV, S, D) with position p at
    index p % W: positions S-W..S-1 rolled by S % W."""
    S = kv.shape[2]
    if S <= window:
        return kv
    return torch.roll(kv[:, :, S - window:], shifts=S % window, dims=2)


class HymbaCache(dict):
    """hymba's decode cache, the dict of its leaves, with ``blocks``: per
    KV kind ("full", "swa") the rank's block of the full layers' positions
    or of the rings' indices under the "seq" layout (``SeqShard``), or
    None where the leaves hold all of them.  As for ``sharding.KVCache``,
    the leaves alone cannot tell a block of a longer cache from a whole
    short one."""

    def __init__(self, leaves: dict, blocks: Dict[str, Optional[SeqShard]]):
        super().__init__(leaves)
        self.blocks = blocks

    def block(self, name: str) -> Optional[SeqShard]:
        """The block of leaf ``name`` ("k_full" ... "v_swa"); None for the
        Mamba states."""
        return self.blocks.get(name.partition("_")[2])


def _held(length: int, seq: Optional[SeqShard]) -> int:
    """How many of a cache's first ``length`` positions (or ring indices)
    lie in the block ``seq`` (all where None)."""
    return length if seq is None else min(max(length - seq.start, 0), seq.chunk)


WHOLE = {"full": None, "swa": None}


class HymbaLM(nn.Module):
    """hymba on one device (on the meta device, its weights are shapes
    alone; ``shard_model`` shards it).

    The weights start at zero; ``init_params`` draws them by the
    reference's rules (``a_log`` stays f32 in a bf16 model), and
    ``repro_torch.bridge.load_reference_params`` copies them from the
    reference's parameter tree.  Setting ``plain_kernels`` to True runs
    the plain PyTorch versions of the attention kernels (for comparisons
    only).
    """

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = model_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype
        self.plain_kernels = False
        full = set(cfg.full_attn_layers)
        defs = model_defs(cfg)  # embed, final_norm, lm_head: as rwkv's
        self.embed = _param(defs["embed"], dev, dtype)
        self.layers = nn.ModuleList(
            HymbaLayer(cfg, dev, dtype, 0 if i in full else cfg.sliding_window)
            for i in range(cfg.num_layers))
        self.final_norm = _param(defs["final_norm"], dev, dtype)
        self.lm_head = _param(defs["lm_head"], dev, dtype)
        # each layer's KV leaf and its index there
        counts = {"full": 0, "swa": 0}
        self._kv_slot = []
        for i in range(cfg.num_layers):
            kind = "full" if i in full else "swa"
            self._kv_slot.append((kind, counts[kind]))
            counts[kind] += 1

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "HymbaLM":
        """Draw every weight by its ``ParamDef`` rule, one at a time."""
        instantiate_all(self, model_defs(self.cfg), generator)
        layer_defs = hymba_layer_defs(self.cfg)
        for layer in self.layers:
            instantiate_all(layer, layer_defs, generator)
        return self

    def spec_tree(self) -> dict:
        """The reference's placements by the port's names: every layer's, a
        full-attention singleton's or a window run's, are the same."""
        layer = {"ln1": NORM_SPEC, "attn": ATTENTION_SPECS,
                 "mamba": MAMBA_SPECS, "fuse_na": NORM_SPEC,
                 "fuse_ns": NORM_SPEC, "ln2": NORM_SPEC, "mlp": MLP_SPECS}
        return {**MODEL_SPECS, "layers": layer}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def kv_layout(self) -> str:
        """The cache's layout over ``model``: ``sharding.kv_layout`` of the
        config at the weights' mesh ("heads" unsharded), but "heads" where
        the KV projections are split over ``model`` (the KV heads divide the
        model ways; see the module's divergences)."""
        layout = kv_layout(self.cfg, model_mesh(self))
        if layout == "seq" and model_shard(self.layers[0].attn["wk"]) is not None:
            return "heads"
        return layout

    def _blocks(self, max_len: int) -> Dict[str, Optional[SeqShard]]:
        """Under the "seq" layout the rank's blocks (``seq_shard``) of a
        cache of ``max_len`` positions: of the full layers' max_len and of
        the rings' min(W, max_len) indices; else ``WHOLE``."""
        if self.kv_layout() == "heads":
            return WHOLE
        wq = self.layers[0].attn["wq"]
        return {"full": seq_shard(wq, max_len),
                "swa": seq_shard(wq, min(self.cfg.sliding_window, max_len))}

    def _cache(self, batch: int, full: int, ring: int,
               kv_dtype: torch.dtype) -> dict:
        """Zero cache leaves for ``batch`` sequences: full-layer KV of
        ``full`` positions, ring KV of ``ring`` indices, every KV head
        under the "seq" layout, else the KV heads of the rank's attention
        call (``attention_share``); its Mamba channels."""
        cfg = self.cfg
        n_full = sum(kind == "full" for kind, _ in self._kv_slot)
        layer = self.layers[0]
        L, n = cfg.num_layers, cfg.ssm_state
        h = mamba_channels(layer.mamba, cfg)
        heads = (cfg.num_kv_heads if self.kv_layout() == "seq" else
                 attention_share(layer.attn["wq"], layer.attn["wk"], cfg).kv_heads)

        def kv(layers, positions):
            return torch.zeros((layers, batch, heads, positions,
                                cfg.head_dim), device=self.device,
                               dtype=kv_dtype)

        return {
            "k_full": kv(n_full, full), "v_full": kv(n_full, full),
            "k_swa": kv(L - n_full, ring), "v_swa": kv(L - n_full, ring),
            "conv": torch.zeros((L, batch, h, CONV_K - 1), device=self.device,
                                dtype=self.dtype),
            "ssm": torch.zeros((L, batch, h, n), device=self.device,
                               dtype=torch.float32),
        }

    @torch.no_grad()
    def prefill(self, tokens, *, max_len: Optional[int] = None):
        """tokens: (B, S), any S >= 1.  Returns the logits (B, vocab) of the
        last token and the prefill cache, a dict: the prompt's KV in the
        weights' dtype (S positions in a full layer, the ring of min(S, W)
        positions at p % W in a window layer) and the Mamba states after
        it.  Under the "seq" layout KV is every KV head, and with
        ``max_len`` (the positions of the cache it goes to) each rank keeps
        its blocks (``_blocks(max_len)``) of the prompt's positions and
        ring indices: a shorter or empty block where the prompt ends
        before it."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        x = embed_lookup(self.embed, tokens)
        seq_layout = self.kv_layout() == "seq"
        blocks = self._blocks(max_len) if max_len is not None else WHOLE
        cache = self._cache(B, _held(S, blocks["full"]),
                            _held(min(self.cfg.sliding_window, S), blocks["swa"]),
                            self.dtype)
        for i, (layer, (kind, j)) in enumerate(zip(self.layers, self._kv_slot)):
            x, (k, v), conv, ssm = layer.prefill(
                x, self.cfg, self.plain_kernels, cache["conv"][i],
                cache["ssm"][i], all_kv=seq_layout)
            if kind == "swa":
                k, v = _ring(k, layer.window), _ring(v, layer.window)
            seq = blocks[kind]
            if seq is not None:  # copied below: the whole prompt's KV goes now
                k, v = (t[:, :, seq.start:seq.start + seq.chunk] for t in (k, v))
            cache[f"k_{kind}"][j] = k
            cache[f"v_{kind}"][j] = v
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        return model_logits(self, x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token per row.  cache: the ``HymbaCache`` of ``init_cache``
        (under the "heads" layout a dict of its leaves will do); tokens:
        (B,); pos: scalar or (B,) positions, negative for an idle row (no
        KV write, output discarded; its Mamba state still steps).  Updates
        ``cache`` in place and returns (logits (B, vocab) f32, cache)."""
        layout = self.kv_layout()
        if layout == "seq" and not isinstance(cache, HymbaCache):
            raise ValueError(f"{self.cfg.name}: a cache of the \"seq\" layout "
                             "is the HymbaCache of init_cache, which says the "
                             "rank's blocks of positions")
        x = embed_lookup(self.embed, self._tokens(tokens))
        pos = torch.as_tensor(pos, device=self.device)
        for i, (layer, (kind, j)) in enumerate(zip(self.layers, self._kv_slot)):
            kv = (cache[f"k_{kind}"][j], cache[f"v_{kind}"][j])
            seq = cache.blocks[kind] if layout == "seq" else None
            x, conv, ssm = layer.decode(x, kv, pos, self.cfg,
                                        self.plain_kernels,
                                        cache["conv"][i], cache["ssm"][i],
                                        layout, seq)
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        return model_logits(self, x), cache

    def forward_loss(self, tokens, labels) -> torch.Tensor:
        """The reference's ``forward_loss``: tokens and labels (B, S), any
        S >= 1 (past the window too: the loss writes no ring); the mean
        cross entropy of the f32 logits at every position."""
        x = embed_lookup(self.embed, self._tokens(tokens))
        for layer in self.layers:
            x = remat(layer, x, self.cfg, self.plain_kernels)
        return model_loss(self, x, self._tokens(labels))

    def init_cache(self, batch: int, max_len: int) -> HymbaCache:
        """Zero leaves for ``batch`` sequences of ``max_len`` positions, the
        KV bf16: under the "seq" layout each KV leaf the rank's block
        (``_blocks``), or all of its positions where the model ways do not
        divide them."""
        blocks = self._blocks(max_len)
        ring = min(self.cfg.sliding_window, max_len)
        return HymbaCache(self._cache(batch, _held(max_len, blocks["full"]),
                                      _held(ring, blocks["swa"]), CACHE_DTYPE),
                          blocks)
