"""Dense decoder building blocks (PyTorch), counterpart of ``repro.models.layers``.

Conventions kept from the reference:

* Weights are stored as ``(d_in, d_out)`` and applied as ``x @ w``; layer
  parameters are dicts of tensors (``nn.ParameterDict`` in the model).
* ``matmul`` accumulates in f32 and returns x's dtype; norms, rope and
  softmax statistics run in f32.
* ``rms_norm`` multiplies by ``(1 + scale)``; ``apply_rope`` rotates the two
  halves of each head; ``geglu`` uses the tanh approximation of GELU.

Unlike the reference, whose model path uses a jnp chunked attention, the
attention here calls the port's kernels directly: ``causal_flash_attention``
and the encoders' and cross-attention's ``bidirectional_attention`` go to
the flash kernel (causal and non-causal modes, Sq != Sk for
cross-attention) and ``decode_attention`` to the decode kernel (over a
full cross-attention cache with ``full_lengths``).  ``plain=True`` takes their plain PyTorch versions instead; only
the models' ``plain_kernels``, which the chip smoke check sets to
compare the two, passes it.

Training shares two helpers: ``remat`` runs a layer under
``torch.utils.checkpoint`` and ``model_loss`` ends a decoder's loss.

Tensor parallelism (``distributed.sharding.shard_model``) makes the
weights DTensors; the functions here then follow the Megatron pattern and
hand every product and kernel plain local tensors of whole heads:
``attention_qkv`` and ``mlp_block`` multiply by column shards, the
attention kernels run on the heads of the rank's ``HeadShare`` (its own,
or, where its block of query columns cuts a head, every head the block
touches, the columns gathered over ``model`` before RoPE), ``wo`` and
``w_down`` give partial sums that ``row_parallel`` sums over ``model``
(of the attention, the rank's own columns: ``own_columns``), the
vocab-sharded
``embed_lookup`` zeroes the tokens outside its rows and sums, and
``lm_head_logits`` gathers the logits' vocabulary.  A plain weight takes
none of these steps.  Where a dense decoder's cache lays its positions
over ``model`` (the "seq" layout of ``sharding.kv_layout``), prefill
keeps every KV head (``attention_block_prefill(all_kv=True)``) and
``attention_block_decode_seq`` runs every query head over the rank's
block of positions and merges the ranks' outputs by their log-sum-exp.
``ATTENTION_SPECS``, ``MLP_SPECS``, ``NORM_SPEC`` and ``VOCAB_SPEC`` are
the reference's placements of these weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (MODEL, HeadShare, SeqShard,
                                             attention_share, copy_to_model,
                                             gather_from_model, gather_heads,
                                             local, merge_over_model,
                                             model_shard, reduce_from_model)
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_op,
                                                 flash_attention_ref)

ACC_DTYPE = torch.float32

# the reference's ParamDef specs (``attention_defs``, ``mlp_defs``, the
# norms and the vocab-sharded tables), by the port's names
NORM_SPEC = (None,)
VOCAB_SPEC = (MODEL, None)
ATTENTION_SPECS = {"wq": (None, MODEL), "wk": (None, MODEL),
                   "wv": (None, MODEL), "wo": (MODEL, None),
                   "bq": (MODEL,), "bk": (MODEL,), "bv": (MODEL,)}
MLP_SPECS = {"w_gate": (None, MODEL), "w_up": (None, MODEL),
             "w_down": (MODEL, None)}


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(ACC_DTYPE)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + local(scale).to(ACC_DTYPE))).to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "silu"):
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if kind == "relu_sq":
        return torch.relu(x).square()
    raise ValueError(f"unknown activation {kind!r}")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, output in x.dtype."""
    if x.dtype == w.dtype:
        # bf16 products accumulate in f32 on the card and on the CPU
        return torch.matmul(x, w)
    return torch.matmul(x.to(ACC_DTYPE), w.to(ACC_DTYPE)).to(x.dtype)


def column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``matmul(x, w)`` of a weight that may be sharded over ``model`` by
    columns: this rank's columns, with x (whole on every rank) entering
    through ``copy_to_model``, so that its gradient is summed over
    ``model``."""
    return matmul(copy_to_model(x, w), local(w))


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``matmul(x, w)`` of a weight that may be sharded over ``model`` by
    rows (x's last dim holds this rank's part): the partial products
    summed over ``model``."""
    return reduce_from_model(matmul(x, local(w)), w)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table``.  A table sharded over ``model`` by rows
    gives zeros for the tokens outside its rows, summed over ``model``."""
    tp = model_shard(table)
    if tp is None:
        return F.embedding(tokens, local(table))
    rows = local(table)
    idx = tokens - tp.rank * rows.shape[0]
    outside = (idx < 0) | (idx >= rows.shape[0])
    x = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows)
    return reduce_from_model(x.masked_fill(outside[..., None], 0), table)


class _F32Logits(torch.autograd.Function):
    """(N, d) x (V, d)^T of two bf16 CUDA tensors with f32 accumulation and
    an f32 output, with no f32 copy of the table.  ``torch.mm`` with
    ``out_dtype`` has no derivative, so the backward is written here: the
    f32 gradient of the logits is rounded to the operands' dtype once
    (an (N, V) copy, not a (V, d) one), and both products accumulate in
    f32."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=ACC_DTYPE)

    @staticmethod
    def backward(ctx, grad):
        x2, table = ctx.saved_tensors
        g = grad.to(x2.dtype)
        return g @ table, g.t() @ x2


def lm_head_logits(x: torch.Tensor, table: torch.Tensor,
                   valid_vocab: Optional[int] = None) -> torch.Tensor:
    """f32 logits of x against the (V_padded, d) table (possibly tied).

    Padded vocab rows (table rows >= valid_vocab) are masked to -1e30.
    A table sharded over ``model`` by rows gives its rows' logits, gathered
    over ``model``.
    """
    sharded = table
    x = copy_to_model(x, sharded)
    table = local(sharded)
    if x.dtype == ACC_DTYPE and table.dtype == ACC_DTYPE:
        logits = torch.matmul(x, table.t())
    elif x.device.type in ("cuda", "meta") and x.dtype == table.dtype:
        # bf16 operands, f32 accumulation and f32 output, with no f32 copy
        # of the table (the meta device, which the dry-run counts, takes the
        # card's path)
        x2 = x.reshape(-1, x.shape[-1])
        logits = _F32Logits.apply(x2, table)
        logits = logits.reshape(*x.shape[:-1], table.shape[0])
    else:
        logits = torch.matmul(x.to(ACC_DTYPE), table.to(ACC_DTYPE).t())
    logits = gather_from_model(logits, sharded)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits[..., valid_vocab:] = -1e30
    return logits


def cross_entropy_from_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Mean over (B, S) of logsumexp(logits) - logits[label], in f32, with
    no one-hot: the reference's ``cross_entropy_from_logits``."""
    logits = logits.to(ACC_DTYPE)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def _head_logits(model, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of a decoder's final-normed ``x`` against its ``lm_head``
    (its ``embed`` where it ties the two) over the padded vocabulary."""
    cfg = model.cfg
    table = model.embed if model.lm_head is None else model.lm_head
    return lm_head_logits(rms_norm(x, model.final_norm, cfg.norm_eps), table,
                          valid_vocab=cfg.vocab_size)


def model_logits(model, x: torch.Tensor) -> torch.Tensor:
    """A decoder's output: its ``final_norm``, then f32 logits against its
    ``lm_head`` (its ``embed`` where it ties the two), cut to the real
    vocabulary."""
    return _head_logits(model, x)[..., :model.cfg.vocab_size]


def model_loss(model, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """A decoder's training loss, the reference's ``forward_loss`` tail:
    the mean cross entropy of the f32 logits at every position over the
    padded vocabulary (padded rows at -1e30)."""
    return cross_entropy_from_logits(_head_logits(model, x), labels)


def remat(layer, *args):
    """``layer(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of the
    reference's ``jax.checkpoint``: only the layer's inputs stay alive, and
    every kernel in it, the flash forward too, runs once more in the
    backward."""
    return checkpoint(layer, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) or (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=ACC_DTYPE, device=x.device)
                     / half)
    angles = positions.to(ACC_DTYPE)[..., None] * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(ACC_DTYPE), x[..., half:].to(ACC_DTYPE)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def causal_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, window: int = 0,
                           plain: bool = False) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.

    q: (B, S, H, D); k, v: (B, S, KV, D).  Returns (B, S, H, D).
    """
    if plain:
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   window=window).transpose(1, 2)
    return flash_attention_op(q, k, v, window=window)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, plain: bool = False) -> torch.Tensor:
    """Full (non-causal) GQA attention of the encoders: every query over
    all keys.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Returns (B, Sq, H, D).
    """
    if plain:
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   causal=False).transpose(1, 2)
    return flash_attention_op(q, k, v, causal=False)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     plain: bool = False, return_lse: bool = False):
    """Single-token decode attention over a cache.

    q: (B, H, D); k_cache/v_cache: (B, KV, Smax, D); cache_len: scalar or
    (B,) number of valid entries.  A row with cache_len 0 returns zeros.
    With ``return_lse``: (out (B, H, D) f32, lse (B, H) f32), the
    kernel's partial-output mode.
    """
    if plain:
        B, H, D = q.shape
        KV = k_cache.shape[1]
        got = decode_attention_ref(q.reshape(B, KV, H // KV, D), k_cache,
                                   v_cache, cache_len, return_lse=return_lse)
        if return_lse:
            return got[0].reshape(B, H, D), got[1].reshape(B, H)
        return got.reshape(B, H, D)
    return decode_attention_op(q, k_cache, v_cache, cache_len,
                               return_lse=return_lse)


def full_lengths(cache: torch.Tensor) -> torch.Tensor:
    """(B,) int32 lengths that make every row of ``decode_attention``
    attend over all Smax entries of a (B, KV, Smax, D) cache (the
    cross-attention caches of the VLM and the enc-dec), made on the
    cache's device, with no copy from the host."""
    return torch.full((cache.shape[0],), cache.shape[2], dtype=torch.int32,
                      device=cache.device)


def call_heads(q: torch.Tensor, share: HeadShare, head_dim: int) -> torch.Tensor:
    """The query heads (..., share.kv_heads * share.group, D) of a rank's
    attention call from its query columns q (..., columns): gathered over
    ``model`` where a head is cut, then each run of query heads over one
    KV head padded to ``share.group`` by repeating its last head.  The
    padded heads' outputs are dropped (``own_columns``), so one kernel
    call with a uniform group size covers runs of unequal length.  At 8
    ways, for 3.125 heads of its own, a rank of hymba-1.5b runs 4 query
    heads (1 x 4 or 2 x 2) but ranks 3 and 4, which run 2 x 3, two of
    them padding: 36 heads over the 8 ranks for 25; qwen2-7b's ranks run
    1 x 4 each for 3.5, 32 for 28."""
    if share.gather is not None:
        q = gather_heads(q, share.gather)
    q = q.reshape(*q.shape[:-1], -1, head_dim)
    if not share.runs:
        return q
    parts = []
    for first, n in share.runs:
        parts.append(q[..., first:first + n, :])
        if n < share.group:
            last = q[..., first + n - 1:first + n, :]
            parts.append(last.expand(*last.shape[:-2], share.group - n, head_dim))
    return torch.cat(parts, dim=-2)


def own_columns(out: torch.Tensor, share: HeadShare) -> torch.Tensor:
    """The rank's own columns (..., qd / W) of its call's output ``out``
    (..., heads, D): of a padded call, the first ``count`` heads of every
    run, then the rank's block of their columns."""
    if share.runs:
        out = torch.cat([out[..., j * share.group:j * share.group + n, :]
                         for j, (_, n) in enumerate(share.runs)], dim=-2)
    out = out.reshape(*out.shape[:-2], -1)
    return out if share.cols is None else out[..., share.cols]


def attention_qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                  share: Optional[HeadShare] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,KV,D), rope applied.

    With ``wq`` sharded over ``model``, H and KV are the heads of this
    rank's call (``call_heads`` of its ``share``, by default
    ``attention_share`` of ``wq`` and ``wk``): RoPE rotates the pairs i
    and i + D/2 of a head, so it runs after the gather, on whole heads.  A
    replicated KV projection gives only the columns of the KV heads its
    query heads map to."""
    B, S, _ = x.shape
    D = cfg.head_dim
    x = copy_to_model(x, p["wq"])
    if share is None:
        share = attention_share(p["wq"], p["wk"], cfg)
    cols, replicated = share.kv_cols, share.replicated
    q = matmul(x, local(p["wq"]))
    k = matmul(x, local(p["wk"], partial_over_model=replicated)[:, cols])
    v = matmul(x, local(p["wv"], partial_over_model=replicated)[:, cols])
    if "bq" in p:
        q = q + local(p["bq"])
        k = k + local(p["bk"], partial_over_model=replicated)[cols]
        v = v + local(p["bv"], partial_over_model=replicated)[cols]
    q = call_heads(q, share, D)
    k = k.reshape(B, S, share.kv_heads, D)
    v = v.reshape(B, S, share.kv_heads, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def cross_kv(src: torch.Tensor, wq, wk, wv, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V of a cross-attention (the VLM's image, the enc-dec's
    encoder output) of ``src`` (B, F, d_src): k, v (B, F, KV, D), no rope,
    KV this rank's heads (``sharding.attention_share`` of ``wq`` and
    ``wk``; a cross layer's heads split whole).  ``src`` enters through
    ``copy_to_model`` wherever ``wq`` is sharded: each rank's K/V columns
    give a part of its gradient, also where the projections are whole and
    each rank takes its KV head's columns (their gradient is then summed
    over ``model`` too)."""
    B, F, _ = src.shape
    src = copy_to_model(src, wq)
    share = attention_share(wq, wk, cfg)
    return tuple(matmul(src, local(w, partial_over_model=share.replicated)
                        [:, share.kv_cols]).reshape(B, F, share.kv_heads, cfg.head_dim)
                 for w in (wk, wv))


def attention_block_prefill(p, x: torch.Tensor, cfg, *, window: int = 0,
                            plain: bool = False, all_kv: bool = False):
    """Returns (output (B,S,d), (k, v) for the cache, layout (B,KV,S,D)).

    KV is the KV heads of the rank's call, or with ``all_kv`` every KV
    head (the "seq" layout's cache; the KV projections are then whole on
    every rank, and the call takes its heads of them).  The block's own
    attention uses the unrounded k/v; the caller rounds them when it
    stores them in the cache.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    share = attention_share(p["wq"], p["wk"], cfg)
    if not all_kv:
        q, k, v = attention_qkv(p, x, positions, cfg, share)
        kc, vc = k, v
    else:
        q, kc, vc = attention_qkv(p, x, positions, cfg, share._replace(
            kv_heads=cfg.num_kv_heads, kv_cols=slice(None)))
        D, cols = cfg.head_dim, share.kv_cols
        heads = (slice(None) if cols.start is None
                 else slice(cols.start // D, cols.stop // D))
        k, v = kc[:, :, heads], vc[:, :, heads]
    out = causal_flash_attention(q, k, v, window=window, plain=plain)
    return (row_parallel(own_columns(out, share), p["wo"]),
            (kc.transpose(1, 2), vc.transpose(1, 2)))


def write_kv(cache: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write ``new`` (B, KV, 1, D) into ``cache`` (B, KV, Smax, D) at ``idx``,
    in place, and return ``cache``.

    ``idx`` is a scalar (one position for every row) or a (B,) vector (a
    position per row).  A row whose index is negative is left unchanged:
    the engine marks idle slots so, and their KV stays intact.  The write
    needs no host synchronisation: a skipped row writes back its own old
    value at position 0.
    """
    B = cache.shape[0]
    idx = torch.as_tensor(idx, device=cache.device).reshape(-1).expand(B)
    rows = torch.arange(B, device=cache.device)
    keep = (idx >= 0)[:, None, None]
    at = idx.clamp(min=0)
    old = cache[rows, :, at]  # (B, KV, D)
    cache[rows, :, at] = torch.where(keep, new[:, :, 0].to(cache.dtype), old)
    return cache


def attention_block_decode(p, x: torch.Tensor, kv_cache, pos, cfg, *,
                           window: int = 0, plain: bool = False):
    """x: (B, d), one token per row at position ``pos`` (scalar or (B,)).

    Writes K/V at ``pos`` (mod Smax for sliding-window ring buffers) into
    the cache in place and attends over the valid cache prefix,
    ``min(pos + 1, Smax)`` entries.  A row with ``pos < 0`` is idle: it
    writes no KV and attends over nothing (its output is discarded).
    """
    B = x.shape[0]
    k_cache, v_cache = kv_cache
    Smax = k_cache.shape[2]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    share = attention_share(p["wq"], p["wk"], cfg)
    q, k, v = attention_qkv(p, x[:, None, :], pos[:, None], cfg, share)
    active = pos >= 0
    write_idx = torch.where(active, pos % Smax, -1) if window > 0 else pos
    write_kv(k_cache, k.transpose(1, 2), write_idx)
    write_kv(v_cache, v.transpose(1, 2), write_idx)
    cache_len = torch.where(active, (pos + 1).clamp(max=Smax), 0)
    out = decode_attention(q[:, 0], k_cache, v_cache, cache_len, plain=plain)
    return row_parallel(own_columns(out, share), p["wo"]), (k_cache, v_cache)


def attention_block_decode_seq(p, x: torch.Tensor, kv_cache, pos, cfg,
                               seq: Optional[SeqShard], *, window: int = 0,
                               plain: bool = False):
    """``attention_block_decode`` over a cache of the "seq" layout
    (``sharding.kv_layout``): every KV head, at the rank's block ``seq``
    of the positions, or at all of them where ``seq`` is None (the cache's
    length does not split into the model ways).  With ``window`` the
    cache is a ring of R entries (the whole ring's, ``seq.chunk`` times
    the ways) and position p sits at ring index p % R, so the blocks are
    of ring indices.

    q is gathered over ``model``, so that the rank runs every query head,
    and k, v are computed for every KV head (the KV projections are whole
    on every rank).  Only the rank whose block holds ``pos`` (on a ring,
    ``pos % R``) writes them, there less ``seq.start``; a row with
    ``pos < 0`` is idle and writes nothing anywhere.  The valid entries
    are a prefix of the cache, ``pos + 1`` of them (on a ring
    ``min(pos + 1, R)``), so the kernel attends over the rank's block
    with row b over ``clamp(valid_b - seq.start, 0, seq.chunk)`` entries,
    and returns its f32 output with the LSE, which ``merge_over_model``
    merges over ``model``; over a whole cache the call is the output.
    The rank's own query columns then enter ``wo``'s rows."""
    B = x.shape[0]
    k_cache, v_cache = kv_cache
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = model_shard(p["wq"])
    block = H * D // tp.ways
    every = HeadShare(KV, slice(None), True, H // KV, tp,
                      cols=slice(tp.rank * block, (tp.rank + 1) * block))
    q, k, v = attention_qkv(p, x[:, None, :], pos[:, None], cfg, every)
    start, held = (0, k_cache.shape[2]) if seq is None else (seq.start, seq.chunk)
    # a ring of R entries holds position p at index p % R
    ring = (held if seq is None else held * seq.ways) if window > 0 else None
    at = pos - start if ring is None else pos % ring - start
    mine = (pos >= 0) & (at >= 0) & (at < held)
    write_kv(k_cache, k.transpose(1, 2), torch.where(mine, at, -1))
    write_kv(v_cache, v.transpose(1, 2), torch.where(mine, at, -1))
    # the block's part of the valid prefix (on a ring min(pos + 1, R),
    # which the clamp to the block gives)
    end = at + 1 if ring is None else pos + 1 - start
    cache_len = torch.where(pos >= 0, end.clamp(0, held), 0)
    if seq is None:
        out = decode_attention(q[:, 0], k_cache, v_cache, cache_len, plain=plain)
    else:
        out, lse = decode_attention(q[:, 0], k_cache, v_cache, cache_len,
                                    plain=plain, return_lse=True)
        out = merge_over_model(out, lse, seq).to(x.dtype)
    return row_parallel(own_columns(out, every), p["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# Dense MLP block
# ---------------------------------------------------------------------------


def mlp_block(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    x = copy_to_model(x, p["w_up"])
    if "w_gate" in p:
        h = (activate(matmul(x, local(p["w_gate"])), activation)
             * matmul(x, local(p["w_up"])))
    else:
        h = activate(matmul(x, local(p["w_up"])), activation)
    return row_parallel(h, p["w_down"])
