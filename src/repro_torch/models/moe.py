"""Top-k routed MoE FFN (olmoe, granite-moe), counterpart of ``repro.models.moe``.

``moe_block`` computes the reference's function in its three phases:

  * ``route``: f32 router logits, softmax over the E experts, the top K,
    renormalised over those K;
  * ``expert_positions``: each choice's position in its expert, by an
    exclusive cumsum over the (S * K) choices of a batch row in s-major,
    k-minor order; a choice at position >= C (``capacity_per_row``) is
    dropped, and the kept gates are not renormalised again;
  * ``expert_ffn``: the kept tokens scattered into an (E, B, C + 1, d)
    dispatch, the grouped expert products over all E experts (batched
    ``matmul``: f32 accumulation, results in x's dtype), and the
    gate-weighted sum over K in x's dtype.

Capacity and routing are per batch row, as in the reference: a (B, d)
decode input is B rows of one token (C = K, nothing dropped).  Dropped
choices go to slot C, which the reference multiplies by 0; here they are
masked out with ``torch.where`` instead, so a non-finite value in that
slot can never reach the output.  ``route`` is looked up as a module
attribute at every call, so a caller can wrap it (to record or replay the
chosen experts) without a hook in the serving path.

Sharded over ``model`` (``distributed.sharding.shard_model``), the router
stays whole and each rank routes, places and drops its own rows exactly
as unsharded (a data shard dispatches locally); the expert products use
this rank's slice of every expert's f, and the combined output is summed
over ``model``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (MODEL, copy_to_model, local,
                                              model_shard, reduce_from_model)
from repro_torch.models.layers import ACC_DTYPE, activate, matmul

# the reference's ``moe_defs`` placements: the experts' f over ``model``,
# the router whole
MOE_SPECS = {"router": (None, None), "w_gate": (None, None, MODEL),
             "w_up": (None, None, MODEL), "w_down": (None, MODEL, None)}


def moe_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """name -> (shape, kept in f32): the router (d, E) is f32 whatever the
    model's dtype; the experts are (E, d, f) and (E, f, d), ``w_gate``
    only for a gated activation."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": ((d, E), True), "w_up": ((E, d, f), False),
              "w_down": ((E, f, d), False)}
    if cfg.activation in ("swiglu", "geglu"):
        shapes["w_gate"] = ((E, d, f), False)
    return shapes


def capacity_per_row(seq: int, cfg: ArchConfig) -> int:
    c = math.ceil(seq * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return max(cfg.experts_per_token, min(c, seq))


def _no_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul(a, b) with TF32 off around it on the card."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    flags = torch.backends.cuda.matmul
    tf32 = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = tf32


class _IeeeF32Matmul(torch.autograd.Function):
    """(..., n, k) @ (k, m) in f32 without TF32, whatever the global
    setting, in the forward and in both products of the backward: TF32
    router logits would route differently from the reference, and TF32
    gradients would train the router off the reference's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _no_tf32_matmul(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _no_tf32_matmul(grad, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            # summed over every leading dim of a: (k, n') @ (n', m)
            db = _no_tf32_matmul(a.reshape(-1, a.shape[-1]).transpose(0, 1),
                                 grad.reshape(-1, grad.shape[-1]))
        return da, db


def _ieee_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (b a matrix) in f32 without TF32, its gradients too."""
    return _IeeeF32Matmul.apply(a, b)


def router_probs(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> the softmax over experts of the f32 logits, (B, S, E)."""
    logits = _ieee_f32_matmul(x.to(ACC_DTYPE), router.to(ACC_DTYPE))
    return torch.softmax(logits, dim=-1)


def route(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig):
    """Returns (gates, experts), each (B, S, K): the top K of the router's
    probabilities, largest first, renormalised over the K (f32)."""
    top_g, top_e = torch.topk(router_probs(router, x), cfg.experts_per_token,
                              dim=-1)
    return top_g / top_g.sum(dim=-1, keepdim=True), top_e


def expert_positions(top_e: torch.Tensor, num_experts: int):
    """(B, S, K) experts -> (B, S*K) position of each choice in its expert:
    how many earlier choices of its batch row, in s-major, k-minor order,
    picked the same expert."""
    B, S, K = top_e.shape
    onehot = torch.nn.functional.one_hot(top_e.reshape(B, S * K),
                                         num_experts)  # (B, S*K, E)
    cum = torch.cumsum(onehot, dim=1)  # inclusive
    return (onehot * (cum - 1)).sum(dim=-1)


def expert_ffn(p, x: torch.Tensor, top_g: torch.Tensor, top_e: torch.Tensor,
               pos: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The kept choices through their experts, weighted by their gates and
    summed over K.  x: (B, S, d); top_g, top_e: (B, S, K); pos: (B, S*K)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity_per_row(S, cfg)
    keep = pos < C  # (B, S*K)
    dest = torch.where(keep, pos, C)  # slot C takes the dropped choices
    e_flat = top_e.reshape(B, S * K)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    x_rep = x[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    # a kept (expert, slot) is taken by exactly one choice; the dropped
    # ones all land in slot C, which is never read
    buf = x.new_zeros((E, B, C + 1, d))
    buf[e_flat, b_idx, dest] = x_rep
    # (E, N, d) @ (E, d, f): one batched product per weight over the
    # experts, f32 accumulation, results in x's dtype
    buf = buf.reshape(E, B * (C + 1), d)
    up = matmul(buf, local(p["w_up"]))
    if "w_gate" in p:
        h = activate(matmul(buf, local(p["w_gate"])), cfg.activation) * up
    else:
        h = activate(up, cfg.activation)
    out = matmul(h, local(p["w_down"])).reshape(E, B, C + 1, d)
    picked = out[e_flat, b_idx, dest]  # (B, S*K, d)
    gate = top_g.reshape(B, S * K).to(x.dtype)[:, :, None]
    picked = torch.where(keep[:, :, None], picked * gate, 0)
    # with w_down sharded over ``model`` each rank holds a partial sum of
    # every expert's output; the gate-weighted sum over K is linear, so
    # summing its (B, S, d) result over ``model`` is the sum of the
    # (E, B, C + 1, d) buffer's, at 1 / (K * capacity factor) of the bytes
    return reduce_from_model(picked.reshape(B, S, K, d).sum(dim=2), p["w_down"])


def moe_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); a (B, d) input is one decode token per
    row."""
    if x.ndim == 2:
        return moe_block(p, x[:, None, :], cfg)[:, 0]
    # sharded over ``model``, the experts' output is summed after the gates
    # weigh it, so the gates' gradient, and through them the router's and
    # x's, is a partial sum on each rank: x enters both the router and the
    # dispatch through ``copy_to_model``, and the whole router's gradient
    # is summed over ``model`` with the rest
    partial = model_shard(p["w_down"]) is not None
    x = copy_to_model(x, p["w_up"])
    top_g, top_e = route(local(p["router"], partial_over_model=partial), x, cfg)
    pos = expert_positions(top_e, cfg.num_experts)
    return expert_ffn(p, x, top_g, top_e, pos, cfg)
