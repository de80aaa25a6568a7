"""Sharding conventions and helpers, the counterpart of
``repro.distributed.sharding`` over a torch ``DeviceMesh``.

Axes: ``pod`` (between hosts), ``data`` (the batch, and ZeRO-1 moments),
``model`` (tensor parallelism).  ``pod`` and ``data`` together are the
data-parallel group: the batch's rows, the gradients' average and the
ZeRO-1 slices run over their product, pod-major.  A spec is a tuple with
one entry per tensor dim: ``None``, an axis name or a tuple of axis names
(the reference's ``PartitionSpec`` as a plain tuple, which needs no JAX).
Each model class says the spec of every weight by the port's parameter
names (``spec_tree``); this module holds the rules that cross the
families:

* ``adapt_spec`` / ``fit_spec`` / ``zero_opt_specs``: the reference's
  rules, on the port's specs (drop absent axes; drop the innermost axis
  until the product divides the dim; a moment gains ``data`` on its first
  unsharded dim that divides into the data ways);
* ``fit_param_specs``: ``fit_spec`` of every weight, except that a KV head
  is never split: where ``num_kv_heads`` does not divide into the model
  ways, the KV projections stay whole on every rank, which uses the KV
  heads its query heads map to;
* ``shard_model``: every weight of a model of ``SHARDED_FAMILIES`` (dense
  and MoE decoders, the encoders, rwkv6, the VLM, the enc-dec, hymba)
  replaced in place by a ``DTensor`` of its placement (the counterpart of
  ``tree_shardings``); hymba's Mamba ``w_in`` as its (d, 2, h) view;
* ``attention_share``: the heads a rank's attention runs where its block
  of ``wq``'s columns cuts a head or straddles KV groups (the reference's
  even split of the query columns);
* ``kv_layout``: the reference's rule for a decode cache over ``model``,
  "heads" (each rank the KV heads of its call) or "seq" (every KV head
  over a block of the positions: ``seq_shard``, ``KVCache``), and
  ``merge_over_model``, which merges the ranks' partial attention
  outputs of a "seq" cache by their log-sum-exp;
* the Megatron collectives the layers call (``copy_to_model``,
  ``reduce_from_model``, ``gather_from_model``, each autograd-aware), the
  query columns' gather (``gather_heads``, whose gradient is
  reduce-scattered) and ``local``, which hands a kernel or a product the
  plain tensor of this rank's shard; its gradient is marked ``Partial``
  over ``pod`` and ``data`` (and over ``model`` for a replicated KV
  projection) until ``reduce_gradients`` sums it;
* the data-parallel and ZeRO-1 pieces of a train step: ``data_rows``,
  ``data_mean``, ``reduce_gradients``, ``zero_slice``, ``zero_write``,
  ``zero_moment`` and ``sum_over_model``.

A plain tensor passes through every helper unchanged, so an unsharded
model runs the same code with no collective.  Importing this module
touches no device and no process group.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

POD, DATA, MODEL = "pod", "data", "model"
AXES = (DATA, MODEL)
# the axes of the data-parallel group, outer first
DATA_AXES = (POD, DATA)

Spec = Tuple  # of None | str | Tuple[str, ...], one entry per tensor dim

# the families ``shard_model`` runs
SHARDED_FAMILIES = ("dense", "moe", "encoder", "ssm", "vlm", "audio", "hybrid")
# the families whose every attention is self-attention: their query heads
# may split anywhere (``attention_share``); the cross layers of the VLM and
# the enc-dec, and rwkv6's WKV heads, split whole
SPLIT_HEAD_FAMILIES = ("dense", "moe", "encoder", "hybrid")
# the attention weights that hold KV heads: whole on every rank where the
# KV heads do not divide into the model ways (self-attention, the enc-dec's
# cross projections, and the VLM's cross layers' ``wk``/``wv``)
KV_PROJECTIONS = ("attn.wk", "attn.wv", "attn.bk", "attn.bv", "wk_x", "wv_x")
_CROSS_KV = re.compile(r"(^|\.)cross_layers\.\d+\.w[kv]$")
# weights of (d, 2h) whose two column halves ([x | z], hymba's Mamba
# ``w_in``) are used channel by channel: ``shard_model`` shards their
# (d, 2, h) view on h, so that a rank holds both halves of its channels
# (the reference's split of the 2h columns would put every x channel on
# the first half of the ranks and every z channel on the rest)
PAIRED_HALVES = ("mamba.w_in",)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: ways} of a ``DeviceMesh``, or of a mapping that already
    is one (the tests' stand-in for a production mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _entry(axes) -> Optional[object]:
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# Specs: the reference's rules
# ---------------------------------------------------------------------------


def adapt_spec(spec, mesh) -> Spec:
    """Drop the axes a spec names that the mesh lacks (a single-host mesh
    has no ``pod``)."""
    if spec is None:
        return ()
    names = set(axis_sizes(mesh))
    return tuple(_entry(tuple(a for a in _axes(e) if a in names)) for e in spec)


def fit_spec(spec, shape, mesh) -> Spec:
    """``adapt_spec``, then per dim drop the innermost axis until the
    product of the axes' ways divides the dim (a batch of 1 cannot shard
    over ``data``)."""
    sizes = axis_sizes(mesh)
    entries = list(adapt_spec(spec, mesh))
    entries += [None] * (len(shape) - len(entries))
    fixed = []
    for dim, e in zip(shape, entries[:len(shape)]):
        axes = list(_axes(e))
        while axes and dim % math.prod(sizes[a] for a in axes):
            axes.pop()
        fixed.append(_entry(axes))
    return tuple(fixed)


def _zero_dim(spec, shape, data_ways: int) -> Optional[int]:
    """The dim on which a moment of a weight of ``spec`` and ``shape``
    gains ``data``: its first unsharded dim that divides into
    ``data_ways`` and is no smaller."""
    entries = list(spec) + [None] * (len(shape) - len(tuple(spec)))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % data_ways == 0 and dim >= data_ways:
            return i
    return None


def zero_opt_specs(param_specs: Mapping[str, Spec],
                   param_shapes: Mapping[str, tuple], data_ways: int,
                   axes=DATA):
    """AdamW's moments sharded over ``data`` too (ZeRO-1): each weight's
    spec with ``axes`` (``data``, or ``("pod", "data")`` on a mesh with
    pods, whose product is ``data_ways``) on its ``_zero_dim``.  Returns an
    ``AdamWState`` of specs (``step`` replicated, ``m`` and ``v`` by
    name)."""
    from repro_torch.training.optimizer import AdamWState

    def widen(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(tuple(spec)))
        i = _zero_dim(spec, shape, data_ways)
        if i is not None:
            entries[i] = axes
        return tuple(entries)

    m = {name: widen(spec, tuple(param_shapes[name]))
         for name, spec in param_specs.items()}
    return AdamWState(step=(), m=m, v=m)


def placements(spec, mesh) -> List:
    """DTensor placements of a spec: ``Shard(d)`` on each mesh dim that
    the spec's entry for tensor dim d names, ``Replicate()`` on the rest."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in _axes(e):
            out[names.index(a)] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor of ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(dim // math.prod(sizes[a] for a in _axes(e))
                 for dim, e in zip(shape, list(spec) + [None] * len(shape)))


# ---------------------------------------------------------------------------
# A model's placement table
# ---------------------------------------------------------------------------


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """The spec of every weight of ``model`` by its parameter name, from
    the model's ``spec_tree()``: a nested dict that mirrors the module
    tree, with a layer list's index left out (``layers.3.attn.wq`` is
    ``["layers"]["attn"]["wq"]``)."""
    tree = model.spec_tree()
    out = {}
    for name, p in model.named_parameters():
        node = tree
        for part in name.split("."):
            if not part.isdigit():
                node = node[part]
        if not isinstance(node, tuple) or len(node) != p.ndim:
            raise ValueError(f"{name}: spec {node!r} for a {p.ndim}-dim weight")
        out[name] = node
    return out


def holds_kv_heads(name: str) -> bool:
    """Whether the weight ``name`` projects onto KV heads (its columns, or
    a bias's entries, are whole KV heads)."""
    return name.endswith(KV_PROJECTIONS) or bool(_CROSS_KV.search(name))


def fit_param_specs(model: nn.Module, mesh) -> Dict[str, Spec]:
    """``fit_spec`` of every weight's spec at ``mesh``, with one rule of the
    port's own: a KV head is never split, so where ``num_kv_heads`` does
    not divide into the model ways the KV projections (``holds_kv_heads``)
    are replicated over ``model``.  (The reference's ``fit_spec`` checks
    only that the dim divides, and would split a KV head.)  The query
    projections keep the reference's placement, whole heads or not."""
    cfg = model.cfg
    ways = axis_sizes(mesh).get(MODEL, 1)
    specs = param_specs(model)
    out = {}
    for name, p in model.named_parameters():
        spec = fit_spec(specs[name], tuple(p.shape), mesh)
        if holds_kv_heads(name) and cfg.num_kv_heads % ways:
            spec = (None,) * p.ndim
        out[name] = spec
    return out


def per_gpu_bytes(model: nn.Module, mesh) -> Dict[str, int]:
    """Bytes one rank holds of ``model``'s weights (in their dtypes) and of
    AdamW's two f32 moments under ZeRO-1, from the placement table alone
    (``mesh`` may be a mapping of axis sizes; a model on the meta device
    allocates nothing)."""
    sizes = axis_sizes(mesh)
    specs = fit_param_specs(model, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    dp = tuple(a for a in DATA_AXES if a in sizes)
    moments = zero_opt_specs(specs, shapes, math.prod(sizes[a] for a in dp),
                             _entry(dp)).m
    weights = moment = 0
    for name, p in model.named_parameters():
        weights += math.prod(local_shape(shapes[name], specs[name], sizes)) * p.element_size()
        moment += 2 * 4 * math.prod(local_shape(shapes[name], moments[name], sizes))
    return {"weights": weights, "moments": moment}


def check_shardable(cfg, mesh) -> None:
    """Raise unless ``shard_model`` runs ``cfg`` on ``mesh``: a family of
    ``SHARDED_FAMILIES`` and a mesh of ``pod``, ``data`` and ``model``
    only, whose model ways W the heads take:

    * W divides the query columns ``num_heads * head_dim`` (hymba's Mamba
      channels are as many).  Each rank then owns the reference's block
      of qd / W columns of ``wq`` and ``bq`` and as many rows of ``wo``,
      and runs every whole head its block touches (``attention_share``);
      a wider axis, or one whose blocks are uneven, is refused.
    * The families of ``SPLIT_HEAD_FAMILIES`` (self-attention only) may
      cut a query head or straddle KV groups there.  The others keep the
      whole-head rule: the VLM's and the enc-dec's cross layers (their
      self layers have the same counts) need ``num_heads`` to split into
      W and each rank's share to map onto whole KV heads or into one;
      rwkv6's WKV heads split whole."""
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: sharded execution covers "
                                  f"{', '.join(SHARDED_FAMILIES)}; not the "
                                  f"{cfg.family} family")
    sizes = axis_sizes(mesh)
    if set(sizes) - {POD, DATA, MODEL}:
        raise ValueError(f"mesh axes {sorted(sizes)}: sharded execution takes "
                         f"{(POD, DATA, MODEL)} only")
    ways = sizes.get(MODEL, 1)
    columns = cfg.num_heads * cfg.head_dim
    if columns % ways:
        raise ValueError(f"{cfg.name}: {ways} model ways do not split the "
                         f"{columns} query columns into even blocks")
    if cfg.family in SPLIT_HEAD_FAMILIES:
        return
    kind = "WKV" if cfg.attn_free else "query"
    if cfg.num_heads % ways:
        raise ValueError(f"{cfg.name}: {cfg.num_heads} {kind} heads do not "
                         f"split into {ways} model ways (a head is never split "
                         f"in the {cfg.family} family)")
    local, group = cfg.num_heads // ways, cfg.num_heads // cfg.num_kv_heads
    if local % group and group % local:
        raise ValueError(f"{cfg.name}: {local} query heads a rank do not map "
                         f"onto whole KV heads of {group} query heads")


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Replace every weight of ``model`` in place by a ``DTensor`` on
    ``mesh`` of its placement (``fit_param_specs``), whose local tensor is
    this rank's contiguous shard of the weight it replaces.  A weight of
    ``PAIRED_HALVES`` becomes the DTensor of its (d, 2, h) view, sharded
    on h where its fitted spec shards the columns: the local (d, 2, h / W)
    shard reshapes to this rank's ``[x | z]`` and ``full_tensor()``
    reshapes back to the weight.  Every rank must hold the same weights.
    Returns the model."""
    check_shardable(model.cfg, mesh)
    specs = fit_param_specs(model, mesh)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is sharded already")
        shard, spec = p.detach(), specs[name]
        if name.endswith(PAIRED_HALVES):
            shard = shard.view(shard.shape[0], 2, shard.shape[1] // 2)
            spec = (spec[0], None, spec[1])
        place = placements(spec, mesh)
        for i, pl in enumerate(place):
            if pl.is_shard():
                size = shard.shape[pl.dim] // mesh.size(i)
                shard = shard.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        # a copy of its own: a shard of rows is a contiguous view, which
        # would keep the whole weight's storage alive
        shard = shard.clone(memory_format=torch.contiguous_format)
        module.register_parameter(leaf, nn.Parameter(
            DTensor.from_local(shard, mesh, place, run_check=False),
            requires_grad=p.requires_grad))
    return model


def model_mesh(model: nn.Module):
    """The mesh of a model that ``shard_model`` sharded, else None."""
    p = next(model.parameters())
    return p.device_mesh if isinstance(p, DTensor) else None


# ---------------------------------------------------------------------------
# Tensor parallelism: the collectives of the layers
# ---------------------------------------------------------------------------


_AVG, _SUM = Partial("avg"), Partial("sum")


class ModelShard(NamedTuple):
    group: object  # the ``model`` axis's process group
    ways: int
    rank: int  # this rank's coordinate along ``model``


def _axis(mesh, name: str):
    """(mesh dim, group, ways, this rank's coordinate) of axis ``name``, or
    None where the mesh lacks it.  Kept on the mesh: the layers ask for it
    several times a layer and every call."""
    axes = mesh.__dict__.setdefault("_axes_by_name", {})
    if name not in axes:
        names = list(mesh.mesh_dim_names)
        i = names.index(name) if name in names else None
        axes[name] = None if i is None else (
            i, mesh.get_group(i), mesh.size(i), mesh.get_coordinate()[i])
    return axes[name]


def model_shard(w) -> Optional[ModelShard]:
    """The ``model`` axis over which the DTensor ``w`` is sharded, or None
    for a plain tensor or one replicated over ``model``."""
    if not isinstance(w, DTensor):
        return None
    axis = _axis(w.device_mesh, MODEL)
    if axis is None or not w.placements[axis[0]].is_shard():
        return None
    return ModelShard(*axis[1:])


def local(w, *, partial_over_model: bool = False) -> torch.Tensor:
    """This rank's shard of ``w`` as a plain tensor (``w`` itself where it
    is one).  Its gradient reaches ``w.grad`` marked ``Partial`` over
    ``pod`` and ``data`` (each data rank's gradient comes from its own
    rows) and, with ``partial_over_model``, over ``model`` too (a
    replicated weight of which each model rank uses a part);
    ``reduce_gradients`` sums them."""
    if not isinstance(w, DTensor):
        return w
    if not torch.is_grad_enabled():
        return w.to_local()
    grads = [pl if pl.is_shard()
             else _AVG if name in DATA_AXES
             else _SUM if partial_over_model else pl
             for name, pl in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return w.to_local(grad_placements=grads)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` (Megatron's f,
    at the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums of a row-parallel product summed over ``model`` in
    place; the gradient passes through (Megatron's g)."""

    @staticmethod
    def forward(ctx, y, group):
        dist.all_reduce(y, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The last dim's shards gathered over ``model``; the gradient's own
    shard goes back."""

    @staticmethod
    def forward(ctx, y, group, ways, rank):
        ctx.ways, ctx.rank = ways, rank
        parts = [torch.empty_like(y) for _ in range(ways)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.ways, dim=-1)[ctx.rank].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` entering a product with ``w``'s column shard: unchanged, and
    its gradient summed over ``model`` where ``w`` is sharded over it."""
    tp = model_shard(w) if torch.is_grad_enabled() else None
    if tp is None:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(y: torch.Tensor, w) -> torch.Tensor:
    """``y``, a partial sum of a product with ``w``'s row shard, summed
    over ``model`` (in place) where ``w`` is sharded over it."""
    tp = model_shard(w)
    if tp is None:
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return _ReduceFromModel.apply(y, tp.group)
    dist.all_reduce(y, group=tp.group)
    return y


def gather_from_model(y: torch.Tensor, w) -> torch.Tensor:
    """``y``'s last dim, this rank's part of a product with ``w``'s row
    shard (the vocabulary of the LM head), gathered over ``model``."""
    tp = model_shard(w)
    if tp is None:
        return y
    return _GatherFromModel.apply(y, tp.group, tp.ways, tp.rank)


def model_ways(w) -> int:
    """The model ways over which ``w`` is sharded: 1 for a plain tensor or
    one replicated over ``model``."""
    tp = model_shard(w)
    return 1 if tp is None else tp.ways


class HeadShare(NamedTuple):
    """The heads one rank's attention call runs (``attention_share``).

    The call takes ``kv_heads`` KV heads, the columns ``kv_cols`` of the
    rank's K/V projection (all of a sharded one's; a whole one's given by
    its KV heads, whose gradient is then summed over ``model``:
    ``replicated``), and ``group`` query heads for each.  Where ``runs``
    is empty the rank's query columns are those heads as they are.  Else
    its q is first gathered over ``model`` where ``gather`` says so (a
    head is cut), and the call's heads are, per KV head, the query heads
    ``runs[j] = (first, count)`` of that q, padded to ``group`` by
    repeating the last; of the call's output, the first ``count`` heads of
    every run, in order, hold columns ``cols`` of the rank's own block."""
    kv_heads: int
    kv_cols: slice
    replicated: bool
    group: int
    gather: Optional[ModelShard] = None
    runs: Tuple[Tuple[int, int], ...] = ()
    cols: Optional[slice] = None


def _touched_heads(ways: int, rank: int, heads: int, kv_heads: int,
                   head_dim: int):
    """(runs, KV head range, own columns, cut) of rank ``rank`` of
    ``ways`` under the reference's even split of ``heads * head_dim``
    query columns: its columns [c0, c1) touch the whole heads
    c0 // D ... (c1 - 1) // D, which map to KV heads h // G; a run per KV
    head (its first touched head and their count), the KV heads
    [k0, k1), the rank's columns within the touched heads' and whether a
    head is cut at either end."""
    D, G = head_dim, heads // kv_heads
    block = heads * D // ways
    c0, c1 = rank * block, (rank + 1) * block
    h0, h1 = c0 // D, (c1 - 1) // D + 1
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    runs = tuple((max(h0, k * G), min(h1, (k + 1) * G) - max(h0, k * G))
                 for k in range(k0, k1))
    return runs, (k0, k1), slice(c0 - h0 * D, c1 - h0 * D), bool(c0 % D or c1 % D)


def attention_share(wq, wk, cfg) -> HeadShare:
    """The ``HeadShare`` of an attention's ``wq`` and ``wk``
    (self-attention's, or a cross layer's).  Unsharded, or with ``wk``
    sharded over ``model`` (the KV heads, so the query heads, split
    whole), the rank runs its own heads.  Else ``wk`` is whole and the
    rank owns ``wq``'s block of qd / W columns: it runs every whole head
    those columns touch over the KV heads they map to (``_touched_heads``),
    and needs the padding and the gather only where a head is cut or its
    heads straddle KV groups in runs of unequal length.

    qwen2-7b at 8 ways: 3.5 heads a rank, 4 touched over 1 KV head, one
    gather.  hymba-1.5b at 8 ways: 3.125 heads, up to 4 touched over up to
    2 KV heads; rank 3's runs are head 9 (KV 1) and heads 10-12 (KV 2),
    so its call runs 2 x 3 query heads, two of them padding."""
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = model_shard(wq)
    if tp is None:
        return HeadShare(KV, slice(None), False, H // KV)
    if model_shard(wk) is not None:
        return HeadShare(KV // tp.ways, slice(None), False, H // KV)
    runs, (k0, k1), cols, cut = _touched_heads(tp.ways, tp.rank, H, KV, D)
    group = max(n for _, n in runs)
    kv_cols = slice(k0 * D, k1 * D)
    if not cut and all(n == group for _, n in runs):
        return HeadShare(k1 - k0, kv_cols, True, group)
    # q's heads: all of them after a gather, else the rank's own from h0
    base = 0 if cut else runs[0][0]
    return HeadShare(k1 - k0, kv_cols, True, group, tp if cut else None,
                     tuple((first - base, n) for first, n in runs), cols)


class _GatherHeads(torch.autograd.Function):
    """The last dim's shards (the query columns) gathered over ``model``;
    the gradient reduce-scattered: each rank uses other ranks' columns
    (the heads its own block cuts), so a column's gradient is the sum of
    every rank's."""

    @staticmethod
    def forward(ctx, y, group, ways):
        ctx.group, ctx.ways = group, ways
        # the ranks' shards stacked on dim 0, as the collectives take them
        parts = y.new_empty((ways * y.shape[0], *y.shape[1:]))
        dist.all_gather_into_tensor(parts, y.contiguous(), group=group)
        parts = parts.view(ways, *y.shape).movedim(0, -2)
        return parts.reshape(*y.shape[:-1], ways * y.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        parts = grad.reshape(*grad.shape[:-1], ctx.ways, -1).movedim(-2, 0)
        out = grad.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out, parts.reshape(-1, *out.shape[1:]),
                                   group=ctx.group)
        return out, None, None


def gather_heads(q: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    """Every rank's query columns (..., qd / W) gathered over ``model``
    into (..., qd), in rank order."""
    return _GatherHeads.apply(q, tp.group, tp.ways)


# ---------------------------------------------------------------------------
# The KV cache's layout over ``model``
# ---------------------------------------------------------------------------

def kv_layout(cfg, mesh) -> str:
    """The layout of a decode cache over ``model``, by the rule of the
    reference's dry-run (``repro.launch.dryrun``, its decode cell):
    "heads" where the model ways divide ``num_kv_heads`` and the config
    attends with no window (and is not attention-free), else "seq".
    Unsharded (``mesh`` None) or over one model way, "heads": the two
    are then the same cache.  ``mesh`` may be a mapping of axis sizes."""
    ways = 1 if mesh is None else axis_sizes(mesh).get(MODEL, 1)
    if ways == 1 or (cfg.num_kv_heads % ways == 0 and not cfg.attn_free
                     and not cfg.sliding_window):
        return "heads"
    return "seq"


class SeqShard(NamedTuple):
    """A rank's block of a cache's positions under the "seq" layout: every
    KV head at positions [rank * chunk, (rank + 1) * chunk), in rank order
    over ``model`` (the contiguous blocks GSPMD gives a dim sharded over
    the axis)."""
    group: object  # the ``model`` axis's process group
    ways: int
    rank: int
    chunk: int

    @property
    def start(self) -> int:
        return self.rank * self.chunk


def seq_shard(wq, length: int) -> Optional[SeqShard]:
    """The block of a "seq" cache of ``length`` positions that this rank
    holds, for a model whose query projection ``wq`` is sharded over
    ``model``; None where ``wq`` is not, or where ``length`` does not
    split into the model ways: the reference's ``fit_spec`` then drops
    ``model`` from the positions, and every rank holds the whole cache."""
    tp = model_shard(wq)
    if tp is None or length % tp.ways:
        return None
    return SeqShard(tp.group, tp.ways, tp.rank, length // tp.ways)


class KVCache(tuple):
    """A dense decoder's cache: the pair (k, v), each (L, B, KV, positions,
    D), which unpacks and indexes as the pair does, with ``seq``, the
    rank's block of positions under the "seq" layout (``SeqShard``), or
    None where the cache holds every position.  The local tensors alone
    cannot tell a block of a longer cache from a whole short one."""

    seq: Optional[SeqShard]

    def __new__(cls, k: torch.Tensor, v: torch.Tensor,
                seq: Optional[SeqShard] = None):
        self = super().__new__(cls, (k, v))
        self.seq = seq
        return self

    def rows(self, rows: slice) -> "KVCache":
        """A view of rows ``rows`` of the batch (dim 1), with its ``seq``."""
        k, v = self
        return KVCache(k[:, rows], v[:, rows], self.seq)


def merge_partials(outs, lses) -> torch.Tensor:
    """The attention output over a whole cache from partial outputs over
    disjoint blocks of it, in the order given: ``outs[i]`` (..., D) f32
    and ``lses[i]`` (...), the log-sum-exp of each query's scaled scores
    over block i (-inf where it has no position), merged as
    sum_i e^(lse_i - M) out_i / sum_i e^(lse_i - M), M = max_i lse_i.  A
    query with no position in any block gives zeros."""
    top = torch.stack(list(lses)).amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num, den = torch.zeros_like(outs[0]), torch.zeros_like(lses[0])
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - top)
        num = num + w[..., None] * out
        den = den + w
    return num / torch.where(den > 0, den, torch.ones_like(den))[..., None]


def merge_over_model(out: torch.Tensor, lse: torch.Tensor,
                     seq: SeqShard) -> torch.Tensor:
    """``merge_partials`` of every rank's ``out`` (..., D) f32 and ``lse``
    (...) over its block of a "seq" cache, gathered over ``model`` (one
    all-gather of the two packed together) and merged in rank order, so
    that every rank computes the same bits.  No gradient: the decode
    step's alone."""
    packed = torch.cat([out, lse[..., None]], dim=-1).contiguous()
    parts = [torch.empty_like(packed) for _ in range(seq.ways)]
    dist.all_gather(parts, packed, group=seq.group)
    return merge_partials([p[..., :-1] for p in parts], [p[..., -1] for p in parts])


# ---------------------------------------------------------------------------
# Data parallelism and ZeRO-1
# ---------------------------------------------------------------------------


class DataShard(NamedTuple):
    group: object  # the process group of the ``pod`` x ``data`` ranks
    ways: int
    rank: int  # this rank's place among them, pod-major


def data_shard(mesh) -> Optional[DataShard]:
    """The data-parallel group of ``mesh``: its ``data`` axis, or the
    ``pod`` and ``data`` axes flattened into one, pod-major; None where
    the mesh has neither.  Kept on the mesh, as ``_axis`` keeps an axis."""
    axes = mesh.__dict__.setdefault("_axes_by_name", {})
    if DATA_AXES not in axes:
        dims = tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
        if not dims:
            axes[DATA_AXES] = None
        elif len(dims) == 1:
            axes[DATA_AXES] = DataShard(*_axis(mesh, dims[0])[1:])
        else:
            flat = mesh[dims]._flatten()
            axes[DATA_AXES] = DataShard(flat.get_group(), flat.size(),
                                        flat.get_local_rank())
    return axes[DATA_AXES]


def data_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's consecutive rows of a batch tensor.  Where the rows
    do not split into the ``pod`` x ``data`` ways, the reference's
    ``fit_spec`` rule: ``data``, the inner axis, is dropped first, and
    the rows are split over the axes that are left (``pod`` alone, or
    none: every rank runs every row)."""
    dp = data_shard(mesh)
    if dp is None:
        return t
    sizes = axis_sizes(mesh)
    dims = [a for a in DATA_AXES if a in sizes]
    while dims and t.shape[0] % math.prod(sizes[a] for a in dims):
        dims.pop()
    ways = math.prod(sizes[a] for a in dims)
    # the rank along the kept (outer) axes: the flattened rank's leading digits
    rank = dp.rank // (dp.ways // ways)
    return t.chunk(ways)[rank] if ways > 1 else t


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the data ranks."""
    dp = data_shard(mesh)
    if dp is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=dp.group)
    return x / dp.ways


@torch.no_grad()
def reduce_gradients(params) -> None:
    """Sum each DTensor weight's gradient over the mesh dims on which
    ``local`` marked it ``Partial`` (dividing an average by the ways), and
    leave it with its weight's placements: one all-reduce over the
    data-parallel group for ``pod`` and ``data``, then one over ``model``
    where it is partial there too."""
    for p in params:
        g = p.grad
        if not isinstance(g, DTensor):
            continue
        t = g.to_local().contiguous()
        mesh = g.device_mesh
        names = mesh.mesh_dim_names
        partial = [(i, pl) for i, pl in enumerate(g.placements) if pl.is_partial()]
        if any(names[i] in DATA_AXES for i, _ in partial):
            dp = data_shard(mesh)
            dist.all_reduce(t, group=dp.group)
            t.div_(dp.ways)
        for i, pl in partial:
            if names[i] not in DATA_AXES:
                dist.all_reduce(t, group=mesh.get_group(i))
                if pl.reduce_op == "avg":
                    t.div_(mesh.size(i))
        p.grad = DTensor.from_local(t, mesh, p.placements, run_check=False)


def _sharded_dims(t: DTensor):
    return {pl.dim for pl in t.placements if pl.is_shard()}


def _zero(t: DTensor):
    """(tensor dim, group, ways, rank) of the ZeRO-1 slice of a weight (or
    of its gradient, which has its placements) over the data-parallel
    group, or None."""
    dp = data_shard(t.device_mesh)
    if dp is None:
        return None
    spec = [DATA if d in _sharded_dims(t) else None for d in range(t.ndim)]
    dim = _zero_dim(spec, tuple(t.shape), dp.ways)
    return None if dim is None else (dim, dp.group, dp.ways, dp.rank)


def zero_slice(t) -> torch.Tensor:
    """The part of a weight or gradient that this rank's moments cover: a
    view of its local shard's slice over ``data`` (the whole of a plain
    tensor, or of a weight without a ZeRO dim)."""
    if not isinstance(t, DTensor):
        return t
    shard = t.to_local()
    z = _zero(t)
    if z is None:
        return shard
    dim, _, ways, rank = z
    return shard.chunk(ways, dim=dim)[rank]


@torch.no_grad()
def zero_write(p, new: torch.Tensor) -> None:
    """Write ``new``, the updated ``zero_slice(p)``, into the weight ``p``
    in its dtype: gathered over ``data`` into the local shard."""
    if not isinstance(p, DTensor):
        p.copy_(new)
        return
    shard = p.to_local()
    z = _zero(p)
    if z is None:
        shard.copy_(new)
        return
    dim, group, ways, _ = z
    new = new.to(shard.dtype).contiguous()
    parts = [torch.empty_like(new) for _ in range(ways)]
    dist.all_gather(parts, new, group=group)
    shard.copy_(torch.cat(parts, dim=dim))


def zero_moment(p: DTensor) -> DTensor:
    """A zero f32 moment of the DTensor weight ``p`` with the ZeRO-1
    placements: ``p``'s, plus ``Shard`` over ``pod`` and ``data`` on its
    ZeRO dim."""
    local_zeros = torch.zeros(zero_slice(p).shape, dtype=torch.float32,
                              device=p.device)
    place = list(p.placements)
    z = _zero(p)
    if z is not None:
        for i, name in enumerate(p.device_mesh.mesh_dim_names):
            if name in DATA_AXES:
                place[i] = Shard(z[0])
    return DTensor.from_local(local_zeros, p.device_mesh, place, run_check=False)


def sum_over_model(values: torch.Tensor, tensors) -> torch.Tensor:
    """``values[i]``, a sum over the local shard of ``tensors[i]``, summed
    over ``model`` where that tensor is sharded over it; the entries of
    tensors replicated over ``model`` are counted once."""
    shards = [model_shard(t) for t in tensors]
    first = next((s for s in shards if s is not None), None)
    if first is None:
        return values
    mask = torch.tensor([s is not None for s in shards], device=values.device)
    summed = values * mask
    dist.all_reduce(summed, group=first.group)
    return torch.where(mask, summed, values)

