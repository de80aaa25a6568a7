"""Load the reference's parameters into the port's models.

The reference keeps its parameters as a pytree of arrays in which every
per-layer leaf carries a leading ``L`` dim (the layer stack its
``lax.scan`` consumes).  The bridge takes that tree with its leaves as
**numpy arrays** (``jax.tree.map(np.asarray, params)``), so this module
needs neither JAX nor ``ml_dtypes``: a bf16 leaf (numpy dtype name
``"bfloat16"``) is reinterpreted bit for bit through ``uint16``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hymba import HymbaLM, layer_groups
from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import DenseLM, EncoderLM
from repro_torch.models.vision import VisionLM


def to_torch(arr) -> torch.Tensor:
    """A CPU tensor with the same bits and shape as the numpy array ``arr``
    (a 0-dim array, as the VLM's gates, stays 0-dim)."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _copy(dst: torch.Tensor, src, where: str) -> None:
    t = to_torch(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, model has "
                         f"{tuple(dst.shape)}")
    dst.data.copy_(t.to(dtype=dst.dtype))


def _check_keys(have: Mapping, want, where: str) -> None:
    if set(have) != set(want):
        raise ValueError(f"{where}: reference keys {sorted(have)} != "
                         f"model keys {sorted(want)}")


def _copy_layer(layer, tree: Mapping, pick, where: str) -> None:
    """Copy one layer's leaves from ``tree``, each through ``pick`` (the
    layer's row of a stacked leaf, or the leaf itself): the layer's own
    tensors (``ln1``, ``ln2``, ...) and its groups of tensors (``attn``,
    ``mlp``, ``mamba``, ``tm``/``cm``), by the reference's names."""
    tensors = [name for name, _ in layer.named_parameters(recurse=False)]
    groups = [name for name, _ in layer.named_children()]
    _check_keys(tree, tensors + groups, where)
    for name in tensors:
        _copy(getattr(layer, name), pick(tree[name]), f"{where}.{name}")
    for group in groups:
        mine = getattr(layer, group)
        _check_keys(tree[group], mine.keys(), f"{where}.{group}")
        for key, leaf in tree[group].items():
            _copy(mine[key], pick(leaf), f"{where}.{group}.{key}")


def _stack(layers, tree: Mapping, name: str, lead: tuple, pick):
    """(layer, tree, pick, where) for ``layers`` stacked in ``tree`` along
    the leading dims ``lead``: layer i takes ``pick(a, i)`` of each leaf.
    Every leaf's leading dims must be ``lead``."""
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            for sub, a in leaf.items():
                _check_lead(a, lead, f"{name}.{key}.{sub}")
        else:
            _check_lead(leaf, lead, f"{name}.{key}")
    return [(layer, tree, lambda a, i=i: pick(a, i), f"{name}[{i}]")
            for i, layer in enumerate(layers)]


def _check_lead(a, lead: tuple, where: str) -> None:
    if tuple(np.shape(a)[:len(lead)]) != lead:
        raise ValueError(f"{where}: leading dims {np.shape(a)[:len(lead)]}, "
                         f"model has {lead} layers")


def _layer_trees(model, params: Mapping):
    """(layer, tree, pick, where) for every layer of ``model``.  The dense,
    rwkv and encoder trees stack all layers under ``layers``; the VLM
    stacks its self layers twice, (G, per, ...), under ``self_layers``
    (layer g * per + j takes [g][j]) and its cross layers once under
    ``cross_layers``; the enc-dec stacks ``enc_layers`` and ``dec_layers``;
    hymba's ``groups`` follow ``layer_groups(cfg)``: a full-attention group
    is one unstacked layer, a sliding-window group ``count`` layers stacked
    along a leading dim."""
    if isinstance(model, VisionLM):
        per = model.per
        groups = len(model.cross_layers)
        return (_stack(model.self_layers, params["self_layers"], "self_layers",
                       (groups, per), lambda a, i: a[i // per][i % per])
                + _stack(model.cross_layers, params["cross_layers"],
                         "cross_layers", (groups,), lambda a, i: a[i]))
    if isinstance(model, EncDecLM):
        return [entry for name in ("enc_layers", "dec_layers")
                for entry in _stack(getattr(model, name), params[name], name,
                                    (len(getattr(model, name)),),
                                    lambda a, i: a[i])]
    if not isinstance(model, HymbaLM):
        return _stack(model.layers, params["layers"], "layers",
                      (len(model.layers),), lambda a, i: a[i])
    plan = layer_groups(model.cfg)
    groups = params["groups"]
    if len(groups) != len(plan):
        raise ValueError(f"groups: {len(groups)} in the reference, model has "
                         f"{len(plan)} {plan}")
    out, first = [], 0
    for g, ((kind, count), tree) in enumerate(zip(plan, groups)):
        if kind == "swa" and np.shape(tree["ln1"])[0] != count:
            raise ValueError(f"groups[{g}]: {np.shape(tree['ln1'])[0]} "
                             f"layers, model has {count}")
        for j in range(count):
            pick = (lambda a: a) if kind == "full" else (lambda a, j=j: a[j])
            out.append((model.layers[first + j], tree, pick,
                        f"groups[{g}][{j}]"))
        first += count
    return out


@torch.no_grad()
def load_reference_params(model, params: Mapping):
    """Copy a reference parameter tree into a ``DenseLM``, ``RWKVLM``,
    ``EncoderLM``, ``HymbaLM``, ``VisionLM`` or ``EncDecLM``.

    ``params`` is the tree of ``build_model(cfg).init(key)`` with numpy
    leaves.  The model's own tensors (``embed``, ``final_norm``,
    ``lm_head``, the enc-dec's ``enc_norm``) take the leaves of their name;
    each layer's leaves are taken from its layer stack (its row of every
    stacked leaf) or, for hymba, from its group (``_layer_trees``); a
    layer's own tensors and its groups of tensors take the reference's
    names; an MoE model's ``mlp`` group is its router and (E, ...) experts.
    Values are cast to each weight's dtype (the model's, or f32 for the
    rwkv ``w0`` and ``u``, the MoE ``router``, hymba's ``a_log`` and the
    VLM's gates); with equal dtypes the copy is bit-exact.
    """
    if not isinstance(model, (DenseLM, RWKVLM, EncoderLM, HymbaLM, VisionLM,
                              EncDecLM)):
        raise TypeError(f"no bridge for {type(model).__name__}")
    own = [name for name, _ in model.named_parameters(recurse=False)]
    stacks = (["groups"] if isinstance(model, HymbaLM)
              else [name for name, _ in model.named_children()])
    _check_keys(params, own + stacks, "params")
    for name in own:
        _copy(getattr(model, name), params[name], name)
    for layer, tree, pick, where in _layer_trees(model, params):
        _copy_layer(layer, tree, pick, where)
    return model
