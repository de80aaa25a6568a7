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

from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import DenseLM, EncoderLM


def to_torch(arr) -> torch.Tensor:
    """A CPU tensor with the same bits as the numpy array ``arr``."""
    arr = np.ascontiguousarray(arr)
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


@torch.no_grad()
def load_reference_params(model, params: Mapping):
    """Copy a reference parameter tree into a ``DenseLM``, ``RWKVLM`` or
    ``EncoderLM``.

    ``params`` is the tree of ``build_model(cfg).init(key)`` with numpy
    leaves.  The stacked layer leaves are split along their leading ``L``:
    a layer's own tensors (``ln1``, ``ln2``) and its groups of tensors
    (``attn``/``mlp`` or ``tm``/``cm``) take the reference's names; an MoE
    model's ``mlp`` group is its router and (E, ...) experts.  Values are
    cast to each weight's dtype (the model's, or f32 for the rwkv ``w0``
    and ``u`` and the MoE ``router``); with equal dtypes the copy is
    bit-exact.
    """
    if not isinstance(model, (DenseLM, RWKVLM, EncoderLM)):
        raise TypeError(f"no bridge for {type(model).__name__}")
    lm_head = getattr(model, "lm_head", None)  # an encoder has none
    top = {"embed", "layers", "final_norm"}
    if lm_head is not None:
        top.add("lm_head")
    _check_keys(params, top, "params")
    _copy(model.embed, params["embed"], "embed")
    _copy(model.final_norm, params["final_norm"], "final_norm")
    if lm_head is not None:
        _copy(lm_head, params["lm_head"], "lm_head")
    stack = params["layers"]
    first = model.layers[0]
    tensors = [name for name, _ in first.named_parameters(recurse=False)]
    groups = [name for name, _ in first.named_children()]
    _check_keys(stack, tensors + groups, "layers")
    n_layers = len(model.layers)
    for name in tensors:
        if np.shape(stack[name])[0] != n_layers:
            raise ValueError(f"layers.{name}: {np.shape(stack[name])[0]} "
                             f"layers, model has {n_layers}")
    for i, layer in enumerate(model.layers):
        for name in tensors:
            _copy(getattr(layer, name), stack[name][i], f"layers.{name}[{i}]")
        for group in groups:
            mine = getattr(layer, group)
            _check_keys(stack[group], mine.keys(), f"layers.{group}")
            for key, leaf in stack[group].items():
                _copy(mine[key], leaf[i], f"layers.{group}.{key}[{i}]")
    return model
