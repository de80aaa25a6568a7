"""The train step: microbatched loss and gradients, then AdamW; the
reference's ``training/train_loop.py`` in PyTorch."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.compression import compress_one, init_error
from repro_torch.distributed.sharding import (data_mean, data_rows,
                                              model_mesh, reduce_gradients)
from repro_torch.models.transformer import make_microbatched_loss
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            apply_updates)


def make_train_step(model: nn.Module, opt_cfg: AdamWConfig = AdamWConfig(),
                    num_microbatches: int = 1, compress: bool = False) -> Callable:
    """(opt_state, batch) -> (opt_state, {"loss", "step"}) for a model with
    ``forward_loss`` (every family: ``DenseLM``, ``EncoderLM``, ``RWKVLM``,
    ``HymbaLM``, ``VisionLM``, ``EncDecLM``), whose weights it updates in
    place.  It turns the model's gradients on once, the VLM's f32 gates
    too.  Each call zeroes the gradients, runs the ``num_microbatches``
    microbatches of ``batch`` (``tokens`` and ``labels``, (B, S) arrays or
    tensors, and the model's ``extra_inputs``, which reach the device in
    the weights' dtype) and applies the update; the loss is the batch's
    mean, detached, and the step the optimiser's count after the
    update.

    With ``compress``, the gradients go through int8 compression with
    error feedback before the update, as the reference's launcher does
    (``distributed.compression``, one weight at a time); the f32 error
    lives in this closure from zeros, and no checkpoint holds it.

    A model sharded by ``distributed.sharding.shard_model`` takes the same
    batch on every rank: each data rank runs its own rows, the gradients
    are averaged over ``data`` (and a replicated KV projection's summed
    over ``model``) before the update, and the loss is the mean over the
    data ranks."""
    mesh = model_mesh(model)
    if compress and mesh is not None:
        raise NotImplementedError("int8 compression of a sharded model's "
                                  "gradients is not ported")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss_fn = make_microbatched_loss(model.forward_loss, num_microbatches)
    error = init_error(params) if compress else None

    def to_device(a) -> torch.Tensor:
        t = torch.as_tensor(a, device=model.device)
        return t.to(model.dtype) if t.is_floating_point() else t

    def train_step(opt_state: AdamWState, batch: Dict[str, np.ndarray]):
        for p in params.values():
            p.grad = None
        tensors = {name: to_device(a) for name, a in batch.items()}
        if mesh is not None:
            tensors = {name: data_rows(t, mesh) for name, t in tensors.items()}
        loss = loss_fn(tensors)
        if mesh is not None:
            reduce_gradients(params.values())
            loss = data_mean(loss, mesh)
        if error is not None:
            with torch.no_grad():
                for n, p in params.items():
                    p.grad, error[n] = compress_one(p.grad, error[n])
        opt_state = apply_updates(params, {n: p.grad for n, p in params.items()},
                                  opt_state, opt_cfg)
        return opt_state, {"loss": loss, "step": opt_state.step}

    return train_step
