"""Checkpoints of a model's weights and its AdamW state for
fault-tolerant training, the reference's ``training/checkpoint.py`` in
PyTorch.

The on-disk layout and the crash rules are the reference's: one
``step_{step:08d}/shard_{writer}.npz`` per writer, written to a temporary
file that is renamed into place, then ``manifest.json`` written as
``manifest.json.tmp`` and renamed, which is the commit point;
``latest_step`` counts only directories with a manifest, so a crashed
run restarts from the last durable step.  bf16 is stored as f32, which is
lossless.

Unlike the reference, which stores its pytree's leaves in flatten order
and checks only their count, the shard keys every tensor by name
(``param/<name>``, ``m/<name>``, ``v/<name>`` and ``step``), the manifest
lists each key's shape and dtype, and a restore refuses any missing,
extra or mis-shaped name.  A restore writes into the model's own
parameters and the state's own moments in place (``make_train_step``
holds the parameter objects), each keeping its dtype.

A model sharded by ``distributed.sharding.shard_model`` (DTensor weights,
ZeRO-1 moments) checkpoints as the reference's ``np.asarray`` of a
sharded ``jax.Array`` does: every rank gathers each tensor to its full
shape (``full_tensor()``, a collective), and rank 0 alone writes
``shard_0.npz`` and the manifest (``writers: 1``) while the others wait at
a barrier for the commit point.  Each tensor goes out at the unsharded
model's shape (hymba's ``w_in``, sharded as its (d, 2, h) view, as its
(d, 2h)), so the file is an unsharded run's, key for key.  A restore reads
the whole file on every rank and writes each DTensor's own slice (by the
placements ``shard_model`` and ``zero_moment`` gave it) into its local
shard in place.  Either kind of run reads either kind of file.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import PAIRED_HALVES, model_mesh
from repro_torch.training.optimizer import AdamWState


def _tensors(model: nn.Module, opt_state: AdamWState) -> Dict[str, torch.Tensor]:
    """Every tensor a checkpoint holds, by its key."""
    out = {f"param/{n}": p for n, p in model.named_parameters()}
    out.update({f"m/{n}": t for n, t in opt_state.m.items()})
    out.update({f"v/{n}": t for n, t in opt_state.v.items()})
    out["step"] = opt_state.step
    return out


def _file_shape(key: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of ``t`` in a checkpoint: the unsharded model's (a
    paired-halves weight's (d, 2, h) view, and its moments', as (d, 2h))."""
    shape = tuple(t.shape)
    if key.endswith(PAIRED_HALVES) and len(shape) == 3:
        return (shape[0], shape[1] * shape[2])
    return shape


def _own_slice(full: torch.Tensor, t: DTensor) -> torch.Tensor:
    """This rank's part of ``full`` (at ``t``'s global shape) under
    ``t``'s placements, cut mesh dim by mesh dim as ``shard_model`` cuts a
    weight (a dim sharded over two mesh dims takes the outer one first)."""
    mesh = t.device_mesh
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            size = full.shape[pl.dim] // mesh.size(i)
            full = full.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return full


def save_checkpoint(ckpt_dir: str, step: int, model: nn.Module,
                    opt_state: AdamWState, extra: Optional[Dict] = None,
                    writer: int = 0) -> str:
    """Write ``step_{step}`` under ``ckpt_dir``: the model's weights and
    ``opt_state`` by key, then the manifest, the commit point.  A sharded
    model's tensors are gathered on every rank (call it on all of them)
    and written by rank 0, which the others wait for."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    sharded = model_mesh(model) is not None
    writes = not sharded or dist.get_rank() == 0
    if writes:
        d.mkdir(parents=True, exist_ok=True)
    tensors = _tensors(model, opt_state)

    def to_np(key: str, t: torch.Tensor) -> np.ndarray:
        if isinstance(t, DTensor):  # a collective: every rank gathers
            t = t.full_tensor().reshape(_file_shape(key, t))
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz can't serialize bf16; f32 is lossless
            t = t.float()
        return t.numpy()

    # one tensor gathered at a time; the ranks that do not write drop it
    arrays = {}
    for key, t in tensors.items():
        a = to_np(key, t)
        if writes:
            arrays[key] = a
    if not writes:
        dist.barrier()  # until rank 0 has committed
        return str(d)
    shard_path = d / f"shard_{writer}.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, shard_path)
    manifest = {
        "step": step,
        "leaves": {key: {"shape": list(_file_shape(key, t)),
                         "dtype": str(t.dtype).removeprefix("torch.")}
                   for key, t in tensors.items()},
        "num_leaves": len(tensors),
        "extra": extra or {},
        "writers": 1,
    }
    mtmp = d / "manifest.json.tmp"
    mtmp.write_text(json.dumps(manifest))
    os.replace(mtmp, d / "manifest.json")  # commit point
    if sharded:
        dist.barrier()
    return str(d)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = []
    for d in p.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, model: nn.Module, opt_state: AdamWState,
                       step: Optional[int] = None
                       ) -> Tuple[AdamWState, int, Dict]:
    """Restore the checkpoint at ``step`` (the latest where None) into
    ``model``'s parameters and ``opt_state``'s moments, in place; returns
    (the state with the restored AdamW step, an int32 tensor on the
    weights' device, the checkpoint's step, its ``extra``).  A DTensor
    takes its own slice of the whole tensor in the file."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    tensors = _tensors(model, opt_state)
    with np.load(d / "shard_0.npz") as data:
        missing = sorted(set(tensors) - set(data.files))
        extra = sorted(set(data.files) - set(tensors))
        if missing or extra:
            raise ValueError(f"checkpoint {d} does not match the model: "
                             f"missing {missing[:5]}, extra {extra[:5]}")
        for key, t in tensors.items():
            if key == "step":
                continue
            a = data[key]
            if tuple(a.shape) != _file_shape(key, t):
                raise ValueError(f"checkpoint {d}: {key} has shape {a.shape}, "
                                 f"the model's is {_file_shape(key, t)}")
            full = torch.from_numpy(a)
            if isinstance(t, DTensor):
                t.to_local().copy_(_own_slice(full.reshape(t.shape), t))
            else:
                t.copy_(full)
        device = next(model.parameters()).device
        restored = torch.as_tensor(data["step"], dtype=torch.int32, device=device)
    return (AdamWState(step=restored, m=opt_state.m, v=opt_state.v), step,
            manifest["extra"])


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    p = Path(ckpt_dir)
    if not p.exists():
        return
    steps = sorted(d for d in p.iterdir() if d.name.startswith("step_"))
    for d in steps[:-keep]:
        for f in d.iterdir():
            f.unlink()
        d.rmdir()
